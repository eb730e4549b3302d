"""Gated MLPs (SwiGLU / GeGLU) and the plain enc-dec FFN (a port of
``repro.models.layers.mlp``)."""

from __future__ import annotations

from repro_torch.models.layers.basic import act_fn, dense


def init_mlp(d_model: int, d_ff: int, gated: bool = True):
    p = {"w_in": dense((d_model, d_ff)), "w_out": dense((d_ff, d_model))}
    if gated:
        p["w_gate"] = dense((d_model, d_ff))
    return p


def mlp(p, x, act: str = "silu", sh=None):
    """On a "model" axis (``sh``), ``w_in``/``w_gate`` are column-parallel
    and ``w_out`` row-parallel on the same ``d_ff`` split: the ranks'
    partial outputs are summed once; ``x`` enters the split (its gradient
    is summed over the ranks). Replicated weights compute whole."""
    if sh is not None and sh.split(p, "w_in", 1):
        x = sh.enter(x)
    h = x @ p["w_in"].to(x.dtype)
    if "w_gate" in p:
        h = act_fn(act)(x @ p["w_gate"].to(x.dtype)) * h
    else:
        h = act_fn(act)(h)
    out = h @ p["w_out"].to(x.dtype)
    if sh is not None and sh.split(p, "w_out", 0):
        out = sh.sum(out)
    return out
