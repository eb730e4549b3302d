"""Decoder/encoder blocks for all assigned families (a port of
``repro.models.blocks``). A block is (init spec, forward, decode) over one
layer's params mapping. Families:

  dense   pre-norm attn + gated MLP           (mistral/gemma/starcoder/qwen/
                                               pixtral backbone)
  moe     pre-norm attn (or MLA) + MoE         (granite, deepseek)
  ssm     mamba2 mixer only                    (mamba2-130m; d_ff = 0)
  hybrid  parallel attn + ssm heads, then MLP  (hymba)
  enc     bidirectional attn + MLP             (whisper encoder)
  xdec    causal self-attn + cross-attn + MLP  (whisper decoder)

The decode functions update the layer's cache in place: ``cache`` maps
names to views of the model's stacked cache, so writing through them
updates the stack.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import attention as A
from repro_torch.models.layers import mla as MLA
from repro_torch.models.layers import ssm as S
from repro_torch.models.layers.basic import const, rms_norm
from repro_torch.models.layers.mlp import init_mlp, mlp
from repro_torch.models.layers.moe import init_moe, moe


def _attn_kwargs(cfg: ArchConfig) -> Dict[str, Any]:
    return dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
                qk_norm=cfg.qk_norm, sliding_window=cfg.sliding_window)


def _mla_kwargs(cfg: ArchConfig) -> Dict[str, Any]:
    return dict(n_heads=cfg.n_heads, q_lora=cfg.q_lora_rank,
                kv_lora=cfg.kv_lora_rank, rope_d=cfg.qk_rope_dim,
                nope_d=cfg.qk_nope_dim, v_d=cfg.v_head_dim)


def _ssm_kwargs(cfg: ArchConfig) -> Dict[str, Any]:
    return dict(d_inner=cfg.d_inner, d_state=cfg.ssm_state,
                head_p=cfg.ssm_head_p)


# ------------------------------------------------------------------ init --

def init_block(cfg: ArchConfig, kind: str):
    d = cfg.d_model
    p: Dict[str, Any] = {"ln1": const((d,), 1.0)}
    if kind == "ssm":
        p["ssm"] = S.init_ssm(d, cfg.d_inner, cfg.ssm_state, cfg.ssm_head_p)
        return p
    if kind == "hybrid":
        p["attn"] = A.init_attention(d, cfg.n_heads, cfg.n_kv_heads,
                                     cfg.resolved_head_dim, cfg.qk_norm)
        p["ssm"] = S.init_ssm(d, cfg.d_inner, cfg.ssm_state, cfg.ssm_head_p)
    elif cfg.mla and kind in ("dense", "moe"):
        p["attn"] = MLA.init_mla(d, **_mla_kwargs(cfg))
    else:
        p["attn"] = A.init_attention(d, cfg.n_heads, cfg.n_kv_heads,
                                     cfg.resolved_head_dim, cfg.qk_norm)
    p["ln2"] = const((d,), 1.0)
    if kind == "moe":
        p["moe"] = init_moe(d, cfg.n_experts, cfg.d_ff, cfg.n_shared_experts,
                            cfg.d_ff)
    else:
        p["mlp"] = init_mlp(d, cfg.d_ff, gated=True)
    return p


def init_enc_block(cfg: ArchConfig):
    d = cfg.d_model
    return {
        "ln1": const((d,), 1.0),
        "attn": A.init_attention(d, cfg.n_heads, cfg.n_kv_heads,
                                 cfg.resolved_head_dim),
        "ln2": const((d,), 1.0),
        "mlp": init_mlp(d, cfg.d_ff, gated=False),
    }


def init_xdec_block(cfg: ArchConfig):
    d = cfg.d_model
    return {
        "ln1": const((d,), 1.0),
        "attn": A.init_attention(d, cfg.n_heads, cfg.n_kv_heads,
                                 cfg.resolved_head_dim),
        "lnx": const((d,), 1.0),
        "xattn": A.init_cross_attention(d, cfg.n_heads,
                                        cfg.resolved_head_dim),
        "ln2": const((d,), 1.0),
        "mlp": init_mlp(d, cfg.d_ff, gated=False),
    }


# --------------------------------------------------------------- forward --

def _ring_seed(k, v, w: int):
    """The hybrid ring buffer's seed from a prefill's (B, S, KVH, D) keys
    and values: slot(p) = p % W (see ``attn_decode_ring``)."""
    s_len = k.shape[1]
    if s_len >= w:
        shift = (s_len - w) % w
        rk = torch.roll(k[:, -w:], shift, dims=1)
        rv = torch.roll(v[:, -w:], shift, dims=1)
        rpos = torch.roll(torch.arange(s_len - w, s_len, dtype=torch.int32,
                                       device=k.device), shift)
    else:
        pad = w - s_len
        rk = F.pad(k, (0, 0, 0, 0, 0, pad))
        rv = F.pad(v, (0, 0, 0, 0, 0, pad))
        rpos = F.pad(torch.arange(s_len, dtype=torch.int32, device=k.device),
                     (0, pad), value=-1)
    return rk, rv, rpos


def block_forward(p, x, positions, cfg: ArchConfig, kind: str,
                  causal: bool = True, sh=None, rows=None,
                  keep_cache=True):
    """Full-sequence pass. Returns (x, cache, aux) where cache is the
    layer's decode state seed (whole on every rank) and aux = (lb_loss,
    z_loss) zeros if non-moe. ``sh``: this rank on a "model" axis;
    ``rows``: the ranks the batch's rows are split over (``Rows``), over
    which the MoE aux losses are the global batch's. ``keep_cache=False``
    (training) spares the gathers that only the decode cache needs, and
    the cache it returns is not one."""
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    zero_aux = (zero, zero)
    h = rms_norm(p["ln1"], x)
    if kind in ("ssm", "hybrid"):
        s_out, (ssm_state, conv_state) = S.ssm_forward(
            p["ssm"], h, sh=sh, whole_state=keep_cache, **_ssm_kwargs(cfg))
        cache = {"ssm": ssm_state, "conv": conv_state}
    if kind == "ssm":
        return x + s_out, cache, zero_aux
    if kind == "hybrid":
        a_out, (k, v) = A.attn_forward(p["attn"], h, positions,
                                       causal=causal, sh=sh,
                                       whole_kv=keep_cache,
                                       **_attn_kwargs(cfg))
        x = x + 0.5 * (a_out + s_out)
        if keep_cache:
            rk, rv, rpos = _ring_seed(k, v, cfg.sliding_window)
            cache.update(k=rk, v=rv, pos=rpos)
    elif cfg.mla:
        a_out, (c_kv, k_rope) = MLA.mla_forward(p["attn"], h, positions,
                                                sh=sh, **_mla_kwargs(cfg))
        x = x + a_out
        cache = {"c_kv": c_kv, "k_rope": k_rope}
    else:
        a_out, (k, v) = A.attn_forward(p["attn"], h, positions,
                                       causal=causal, sh=sh,
                                       whole_kv=keep_cache,
                                       **_attn_kwargs(cfg))
        x = x + a_out
        cache = {"k": k, "v": v}
    h2 = rms_norm(p["ln2"], x)
    if kind == "moe":
        m_out, aux = moe(p["moe"], h2, n_experts=cfg.n_experts,
                         top_k=cfg.experts_per_token, act=cfg.mlp_act,
                         dispatch=cfg.moe_dispatch, sh=sh, rows=rows)
        return x + m_out, cache, aux
    return x + mlp(p["mlp"], h2, act=cfg.mlp_act, sh=sh), cache, zero_aux


def block_decode(p, x1, cache, pos, cfg: ArchConfig, kind: str, sh=None):
    """One-token decode. Updates ``cache`` in place; returns (x1, cache).
    ``sh``: this rank on a "model" axis, ``sh.seq`` saying whether the
    cache's sequence (the ring's slots, the latents) is split over it."""
    h = rms_norm(p["ln1"], x1)
    if kind in ("ssm", "hybrid"):
        s_out, ssm_state, conv_state = S.ssm_decode(
            p["ssm"], h, cache["ssm"], cache["conv"], sh=sh,
            **_ssm_kwargs(cfg))
        cache["ssm"].copy_(ssm_state)
        cache["conv"].copy_(conv_state)
    if kind == "ssm":
        return x1 + s_out, cache
    if kind == "hybrid":
        a_out, _, _, _ = A.attn_decode_ring(
            p["attn"], h, cache["k"], cache["v"], cache["pos"], pos, sh=sh,
            **_attn_kwargs(cfg))
        x1 = x1 + 0.5 * (a_out + s_out)
    elif cfg.mla:
        a_out, _, _ = MLA.mla_decode(p["attn"], h, cache["c_kv"],
                                     cache["k_rope"], pos, sh=sh,
                                     **_mla_kwargs(cfg))
        x1 = x1 + a_out
    else:
        a_out, _, _ = A.attn_decode(p["attn"], h, cache["k"], cache["v"],
                                    pos, sh=sh, **_attn_kwargs(cfg))
        x1 = x1 + a_out
    h2 = rms_norm(p["ln2"], x1)
    if kind == "moe":
        m_out, _ = moe(p["moe"], h2, n_experts=cfg.n_experts,
                       top_k=cfg.experts_per_token, act=cfg.mlp_act,
                       dispatch=cfg.moe_dispatch, sh=sh)
        return x1 + m_out, cache
    return x1 + mlp(p["mlp"], h2, act=cfg.mlp_act, sh=sh), cache


def _xattn_kwargs(cfg: ArchConfig) -> Dict[str, Any]:
    return dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta)


def enc_block_forward(p, x, positions, cfg: ArchConfig, sh=None):
    h = rms_norm(p["ln1"], x)
    out, _ = A.attn_forward(p["attn"], h, positions, causal=False, sh=sh,
                            whole_kv=False, **_xattn_kwargs(cfg))
    x = x + out
    return x + mlp(p["mlp"], rms_norm(p["ln2"], x), act=cfg.mlp_act, sh=sh)


def xdec_block_forward(p, x, positions, enc_k, enc_v, cfg: ArchConfig,
                       sh=None, keep_cache=True):
    """Whisper decoder full-seq pass; returns (x, self_cache). ``enc_k``,
    ``enc_v``: ``cross_kv``'s (on a "model" axis, the rank's heads when it
    computes its own)."""
    h = rms_norm(p["ln1"], x)
    a_out, (k, v) = A.attn_forward(p["attn"], h, positions, causal=True,
                                   sh=sh, whole_kv=keep_cache,
                                   **_xattn_kwargs(cfg))
    x = x + a_out
    x = x + A.cross_attn(p["xattn"], rms_norm(p["lnx"], x), enc_k, enc_v,
                         n_heads=cfg.n_heads, head_dim=cfg.resolved_head_dim,
                         sh=sh)
    return x + mlp(p["mlp"], rms_norm(p["ln2"], x), act=cfg.mlp_act,
                   sh=sh), {"k": k, "v": v}


def xdec_block_decode(p, x1, cache, enc_k, enc_v, pos, cfg: ArchConfig,
                      sh=None, xsh=None):
    """Whisper decoder one-token step; updates ``cache`` in place. ``sh``
    and ``xsh``: this rank on a "model" axis for the self-attention cache
    and for the cross caches (whose encoder sequence may be split apart
    from it)."""
    h = rms_norm(p["ln1"], x1)
    a_out, _, _ = A.attn_decode(p["attn"], h, cache["k"], cache["v"], pos,
                                sh=sh, **_xattn_kwargs(cfg))
    x1 = x1 + a_out
    x1 = x1 + A.cross_decode(p["xattn"], rms_norm(p["lnx"], x1), enc_k,
                             enc_v, n_heads=cfg.n_heads,
                             head_dim=cfg.resolved_head_dim, sh=xsh)
    x1 = x1 + mlp(p["mlp"], rms_norm(p["ln2"], x1), act=cfg.mlp_act, sh=sh)
    return x1, cache
