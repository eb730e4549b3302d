"""Norms, activations, RoPE, embeddings -- shared primitives.

A port of ``repro.models.layers.basic``. Layer functions take
``(params, inputs, ...)`` where ``params`` is a mapping of tensors (a
``ParamTree`` of the model, or a plain dict in tests) laid out as the
reference's pytree: matmul weights are (in, out) and multiply as
``x @ w``. Initializers return ``{name: Leaf}`` specs that say each
parameter's shape and how it starts; the model allocates and fills them.

Dtype policy, as the reference computes: activations run in the config's
dtype, every weight is cast to it at use (``w.to(x.dtype)``, a no-op when
stored so), and norms, RoPE, attention scores and the unembedding run in
float32.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class Leaf:
    """One parameter's shape and start: drawn N(0, scale^2) by
    ``dense_init`` when ``scale`` is set, otherwise filled with ``fill``."""
    shape: Tuple[int, ...]
    scale: Optional[float] = None
    fill: float = 0.0


def dense(shape, scale: float | None = None) -> Leaf:
    """The spec of ``dense_init(gen, shape, scale)``."""
    fan_in = shape[0] if len(shape) >= 2 else shape[-1]
    return Leaf(tuple(shape), float(scale if scale is not None
                                    else 1.0 / np.sqrt(fan_in)))


def const(shape, value: float) -> Leaf:
    return Leaf(tuple(shape), None, float(value))


def rms_norm(w: torch.Tensor, x: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * w.float()).to(dt)


def layer_norm(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, unbiased=False, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(dt)


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh form; torch's default is the erf form
    return F.gelu(x, approximate="tanh")


def act_fn(name: str):
    return {"silu": F.silu, "gelu": _gelu_tanh, "gelu_tanh": _gelu_tanh,
            "relu": F.relu}[name]


def dense_init(generator: torch.Generator, shape,
               scale: float | None = None) -> torch.Tensor:
    """N(0, scale^2) float32 draws on the generator's device; ``scale``
    defaults to 1/sqrt(fan_in) as in the reference."""
    return torch.randn(tuple(shape), generator=generator,
                       device=generator.device,
                       dtype=torch.float32) * dense(shape, scale).scale


# ---------------------------------------------------------------- RoPE ----

def rope_frequencies(head_dim: int, theta: float, device) -> torch.Tensor:
    """The reference's float64 frequencies as float32, computed on
    ``device``: a host-to-device copy would synchronize every decode
    step."""
    ar = torch.arange(0, head_dim, 2, dtype=torch.float64, device=device)
    return (1.0 / (theta ** (ar / head_dim))).float()


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs              # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]                      # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------- embeddings ---

def init_embedding(vocab: int, d_model: int):
    # 0.02 std (GPT-2 convention) keeps tied-unembedding logits sane at init.
    return {"table": dense((vocab, d_model), scale=0.02)}


def embed(params, tokens: torch.Tensor, dtype, sh=None) -> torch.Tensor:
    """Rows of the table. On a "model" axis (``sh``): a vocab-split table
    looks up the rank's rows, zeros elsewhere, and the ranks' lookups are
    summed (exact: one rank holds each row); a ``d``-split table's columns
    are gathered."""
    table = params["table"]
    if sh is not None and sh.split(params, "table", 0):
        rows = sh.block(table.shape[0] * sh.mp)
        local = tokens - rows.start
        held = (local >= 0) & (local < table.shape[0])
        x = table[local.clamp(0, table.shape[0] - 1)].to(dtype)
        return sh.sum(torch.where(held[..., None], x, x.new_zeros(())))
    x = table[tokens].to(dtype)
    if sh is not None and sh.split(params, "table", 1):
        x = sh.gather(x, -1)
    return x


def unembed(params, x: torch.Tensor, sh=None) -> torch.Tensor:
    """Logits in f32 (loss stability). On a "model" axis (``sh``): a
    vocab-split table's logits are gathered (exact); a ``d``-split table
    takes the rank's columns of ``x`` and the partial logits are summed.
    Either way ``x``, replicated, enters the rank's share (``sh.enter``),
    so its gradient is summed over the ranks."""
    table = params["table"]
    if sh is not None and sh.split(params, "table", 1):
        x = sh.enter(x)[..., sh.block(table.shape[1] * sh.mp)]
        return sh.sum(x.float() @ table.float().T)
    if sh is not None and sh.split(params, "table", 0):
        return sh.gather(sh.enter(x).float() @ table.float().T, -1)
    return x.float() @ table.float().T
