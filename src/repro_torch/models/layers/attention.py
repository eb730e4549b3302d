"""Attention: GQA/MQA/MHA + RoPE + optional qk-norm + sliding window +
cross-attention (a port of ``repro.models.layers.attention``):

  * ``attn_forward``  -- full-sequence (train / prefill). Above ``q_block``
    queries the queries run in blocks of ``q_block`` (exact softmax over
    the full key axis per block), so the score tensor is O(S * blk).
  * ``attn_decode``   -- one new token against a (B, S, KVH, D) KV cache,
    written in place at ``pos``.
  * ``attn_decode_ring`` -- the same over a sliding-window ring buffer.
  * ``cross_attn``    -- decoder-over-encoder (whisper), no mask, static KV.

``pos`` may be a Python int or a 0-d integer tensor on the model's device;
a tensor keeps the decode loop free of host reads. Caches are written in
place (the reference returns updated copies); the functions also return
them, as the reference does.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.layers.basic import apply_rope, const, dense, rms_norm

NEG = -1.0e30


def init_attention(d_model: int, n_heads: int, n_kv_heads: int,
                   head_dim: int, qk_norm: bool = False):
    p = {
        "wq": dense((d_model, n_heads * head_dim)),
        "wk": dense((d_model, n_kv_heads * head_dim)),
        "wv": dense((d_model, n_kv_heads * head_dim)),
        "wo": dense((n_heads * head_dim, d_model)),
    }
    if qk_norm:
        p["q_norm"] = const((head_dim,), 1.0)
        p["k_norm"] = const((head_dim,), 1.0)
    return p


def scale_of(d: int) -> float:
    """1/sqrt(d) rounded as the reference's float32 arithmetic rounds it."""
    return float(np.float32(1.0) / np.sqrt(np.float32(d)))


def as_pos(pos, device) -> torch.Tensor:
    """``pos`` as a 0-d int64 tensor on ``device`` (no copy if it is one)."""
    return torch.as_tensor(pos, device=device).to(torch.int64).reshape(())


def _project_qkv(p, x, n_heads, n_kv_heads, head_dim, positions, rope_theta,
                 qk_norm):
    b, s, _ = x.shape
    q = (x @ p["wq"].to(x.dtype)).reshape(b, s, n_heads, head_dim)
    k = (x @ p["wk"].to(x.dtype)).reshape(b, s, n_kv_heads, head_dim)
    v = (x @ p["wv"].to(x.dtype)).reshape(b, s, n_kv_heads, head_dim)
    if qk_norm:
        q = rms_norm(p["q_norm"], q)
        k = rms_norm(p["k_norm"], k)
    if rope_theta > 0:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    return q, k, v


def _gqa_scores_block(qb, k, scale):
    """qb: (B, Sq, KVH, G, D); k: (B, Sk, KVH, D) -> (B, KVH, G, Sq, Sk)."""
    return torch.einsum("bqhgd,bshd->bhgqs", qb.float(), k.float()) * scale


def _attend_block(qb, k, v, mask, scale):
    s = _gqa_scores_block(qb, k, scale)
    if mask is not None:
        s = torch.where(mask, s, NEG)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhgqs,bshd->bqhgd", w.to(v.dtype), v)


def _mask(qpos, kpos, causal, sliding_window):
    """(B, 1, 1, Sq, Sk) bool from (B, Sq) and (B, Sk) positions."""
    q = qpos[:, None, None, :, None]
    k = kpos[:, None, None, None, :]
    mask = torch.ones((qpos.shape[0], 1, 1, qpos.shape[1], kpos.shape[1]),
                      dtype=torch.bool, device=qpos.device)
    if causal:
        mask = mask & (q >= k)
    if sliding_window > 0:
        mask = mask & (q - sliding_window < k)
    return mask


def attn_forward(p, x, positions, *, n_heads, n_kv_heads, head_dim,
                 rope_theta=1e4, qk_norm=False, causal=True,
                 sliding_window=0, q_block=512):
    """Full-sequence attention; returns (out (B,S,d_model-ish), (k, v))."""
    b, s, _ = x.shape
    g = n_heads // n_kv_heads
    q, k, v = _project_qkv(p, x, n_heads, n_kv_heads, head_dim, positions,
                           rope_theta, qk_norm)
    scale = scale_of(head_dim)
    qg = q.reshape(b, s, n_kv_heads, g, head_dim)
    kpos = positions.expand(b, s) if positions.dim() == 1 else positions

    if s <= q_block:
        out = _attend_block(qg, k, v, _mask(kpos, kpos, causal,
                                            sliding_window), scale)
    else:
        assert s % q_block == 0, (s, q_block)
        out = torch.cat([
            _attend_block(qg[:, i:i + q_block], k, v,
                          _mask(kpos[:, i:i + q_block], kpos, causal,
                                sliding_window), scale)
            for i in range(0, s, q_block)], dim=1)

    out = out.reshape(b, s, n_heads * head_dim)
    return out @ p["wo"].to(x.dtype), (k, v)


def attn_decode(p, x1, cache_k, cache_v, pos, *, n_heads, n_kv_heads,
                head_dim, rope_theta=1e4, qk_norm=False, sliding_window=0):
    """One-token decode. x1: (B, 1, d); cache: (B, S, KVH, D); pos: () int.

    Writes the new key and value into the caches at ``pos`` and returns
    (out (B,1,d_model), cache_k, cache_v)."""
    b = x1.shape[0]
    s_cache = cache_k.shape[1]
    g = n_heads // n_kv_heads
    pos = as_pos(pos, x1.device)
    positions = pos.reshape(1, 1).expand(b, 1)
    q, k, v = _project_qkv(p, x1, n_heads, n_kv_heads, head_dim, positions,
                           rope_theta, qk_norm)
    at = pos.reshape(1)
    cache_k.index_copy_(1, at, k.to(cache_k.dtype))
    cache_v.index_copy_(1, at, v.to(cache_v.dtype))
    kpos = torch.arange(s_cache, device=x1.device)
    valid = kpos <= pos
    if sliding_window > 0:
        valid = valid & (kpos > pos - sliding_window)
    mask = valid[None, None, None, None, :]
    qg = q.reshape(b, 1, n_kv_heads, g, head_dim)
    out = _attend_block(qg, cache_k, cache_v, mask, scale_of(head_dim))
    out = out.reshape(b, 1, n_heads * head_dim)
    return out @ p["wo"].to(x1.dtype), cache_k, cache_v


def attn_decode_ring(p, x1, cache_k, cache_v, cache_pos, pos, *, n_heads,
                     n_kv_heads, head_dim, rope_theta=1e4, qk_norm=False,
                     sliding_window=0):
    """Sliding-window decode with a ring-buffer cache of width W.

    cache_k/v: (B, W, KVH, D) with RoPE already applied at write time;
    cache_pos: (W,) absolute positions (-1 = empty). The new token writes at
    slot ``pos % W`` so cache memory is O(W) however long the stream."""
    b = x1.shape[0]
    w = cache_k.shape[1]
    g = n_heads // n_kv_heads
    pos = as_pos(pos, x1.device)
    positions = pos.reshape(1, 1).expand(b, 1)
    q, k, v = _project_qkv(p, x1, n_heads, n_kv_heads, head_dim, positions,
                           rope_theta, qk_norm)
    slot = torch.remainder(pos, w).reshape(1)
    cache_k.index_copy_(1, slot, k.to(cache_k.dtype))
    cache_v.index_copy_(1, slot, v.to(cache_v.dtype))
    cache_pos.index_copy_(0, slot, pos.reshape(1).to(cache_pos.dtype))
    valid = (cache_pos >= 0) & (cache_pos <= pos)
    if sliding_window > 0:
        valid = valid & (cache_pos > pos - sliding_window)
    mask = valid[None, None, None, None, :]
    qg = q.reshape(b, 1, n_kv_heads, g, head_dim)
    out = _attend_block(qg, cache_k, cache_v, mask, scale_of(head_dim))
    out = out.reshape(b, 1, n_heads * head_dim)
    return out @ p["wo"].to(x1.dtype), cache_k, cache_v, cache_pos


def init_cross_attention(d_model: int, n_heads: int, head_dim: int):
    return init_attention(d_model, n_heads, n_heads, head_dim)


def cross_attn(p, x, enc_k, enc_v, *, n_heads, head_dim):
    """x: (B, Sq, d); enc_k/enc_v: (B, Se, H, D) precomputed. No mask/RoPE."""
    b, sq, _ = x.shape
    q = (x @ p["wq"].to(x.dtype)).reshape(b, sq, n_heads, head_dim)
    qg = q.reshape(b, sq, n_heads, 1, head_dim)
    out = _attend_block(qg, enc_k, enc_v, None, scale_of(head_dim))
    out = out.reshape(b, sq, n_heads * head_dim)
    return out @ p["wo"].to(x.dtype)


def cross_kv(p, enc_out, *, n_heads, head_dim):
    b, se, _ = enc_out.shape
    k = (enc_out @ p["wk"].to(enc_out.dtype)).reshape(b, se, n_heads,
                                                      head_dim)
    v = (enc_out @ p["wv"].to(enc_out.dtype)).reshape(b, se, n_heads,
                                                      head_dim)
    return k, v
