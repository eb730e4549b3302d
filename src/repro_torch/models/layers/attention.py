"""Attention: GQA/MQA/MHA + RoPE + optional qk-norm + sliding window +
cross-attention (a port of ``repro.models.layers.attention``):

  * ``attn_forward``  -- full-sequence (train / prefill). Above ``q_block``
    queries the queries run in blocks of ``q_block`` (exact softmax over
    the full key axis per block), so the score tensor is O(S * blk).
  * ``attn_decode``   -- one new token against a (B, S, KVH, D) KV cache,
    written in place at ``pos``.
  * ``attn_decode_ring`` -- the same over a sliding-window ring buffer.
  * ``cross_attn``    -- decoder-over-encoder (whisper), no mask, static KV.

On a "model" axis (``sh``, ``layers.parallel``) every function runs
tensor-parallel: a rank computes its own heads when the rules' column
splits fall on head boundaries, else every head from gathered projections;
``wo`` is row-parallel; decode attends the rank's block of a
sequence-split cache (the linear cache, the ring's slots, the encoder's
keys) and combines the ranks' softmax partials in rank order
(flash-decoding).

``pos`` may be a Python int or a 0-d integer tensor on the model's device;
a tensor keeps the decode loop free of host reads. Caches are written in
place (the reference returns updated copies); the functions also return
them, as the reference does.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.layers.basic import apply_rope, const, dense, rms_norm
from repro_torch.models.layers.parallel import columns, row_parallel

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


def _heads_local(p, n_heads, n_kv_heads, sh) -> bool:
    """Whether this rank of a "model" axis computes its own heads: the
    rules split ``wq``, ``wk`` and ``wv`` by columns and the splits fall on
    head boundaries (H and KV divisible by the axis)."""
    return (sh is not None and n_heads % sh.mp == 0
            and n_kv_heads % sh.mp == 0
            and all(sh.split(p, w, 1) for w in ("wq", "wk", "wv")))


def _project_qkv(p, x, n_heads, n_kv_heads, head_dim, positions, rope_theta,
                 qk_norm, sh=None, local=False):
    """q, k, v with RoPE and qk-norm. On a "model" axis (``sh``): the
    rank's own heads when ``local``, else every head, the column-split
    projections gathered whole (one gather)."""
    b, s, _ = x.shape
    if local:
        xe = sh.enter(x)
        proj = {w: xe @ p[w].to(x.dtype) for w in ("wq", "wk", "wv")}
        n_heads, n_kv_heads = n_heads // sh.mp, n_kv_heads // sh.mp
    else:
        proj = columns(p, x, ("wq", "wk", "wv"), sh)
    q = proj["wq"].reshape(b, s, n_heads, head_dim)
    k = proj["wk"].reshape(b, s, n_kv_heads, head_dim)
    v = proj["wv"].reshape(b, s, n_kv_heads, head_dim)
    if qk_norm:
        # on the rank's own heads the replicated norm weights enter the split
        q = rms_norm(sh.enter(p["q_norm"]) if local else p["q_norm"], q)
        k = rms_norm(sh.enter(p["k_norm"]) if local else p["k_norm"], k)
    if rope_theta > 0:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    return q, k, v


def _out_proj(p, out, sh=None, local=False):
    """``out @ wo``; on a "model" axis a row-split ``wo`` takes the rank's
    own heads (``local``), or its slice of every head's flattened outputs,
    and the partial products are summed in rank order."""
    if local:
        return sh.sum(out @ p["wo"].to(out.dtype))
    return row_parallel(p, "wo", out, sh)


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
                 sliding_window=0, q_block=512, sh=None, whole_kv=True):
    """Full-sequence attention; returns (out (B,S,d_model-ish), (k, v)).

    On a "model" axis (``sh``) a rank attends with its own heads when the
    column splits fall on head boundaries, else with every head; ``wo`` is
    row-parallel. The returned k and v hold every KV head either way (the
    decode cache's layout), unless ``whole_kv`` is False (training, which
    keeps no cache): then a rank attending its own heads returns its own."""
    b, s, _ = x.shape
    g = n_heads // n_kv_heads
    local = _heads_local(p, n_heads, n_kv_heads, sh)
    q, k, v = _project_qkv(p, x, n_heads, n_kv_heads, head_dim, positions,
                           rope_theta, qk_norm, sh, local)
    scale = scale_of(head_dim)
    qg = q.reshape(b, s, k.shape[2], g, head_dim)
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

    out = _out_proj(p, out.reshape(b, s, -1), sh, local)
    if local and whole_kv:
        k, v = (t.reshape(b, s, -1, head_dim) for t in sh.gather_parts(
            [k.reshape(b, s, -1), v.reshape(b, s, -1)]))
    return out, (k, v)


def attn_decode(p, x1, cache_k, cache_v, pos, *, n_heads, n_kv_heads,
                head_dim, rope_theta=1e4, qk_norm=False, sliding_window=0,
                sh=None):
    """One-token decode. x1: (B, 1, d); cache: (B, S, KVH, D); pos: () int.

    Writes the new key and value into the caches at ``pos`` and returns
    (out (B,1,d_model), cache_k, cache_v). On a "model" axis (``sh``) see
    ``_decode_sharded``."""
    if sh is not None and sh.mp > 1:
        return _decode_sharded(p, x1, cache_k, cache_v, pos, sh,
                               n_heads=n_heads, n_kv_heads=n_kv_heads,
                               head_dim=head_dim, rope_theta=rope_theta,
                               qk_norm=qk_norm, sliding_window=sliding_window)
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


def write_held(pairs, at, start: int, n: int) -> None:
    """Write each ``(cache, new)`` of ``pairs`` at global index ``at`` (a
    0-d tensor) of dimension 1, where the cache holds the block ``[start,
    start + n)`` of it: only if ``at`` falls in the block (no host read)."""
    held = (at >= start) & (at < start + n)
    i = (at - start).clamp(0, n - 1).reshape(1)
    for cache, new in pairs:
        cache.index_copy_(1, i, torch.where(held, new.to(cache.dtype),
                                            cache.index_select(1, i)))


def combine(m, den, num, sh):
    """The softmax-weighted values over every rank's block of the keys,
    from this rank's float32 partials: its scores' max ``m`` and, scaled by
    it, the weights' sum ``den`` (both (..., 1)) and weighted values
    ``num`` (..., D). The ranks' partials are gathered and added in rank
    order, so every rank holds the same bits."""
    parts = sh.all(torch.cat([m, den, num], dim=-1))
    top = torch.stack([part[..., :1] for part in parts]).amax(dim=0)
    num = den = None
    for part in parts:                                      # rank order
        w = torch.exp(part[..., :1] - top)
        pn, pd = w * part[..., 2:], w * part[..., 1:2]
        num, den = (pn, pd) if num is None else (num + pn, den + pd)
    return num / den


def _attend_held(qg, cache_k, cache_v, valid, scale, sh):
    """One query per row, qg (B, 1, KVH, G, D), over the keys this rank
    holds (``valid`` (S_r,) masks them): the whole softmax when they are
    every key, else (``sh.seq``) combined over the ranks' blocks. Returns
    (B, 1, KVH, G, D) float32."""
    s = _gqa_scores_block(qg, cache_k, scale)
    s = torch.where(valid[None, None, None, None, :], s, NEG)
    m = s.amax(dim=-1, keepdim=True)                        # (B,KVH,G,1,1)
    e = torch.exp(s - m)
    den = e.sum(dim=-1, keepdim=True)
    num = torch.einsum("bhgqs,bshd->bhgqd", e, cache_v.float())
    out = combine(m, den, num, sh) if sh.seq else num / den
    return out.permute(0, 3, 1, 2, 4)


def _decode_sharded(p, x1, cache_k, cache_v, pos, sh, *, n_heads,
                    n_kv_heads, head_dim, rope_theta, qk_norm,
                    sliding_window):
    """One-token decode on a "model" axis. Every rank projects every head
    (the column-split projections gathered). When the cache is split along
    its sequence (``sh.seq``), the rank holds keys ``[r * S_r, (r+1) *
    S_r)``: it writes the new key and value only if ``pos`` falls in its
    block, attends every head over its block with masks on global
    positions, and keeps float32 partials (max, sum, weighted values); the
    partials are gathered and combined in rank order (flash-decoding).
    Otherwise every rank holds and attends the whole cache. The rank's
    slice of the heads then goes into the row-split ``wo``."""
    b = x1.shape[0]
    s_loc = cache_k.shape[1]
    g = n_heads // n_kv_heads
    pos = as_pos(pos, x1.device)
    positions = pos.reshape(1, 1).expand(b, 1)
    q, k, v = _project_qkv(p, x1, n_heads, n_kv_heads, head_dim, positions,
                           rope_theta, qk_norm, sh)
    start = sh.rank * s_loc if sh.seq else 0
    write_held(((cache_k, k), (cache_v, v)), pos, start, s_loc)
    kpos = start + torch.arange(s_loc, device=x1.device)
    valid = kpos <= pos
    if sliding_window > 0:
        valid = valid & (kpos > pos - sliding_window)
    qg = q.reshape(b, 1, n_kv_heads, g, head_dim)
    out = _attend_held(qg, cache_k, cache_v, valid, scale_of(head_dim), sh)
    out = _out_proj(p, out.to(x1.dtype).reshape(b, 1, n_heads * head_dim),
                    sh)
    return out, cache_k, cache_v


def attn_decode_ring(p, x1, cache_k, cache_v, cache_pos, pos, *, n_heads,
                     n_kv_heads, head_dim, rope_theta=1e4, qk_norm=False,
                     sliding_window=0, sh=None):
    """Sliding-window decode with a ring-buffer cache of width W.

    cache_k/v: (B, W, KVH, D) with RoPE already applied at write time;
    cache_pos: (W,) absolute positions (-1 = empty). The new token writes at
    slot ``pos % W`` so cache memory is O(W) however long the stream.

    On a "model" axis (``sh``) every rank projects every head; when the
    ring is split along W (``sh.seq``) the rank holds slots ``[r * W_r,
    (r+1) * W_r)``, writes the new key and value only if slot ``pos % W``
    is among them, and its float32 partials over its slots are combined in
    rank order (``cache_pos`` is whole on every rank); ``wo`` is
    row-parallel."""
    b = x1.shape[0]
    w_loc, w = cache_k.shape[1], cache_pos.shape[0]
    g = n_heads // n_kv_heads
    pos = as_pos(pos, x1.device)
    positions = pos.reshape(1, 1).expand(b, 1)
    q, k, v = _project_qkv(p, x1, n_heads, n_kv_heads, head_dim, positions,
                           rope_theta, qk_norm, sh)
    slot = torch.remainder(pos, w)
    start = sh.rank * w_loc if sh is not None and sh.seq else 0
    write_held(((cache_k, k), (cache_v, v)), slot, start, w_loc)
    cache_pos.index_copy_(0, slot.reshape(1),
                          pos.reshape(1).to(cache_pos.dtype))
    kpos = cache_pos[start:start + w_loc]
    valid = (kpos >= 0) & (kpos <= pos)
    if sliding_window > 0:
        valid = valid & (kpos > pos - sliding_window)
    qg = q.reshape(b, 1, n_kv_heads, g, head_dim)
    if sh is not None and sh.mp > 1:
        out = _attend_held(qg, cache_k, cache_v, valid, scale_of(head_dim),
                           sh).to(x1.dtype)
    else:
        out = _attend_block(qg, cache_k, cache_v,
                            valid[None, None, None, None, :],
                            scale_of(head_dim))
    out = _out_proj(p, out.reshape(b, 1, n_heads * head_dim), sh)
    return out, cache_k, cache_v, cache_pos


def init_cross_attention(d_model: int, n_heads: int, head_dim: int):
    return init_attention(d_model, n_heads, n_heads, head_dim)


def cross_attn(p, x, enc_k, enc_v, *, n_heads, head_dim, sh=None):
    """x: (B, Sq, d); enc_k/enc_v: (B, Se, H, D) precomputed. No mask/RoPE.
    On a "model" axis (``sh``) the keys and values are ``cross_kv``'s: the
    rank's own heads when the column splits fall on head boundaries, which
    it attends; else every head. ``wo`` is row-parallel."""
    b, sq, _ = x.shape
    local = _heads_local(p, n_heads, n_heads, sh)
    if local:
        q = sh.enter(x) @ p["wq"].to(x.dtype)
    else:
        q = columns(p, x, ("wq",), sh)["wq"]
    q = q.reshape(b, sq, enc_k.shape[2], head_dim)
    qg = q.reshape(b, sq, enc_k.shape[2], 1, head_dim)
    out = _attend_block(qg, enc_k, enc_v, None, scale_of(head_dim))
    return _out_proj(p, out.reshape(b, sq, -1), sh, local)


def cross_decode(p, x1, enc_k, enc_v, *, n_heads, head_dim, sh=None):
    """One decoder token over the encoder's cached keys and values. On a
    "model" axis every rank projects every head (``wq``'s split gathered)
    and attends the keys it holds: with the cache split along the encoder
    sequence (``sh.seq``) its block, the ranks' float32 partials combined
    in rank order; ``wo`` is row-parallel."""
    if sh is None or sh.mp == 1:
        return cross_attn(p, x1, enc_k, enc_v, n_heads=n_heads,
                          head_dim=head_dim)
    b = x1.shape[0]
    q = columns(p, x1, ("wq",), sh)["wq"]
    qg = q.reshape(b, 1, n_heads, 1, head_dim)
    valid = torch.ones(enc_k.shape[1], dtype=torch.bool, device=x1.device)
    out = _attend_held(qg, enc_k, enc_v, valid, scale_of(head_dim), sh)
    return _out_proj(p, out.to(x1.dtype).reshape(b, 1, n_heads * head_dim),
                     sh)


def cross_kv(p, enc_out, *, n_heads, head_dim, sh=None):
    """The encoder's keys and values (B, Se, H, D) for ``cross_attn``. On a
    "model" axis: the rank's own heads when the column splits fall on head
    boundaries (``cross_heads`` gathers them whole), else every head."""
    b, se, _ = enc_out.shape
    if _heads_local(p, n_heads, n_heads, sh):
        e = sh.enter(enc_out)
        kv = {w: e @ p[w].to(enc_out.dtype) for w in ("wk", "wv")}
    else:
        kv = columns(p, enc_out, ("wk", "wv"), sh)
    return tuple(kv[w].reshape(b, se, -1, head_dim) for w in ("wk", "wv"))


def cross_heads(p, k, v, *, n_heads, sh=None):
    """``cross_kv``'s keys and values with every head (the decode cache's
    layout): the ranks' own heads gathered when they hold them."""
    if not _heads_local(p, n_heads, n_heads, sh):
        return k, v
    b, se, _, d = k.shape
    return tuple(t.reshape(b, se, -1, d) for t in sh.gather_parts(
        [k.reshape(b, se, -1), v.reshape(b, se, -1)]))
