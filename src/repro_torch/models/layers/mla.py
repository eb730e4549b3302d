"""Multi-head Latent Attention (DeepSeek-V2/V3, arXiv:2412.19437); a port of
``repro.models.layers.mla``.

Projections:
  q:  x -> c_q (q_lora_rank) -> per-head [q_nope (nope_d) ; q_rope (rope_d)]
  kv: x -> c_kv (kv_lora_rank)  and  x -> k_rope (rope_d, shared per head)
      c_kv -> per-head k_nope (nope_d), v (v_d)

Decode caches ONLY (c_kv, k_rope) -- the compressed latent -- and uses the
*weight absorption* identity:

  score = q_nope . (c W_uk) + q_rope . k_rope
        = (q_nope W_uk^T) . c + q_rope . k_rope
  out_h = (attn . c) W_uv          (context and W_uv in float32)

On a "model" axis (``sh``, ``layers.parallel``): the latents c_q, c_kv
and k_rope, column-split by the rules, are gathered whole (they are small)
so that ``q_norm``, ``kv_norm`` and RoPE see whole rows. When ``w_uq``,
``w_uk`` and ``w_uv`` split on head boundaries a rank computes its own
heads, and ``wo`` is row-parallel; otherwise every rank computes every
head (the split products gathered) and ``wo`` takes its block. The
absorbed decode reads a latent cache split along the sequence: the rank
absorbs its heads' queries, gathers them, scores every head over its block
of the cache and combines the ranks' float32 partials in rank order
(flash-decoding); the context then meets ``w_uv`` for the rank's heads.
"""

from __future__ import annotations

import torch

from repro_torch.models.layers.attention import (NEG, _out_proj, as_pos,
                                                 combine, scale_of,
                                                 write_held)
from repro_torch.models.layers.basic import apply_rope, const, dense, rms_norm
from repro_torch.models.layers.parallel import columns


def init_mla(d_model: int, n_heads: int, *, q_lora: int, kv_lora: int,
             rope_d: int, nope_d: int, v_d: int):
    return {
        "w_dq": dense((d_model, q_lora)),
        "q_norm": const((q_lora,), 1.0),
        "w_uq": dense((q_lora, n_heads * (nope_d + rope_d))),
        "w_dkv": dense((d_model, kv_lora)),
        "kv_norm": const((kv_lora,), 1.0),
        "w_kr": dense((d_model, rope_d)),
        "w_uk": dense((kv_lora, n_heads * nope_d)),
        "w_uv": dense((kv_lora, n_heads * v_d)),
        "wo": dense((n_heads * v_d, d_model)),
    }


def _heads_local(p, n_heads, sh) -> bool:
    """Whether this rank of a "model" axis computes its own heads: the
    rules split ``w_uq``, ``w_uk``, ``w_uv`` by columns and ``wo`` by rows,
    on head boundaries (H divisible by the axis)."""
    return (sh is not None and n_heads % sh.mp == 0
            and all(sh.split(p, w, 1) for w in ("w_uq", "w_uk", "w_uv"))
            and sh.split(p, "wo", 0))


def _latents(p, x, positions, sh):
    """(c_q, c_kv, k_rope) whole on every rank: normed, RoPE applied."""
    lat = columns(p, x, ("w_dq", "w_dkv", "w_kr"), sh)
    cq = rms_norm(p["q_norm"], lat["w_dq"])
    c_kv = rms_norm(p["kv_norm"], lat["w_dkv"])                    # (B,S,ckv)
    k_rope = apply_rope(lat["w_kr"][:, :, None, :], positions,
                        1e4)[:, :, 0]                              # (B,S,rd)
    return cq, c_kv, k_rope


def _up(p, key, c, sh, local):
    """``c @ p[key]``: the rank's heads from an entered ``c`` when
    ``local``, else every head (a split product gathered)."""
    if local:
        return sh.enter(c) @ p[key].to(c.dtype)
    return columns(p, c, (key,), sh)[key]


def _project_q(p, cq, nope_d, rope_d, positions, sh=None, local=False):
    b, s, _ = cq.shape
    q = _up(p, "w_uq", cq, sh, local).reshape(b, s, -1, nope_d + rope_d)
    q_nope, q_rope = q[..., :nope_d], q[..., nope_d:]
    q_rope = apply_rope(q_rope, positions, 1e4)
    return q_nope, q_rope


def mla_forward(p, x, positions, *, n_heads, q_lora, kv_lora, rope_d, nope_d,
                v_d, q_block=512, sh=None):
    """Full-sequence causal MLA. Returns (out, (c_kv, k_rope)) for caching
    (whole on every rank)."""
    b, s, _ = x.shape
    local = _heads_local(p, n_heads, sh)
    cq, c_kv, k_rope = _latents(p, x, positions, sh)
    q_nope, q_rope = _project_q(p, cq, nope_d, rope_d, positions, sh, local)
    h = q_nope.shape[2]
    k_nope = _up(p, "w_uk", c_kv, sh, local).reshape(b, s, h, nope_d)
    v = _up(p, "w_uv", c_kv, sh, local).reshape(b, s, h, v_d)
    kr = sh.enter(k_rope) if local else k_rope
    scale = scale_of(nope_d + rope_d)
    kpos = positions.expand(b, s) if positions.dim() == 1 else positions

    def attend(qn, qr, qpos):
        sc = (torch.einsum("bqhd,bkhd->bhqk", qn.float(), k_nope.float())
              + torch.einsum("bqhd,bkd->bhqk", qr.float(),
                             kr.float())) * scale
        mask = qpos[:, None, :, None] >= kpos[:, None, None, :]
        sc = torch.where(mask, sc, NEG)
        w = torch.softmax(sc, dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", w.to(v.dtype), v)

    if s <= q_block:
        out = attend(q_nope, q_rope, kpos)
    else:
        assert s % q_block == 0
        out = torch.cat([attend(q_nope[:, i:i + q_block],
                                q_rope[:, i:i + q_block],
                                kpos[:, i:i + q_block])
                         for i in range(0, s, q_block)], dim=1)
    out = out.reshape(b, s, h * v_d)
    return _out_proj(p, out, sh, local), (c_kv, k_rope)


def mla_decode(p, x1, cache_c, cache_kr, pos, *, n_heads, q_lora, kv_lora,
               rope_d, nope_d, v_d, sh=None):
    """Absorbed one-token decode. cache_c: (B,S,kv_lora); cache_kr: (B,S,rd),
    both written in place at ``pos``. On a "model" axis (``sh``) the caches
    are the rank's block of the sequence when ``sh.seq`` (see the module
    docstring)."""
    b = x1.shape[0]
    s_cache = cache_c.shape[1]
    pos = as_pos(pos, x1.device)
    positions = pos.reshape(1, 1).expand(b, 1)
    split = sh is not None and sh.mp > 1
    local = _heads_local(p, n_heads, sh)
    cq, c_new, kr_new = _latents(p, x1, positions, sh)
    q_nope, q_rope = _project_q(p, cq, nope_d, rope_d, positions, sh, local)
    start = sh.rank * s_cache if split and sh.seq else 0
    write_held(((cache_c, c_new), (cache_kr, kr_new)), pos, start, s_cache)
    # absorption: q_abs[h, ckv] = q_nope[h] @ W_uk[h]^T
    w_uk = p["w_uk"]
    if split and not local and sh.split(p, "w_uk", 1):
        w_uk = sh.gather(w_uk, 1)
    w_uk = w_uk.to(x1.dtype).reshape(kv_lora, q_nope.shape[2], nope_d)
    q_abs = torch.einsum("bqhd,chd->bqhc", q_nope, w_uk)        # (B,1,H,ckv)
    if local:       # the rank's heads' queries, gathered: every head
        q_abs, q_rope = (t.reshape(b, 1, n_heads, -1) for t in
                         sh.gather_parts([q_abs.reshape(b, 1, -1),
                                          q_rope.reshape(b, 1, -1)]))
    sc = (torch.einsum("bqhc,bkc->bhqk", q_abs.float(), cache_c.float())
          + torch.einsum("bqhd,bkd->bhqk", q_rope.float(),
                         cache_kr.float())) * scale_of(nope_d + rope_d)
    kpos = start + torch.arange(s_cache, device=x1.device)
    sc = torch.where((kpos <= pos)[None, None, None, :], sc, NEG)
    if split and sh.seq:
        m = sc.amax(dim=-1, keepdim=True)                       # (B,H,1,1)
        e = torch.exp(sc - m)
        ctx = combine(m, e.sum(dim=-1, keepdim=True),
                      torch.einsum("bhqk,bkc->bhqc", e, cache_c.float()),
                      sh).transpose(1, 2)                        # (B,1,H,ckv)
    else:
        w = torch.softmax(sc, dim=-1)
        ctx = torch.einsum("bhqk,bkc->bqhc", w, cache_c.float())
    w_uv = p["w_uv"]
    if local:
        ctx = ctx[:, :, sh.block(n_heads)]
    elif split and sh.split(p, "w_uv", 1):
        w_uv = sh.gather(w_uv, 1)
    w_uv = w_uv.float().reshape(kv_lora, ctx.shape[2], v_d)
    out = torch.einsum("bqhc,chd->bqhd", ctx, w_uv).to(x1.dtype)
    out = out.reshape(b, 1, -1)
    return _out_proj(p, out, sh, local), cache_c, cache_kr
