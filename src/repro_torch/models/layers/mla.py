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
"""

from __future__ import annotations

import torch

from repro_torch.models.layers.attention import NEG, as_pos, scale_of
from repro_torch.models.layers.basic import apply_rope, const, dense, rms_norm


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


def _project_q(p, x, n_heads, nope_d, rope_d, positions):
    b, s, _ = x.shape
    cq = rms_norm(p["q_norm"], x @ p["w_dq"].to(x.dtype))
    q = (cq @ p["w_uq"].to(x.dtype)).reshape(b, s, n_heads, nope_d + rope_d)
    q_nope, q_rope = q[..., :nope_d], q[..., nope_d:]
    q_rope = apply_rope(q_rope, positions, 1e4)
    return q_nope, q_rope


def mla_forward(p, x, positions, *, n_heads, q_lora, kv_lora, rope_d, nope_d,
                v_d, q_block=512):
    """Full-sequence causal MLA. Returns (out, (c_kv, k_rope)) for caching."""
    b, s, _ = x.shape
    q_nope, q_rope = _project_q(p, x, n_heads, nope_d, rope_d, positions)
    c_kv = rms_norm(p["kv_norm"], x @ p["w_dkv"].to(x.dtype))     # (B,S,ckv)
    k_rope = apply_rope((x @ p["w_kr"].to(x.dtype))[:, :, None, :],
                        positions, 1e4)[:, :, 0]                   # (B,S,rd)
    k_nope = (c_kv @ p["w_uk"].to(x.dtype)).reshape(b, s, n_heads, nope_d)
    v = (c_kv @ p["w_uv"].to(x.dtype)).reshape(b, s, n_heads, v_d)
    scale = scale_of(nope_d + rope_d)
    kpos = positions.expand(b, s) if positions.dim() == 1 else positions

    def attend(qn, qr, qpos):
        sc = (torch.einsum("bqhd,bkhd->bhqk", qn.float(), k_nope.float())
              + torch.einsum("bqhd,bkd->bhqk", qr.float(),
                             k_rope.float())) * scale
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
    out = out.reshape(b, s, n_heads * v_d)
    return out @ p["wo"].to(x.dtype), (c_kv, k_rope)


def mla_decode(p, x1, cache_c, cache_kr, pos, *, n_heads, q_lora, kv_lora,
               rope_d, nope_d, v_d):
    """Absorbed one-token decode. cache_c: (B,S,kv_lora); cache_kr: (B,S,rd),
    both written in place at ``pos``."""
    b = x1.shape[0]
    s_cache = cache_c.shape[1]
    pos = as_pos(pos, x1.device)
    positions = pos.reshape(1, 1).expand(b, 1)
    q_nope, q_rope = _project_q(p, x1, n_heads, nope_d, rope_d, positions)
    c_new = rms_norm(p["kv_norm"], x1 @ p["w_dkv"].to(x1.dtype))
    kr_new = apply_rope((x1 @ p["w_kr"].to(x1.dtype))[:, :, None, :],
                        positions, 1e4)[:, :, 0]
    at = pos.reshape(1)
    cache_c.index_copy_(1, at, c_new.to(cache_c.dtype))
    cache_kr.index_copy_(1, at, kr_new.to(cache_kr.dtype))
    # absorption: q_abs[h, ckv] = q_nope[h] @ W_uk[h]^T
    w_uk = p["w_uk"].to(x1.dtype).reshape(kv_lora, n_heads, nope_d)
    q_abs = torch.einsum("bqhd,chd->bqhc", q_nope, w_uk)        # (B,1,H,ckv)
    sc = (torch.einsum("bqhc,bkc->bhqk", q_abs.float(), cache_c.float())
          + torch.einsum("bqhd,bkd->bhqk", q_rope.float(),
                         cache_kr.float())) * scale_of(nope_d + rope_d)
    kpos = torch.arange(s_cache, device=x1.device)
    sc = torch.where((kpos <= pos)[None, None, None, :], sc, NEG)
    w = torch.softmax(sc, dim=-1)
    ctx = torch.einsum("bhqk,bkc->bqhc", w, cache_c.float())
    w_uv = p["w_uv"].float().reshape(kv_lora, n_heads, v_d)
    out = torch.einsum("bqhc,chd->bqhd", ctx, w_uv).to(x1.dtype)
    out = out.reshape(b, 1, n_heads * v_d)
    return out @ p["wo"].to(x1.dtype), cache_c, cache_kr
