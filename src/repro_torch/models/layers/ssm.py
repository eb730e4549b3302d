"""Mamba-2 (SSD, state-space duality) layer -- arXiv:2405.21060; a port of
``repro.models.layers.ssm``.

Chunked SSD forward (training/prefill): the sequence is split into chunks of
``chunk`` tokens; within a chunk the quadratic "attention-like" form runs as
batched products, across chunks a short loop carries the (H, P, N) state.

Decode: O(1) per token -- h = h * exp(A dt) + dt * (B outer x); y = C . h.

Layout: x is (B, S, d_inner) with d_inner = n_heads * head_p.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers.basic import const, dense, rms_norm

CONV_K = 4


def init_ssm(d_model: int, d_inner: int, d_state: int, head_p: int = 64):
    n_heads = d_inner // head_p
    return {
        # fused input projection: [z, x, B, C, dt]
        "w_in": dense((d_model, 2 * d_inner + 2 * d_state + n_heads)),
        "conv_w": dense((CONV_K, d_inner + 2 * d_state), scale=0.5),
        "A_log": const((n_heads,), 0.0),
        "D": const((n_heads,), 1.0),
        "dt_bias": const((n_heads,), 0.0),
        "norm_w": const((d_inner,), 1.0),
        "w_out": dense((d_inner, d_model)),
    }


def _split_proj(p, x, d_inner, d_state):
    zxbcdt = x @ p["w_in"].to(x.dtype)
    return torch.split(zxbcdt, [d_inner, d_inner + 2 * d_state,
                                zxbcdt.shape[-1] - 2 * d_inner - 2 * d_state],
                       dim=-1)


def _causal_conv(xbc, conv_w, conv_state=None):
    """Depthwise causal conv, kernel CONV_K. xbc: (B, S, C).
    conv_state: (B, CONV_K-1, C) history for decode; returns (out, new_state)."""
    w = conv_w.to(xbc.dtype)                           # (K, C)
    if conv_state is None:
        pad = torch.zeros_like(xbc[:, :CONV_K - 1])
    else:
        pad = conv_state.to(xbc.dtype)
    xp = torch.cat([pad, xbc], dim=1)                  # (B, S+K-1, C)
    out = sum(xp[:, i:i + xbc.shape[1]] * w[i] for i in range(CONV_K))
    new_state = xp[:, -(CONV_K - 1):]
    return F.silu(out), new_state


def ssd_chunked(x, dt, A, B, C, *, chunk: int):
    """SSD scan. x: (b,S,H,P); dt: (b,S,H); A: (H,); B,C: (b,S,N).
    Returns (y (b,S,H,P), final_state (b,H,P,N)). S % chunk == 0."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    nc = s // chunk
    xc = x.reshape(b, nc, chunk, h, p).float()
    dtc = dt.reshape(b, nc, chunk, h).float()
    Bc = B.reshape(b, nc, chunk, n).float()
    Cc = C.reshape(b, nc, chunk, n).float()
    dA = dtc * A.float()[None, None, None, :]              # (b,nc,L,h) <= 0
    cum = torch.cumsum(dA, dim=2)                          # within-chunk
    seg_end = cum[:, :, -1]                                # (b,nc,h)

    # intra-chunk (quadratic, masked decay):  L[i,j] = exp(cum_i - cum_j) i>=j
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (b,nc,Lq,Lk,h)
    iq = torch.arange(chunk, device=x.device)
    causal = (iq[:, None] >= iq[None, :])[None, None, :, :, None]
    L = torch.where(causal, torch.exp(diff), 0.0)
    cb = torch.einsum("bcqn,bckn->bcqk", Cc, Bc)            # (b,nc,Lq,Lk)
    m = cb[..., None] * L * dtc[:, :, None, :, :]          # (b,nc,Lq,Lk,h)
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", m, xc)

    # chunk states: S_c = sum_k exp(segend - cum_k) dt_k B_k (x) x_k
    decay_out = torch.exp(seg_end[:, :, None, :] - cum)    # (b,nc,L,h)
    wx = (decay_out * dtc)[..., None] * xc                 # (b,nc,L,h,p)
    states = torch.einsum("bckhp,bckn->bchpn", wx, Bc)     # (b,nc,h,p,n)

    # inter-chunk recurrence over nc (the only sequential part)
    hcur = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    hprevs = []
    for c in range(nc):
        hprevs.append(hcur)
        hcur = hcur * torch.exp(seg_end[:, c])[:, :, None, None] \
            + states[:, c]
    hprevs = torch.stack(hprevs, dim=1)                    # (b,nc,h,p,n)

    # inter-chunk output: y_j += exp(cum_j) C_j . H_{c-1}
    decay_in = torch.exp(cum)                              # (b,nc,L,h)
    y_inter = torch.einsum("bcqn,bchpn->bcqhp", Cc, hprevs) \
        * decay_in[..., None]
    y = (y_intra + y_inter).reshape(b, s, h, p)
    return y.to(x.dtype), hcur


def ssm_forward(p, x, *, d_inner: int, d_state: int, head_p: int = 64,
                chunk: int = 256):
    """Full-sequence Mamba-2 block body. x: (B, S, d_model).
    Returns (out, (final_state, conv_state))."""
    b, s, _ = x.shape
    n_heads = d_inner // head_p
    z, xbc, dt = _split_proj(p, x, d_inner, d_state)
    xbc, conv_state = _causal_conv(xbc, p["conv_w"])
    xi, B, C = torch.split(xbc, [d_inner, d_state, d_state], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"][None, None, :])
    A = -torch.exp(p["A_log"])
    xh = xi.reshape(b, s, n_heads, head_p)
    pad = (-s) % chunk
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    y, hlast = ssd_chunked(xh, dt, A, B, C, chunk=chunk)
    y = y[:, :s]
    y = y + p["D"].to(y.dtype)[None, None, :, None] \
        * xi.reshape(b, s, n_heads, head_p)
    y = y.reshape(b, s, d_inner)
    y = rms_norm(p["norm_w"], y * F.silu(z))
    return y @ p["w_out"].to(x.dtype), (hlast, conv_state)


def ssm_decode(p, x1, ssm_state, conv_state, *, d_inner: int, d_state: int,
               head_p: int = 64):
    """One-token decode. x1: (B,1,d_model); ssm_state: (B,H,P,N);
    conv_state: (B, CONV_K-1, d_inner+2N). Returns (out, new_ssm, new_conv)
    as new tensors."""
    b = x1.shape[0]
    n_heads = d_inner // head_p
    z, xbc, dt = _split_proj(p, x1, d_inner, d_state)
    xbc, conv_state = _causal_conv(xbc, p["conv_w"], conv_state)
    xi, B, C = torch.split(xbc, [d_inner, d_state, d_state], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"])                    # (B,1,H)
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dt * A)[:, 0]                                  # (B,H)
    xh = xi.reshape(b, n_heads, head_p).float()
    Bf = B[:, 0].float()                                          # (B,N)
    new_state = (ssm_state * dA[:, :, None, None]
                 + (dt[:, 0, :, None] * xh)[..., None] * Bf[:, None, None, :])
    y = torch.einsum("bn,bhpn->bhp", C[:, 0].float(), new_state)
    y = y + p["D"][None, :, None] * xh
    y = y.reshape(b, 1, d_inner).to(x1.dtype)
    y = rms_norm(p["norm_w"], y * F.silu(z))
    return y @ p["w_out"].to(x1.dtype), new_state, conv_state
