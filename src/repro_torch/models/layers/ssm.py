"""Mamba-2 (SSD, state-space duality) layer -- arXiv:2405.21060; a port of
``repro.models.layers.ssm``.

Chunked SSD forward (training/prefill): the sequence is split into chunks of
``chunk`` tokens; within a chunk the quadratic "attention-like" form runs as
batched products, across chunks a short loop carries the (H, P, N) state.

Decode: O(1) per token -- h = h * exp(A dt) + dt * (B outer x); y = C . h.

Layout: x is (B, S, d_inner) with d_inner = n_heads * head_p.

On a "model" axis (``sh``, ``layers.parallel``) the block runs
tensor-parallel as the rules split it. A column-split ``w_in``'s blocks
are gathered, so every rank holds whole z/x/B/C/dt groups (the rules' cut
may fall inside one); a channel-split ``conv_w`` convolves the rank's
channels and gathers them. The scan runs on the rank's block of the state
as ``cache_shardings`` lays it out: its heads when H divides the axis,
else its slice of every head's P columns, else whole. On heads, the gated
RMSNorm adds the ranks' (B, S, 1) sums of squares and the row-split
``w_out`` takes the rank's block of y, which is its heads; otherwise y is
gathered whole and ``w_out`` takes its contiguous block. The partial
products are summed in rank order. The conv state is whole on every rank;
the SSM state is the rank's block.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers.basic import const, dense, rms_norm
from repro_torch.models.layers.parallel import columns, row_parallel

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


def state_split(sh, n_heads: int, head_p: int):
    """Which dimension of the (B, H, P, N) state this rank holds a block of
    on a "model" axis (``cache_shardings``' rule): ``"H"``, ``"P"``, or
    None (whole: one rank, or neither divides)."""
    if sh is None or sh.mp == 1:
        return None
    if n_heads % sh.mp == 0 and n_heads >= sh.mp:
        return "H"
    if head_p % sh.mp == 0 and head_p >= sh.mp:
        return "P"
    return None


def _split_proj(p, x, d_inner, d_state, sh=None):
    zxbcdt = columns(p, x, ("w_in",), sh)["w_in"]
    return torch.split(zxbcdt, [d_inner, d_inner + 2 * d_state,
                                zxbcdt.shape[-1] - 2 * d_inner - 2 * d_state],
                       dim=-1)


def _causal_conv(xbc, conv_w, conv_state=None, sh=None, split=False):
    """Depthwise causal conv, kernel CONV_K. xbc: (B, S, C).
    conv_state: (B, CONV_K-1, C) history for decode; returns (out, new_state).
    ``split``: ``conv_w`` holds the rank's block of the channels, which it
    convolves; the blocks are gathered (``xbc`` and the state whole)."""
    w = conv_w.to(xbc.dtype)                           # (K, C)
    if conv_state is None:
        pad = torch.zeros_like(xbc[:, :CONV_K - 1])
    else:
        pad = conv_state.to(xbc.dtype)
    xp = torch.cat([pad, xbc], dim=1)                  # (B, S+K-1, C)
    new_state = xp[:, -(CONV_K - 1):]
    if split:
        xp = sh.enter(xp)[..., sh.block(xp.shape[-1])]
    out = F.silu(sum(xp[:, i:i + xbc.shape[1]] * w[i] for i in range(CONV_K)))
    return (sh.gather(out, -1) if split else out), new_state


def _rank_part(sh, split, n_heads, head_p):
    """(heads, P columns) of the state this rank computes, as slices."""
    every = slice(None)
    if split == "H":
        return sh.block(n_heads), every
    if split == "P":
        return every, sh.block(head_p)
    return every, every


def _gated_out(p, y, z, sh, split, d_inner):
    """``w_out`` of the gated RMSNorm of y, from the rank's part of y
    (B, S, H_r, P_r): on heads, the norm's sum of squares is added over the
    ranks and ``w_out``'s row block multiplies the rank's heads; on P
    columns y is gathered whole first."""
    b, s = y.shape[:2]
    if split == "H" and sh.split(p, "w_out", 0):
        cols = sh.block(d_inner)
        g = y.reshape(b, s, -1) * F.silu(sh.enter(z)[..., cols])
        gf = g.float()
        var = sh.enter(sh.sum(gf.square().sum(-1, keepdim=True))) / d_inner
        g = (gf * torch.rsqrt(var + 1e-6)
             * sh.enter(p["norm_w"])[cols].float()).to(g.dtype)
        return sh.sum(g @ p["w_out"].to(g.dtype))
    if split is not None:                   # the rank's part: gather it
        y = sh.gather(y, 3 if split == "P" else 2)
    y = rms_norm(p["norm_w"], y.reshape(b, s, d_inner) * F.silu(z))
    return row_parallel(p, "w_out", y, sh)


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
    # The mask goes inside the exp: above the diagonal cum_i - cum_j > 0
    # overflows to inf over a long chunk, and where(mask, exp(.), 0) then
    # backpropagates 0 * inf = NaN (the reference's form does). The values
    # are the same.
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (b,nc,Lq,Lk,h)
    iq = torch.arange(chunk, device=x.device)
    causal = (iq[:, None] >= iq[None, :])[None, None, :, :, None]
    L = torch.exp(torch.where(causal, diff, float("-inf")))
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
                chunk: int = 256, sh=None, whole_state: bool = True):
    """Full-sequence Mamba-2 block body. x: (B, S, d_model).
    Returns (out, (final_state, conv_state)). On a "model" axis (``sh``)
    the final state is gathered whole unless ``whole_state`` is False
    (training, which keeps no cache): then it is the rank's block."""
    b, s, _ = x.shape
    n_heads = d_inner // head_p
    split = state_split(sh, n_heads, head_p)
    ent = sh.enter if split else (lambda t: t)
    hs, ps = _rank_part(sh, split, n_heads, head_p)
    z, xbc, dt = _split_proj(p, x, d_inner, d_state, sh)
    xbc, conv_state = _causal_conv(xbc, p["conv_w"], sh=sh,
                                   split=sh is not None
                                   and sh.split(p, "conv_w", 1))
    xi, B, C = torch.split(ent(xbc), [d_inner, d_state, d_state], dim=-1)
    dt = F.softplus(ent(dt).float()[..., hs]
                    + ent(p["dt_bias"])[hs][None, None, :])
    A = -torch.exp(ent(p["A_log"])[hs])
    xh = xi.reshape(b, s, n_heads, head_p)[:, :, hs, ps]
    xs = xh
    pad = (-s) % chunk
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    y, hlast = ssd_chunked(xh, dt, A, B, C, chunk=chunk)
    y = y[:, :s]
    y = y + ent(p["D"]).to(y.dtype)[hs][None, None, :, None] * xs
    if split is not None and whole_state:
        hlast = sh.gather(hlast, 1 if split == "H" else 2)
    return _gated_out(p, y, z, sh, split, d_inner), (hlast, conv_state)


def ssm_decode(p, x1, ssm_state, conv_state, *, d_inner: int, d_state: int,
               head_p: int = 64, sh=None):
    """One-token decode. x1: (B,1,d_model); ssm_state: (B,H,P,N), on a
    "model" axis (``sh``) the rank's block of it; conv_state: (B, CONV_K-1,
    d_inner+2N), whole. Returns (out, new_ssm, new_conv) as new tensors."""
    b = x1.shape[0]
    n_heads = d_inner // head_p
    split = state_split(sh, n_heads, head_p)
    hs, ps = _rank_part(sh, split, n_heads, head_p)
    z, xbc, dt = _split_proj(p, x1, d_inner, d_state, sh)
    xbc, conv_state = _causal_conv(xbc, p["conv_w"], conv_state, sh,
                                   sh is not None
                                   and sh.split(p, "conv_w", 1))
    xi, B, C = torch.split(xbc, [d_inner, d_state, d_state], dim=-1)
    dt = F.softplus(dt.float()[..., hs] + p["dt_bias"][hs])       # (B,1,H)
    A = -torch.exp(p["A_log"][hs])
    dA = torch.exp(dt * A)[:, 0]                                  # (B,H)
    xh = xi.reshape(b, n_heads, head_p)[:, hs, ps].float()
    Bf = B[:, 0].float()                                          # (B,N)
    new_state = (ssm_state * dA[:, :, None, None]
                 + (dt[:, 0, :, None] * xh)[..., None] * Bf[:, None, None, :])
    y = torch.einsum("bn,bhpn->bhp", C[:, 0].float(), new_state)
    y = y + p["D"][hs][None, :, None] * xh
    y = y[:, None].to(x1.dtype)                                   # (B,1,H,P)
    return _gated_out(p, y, z, sh, split, d_inner), new_state, conv_state
