"""Mixture-of-Experts with top-k routing (a port of
``repro.models.layers.moe``).

Dispatch:
  "ragged"  tokens replicated to (T*topk) rows, sorted stably by assigned
            expert, then one grouped product per non-empty expert group
            (the reference's ``jax.lax.ragged_dot``); no capacity dropping.
            The group sizes are read to the host once per call: one host
            synchronization per MoE layer and step (two in training with
            remat: the forward and its recompute). The backward pass holds
            no float scatter-add over repeated indices, so it is
            deterministic on the GPU.
  "dense"   every expert on every token, combined with the routing
            weights (E/top_k x the active FLOPs, no dispatch).
  "sharded" the reference's ``shard_map``: tokens stay on their data
            shard, the sort-and-group runs per rank on the rank's ``d_ff``
            slices of every expert, and one rank-order sum over "model"
            follows the down-projection. It needs a mesh: the model's own
            (``build_model(cfg, mesh=...)`` passes its ``Shard``) or the
            one registered by ``set_shard_mesh``.

On a "model" axis every dispatch runs on the rank's slices (the reference's
pjit runs "ragged" and "dense" on them too): the expert stacks are split on
``d_ff`` (all experts resident on every rank, no all-to-all), the router by
columns when E divides, its logits gathered whole (exact) before routing,
and the shared experts are column/row-parallel; the partial outputs are
summed once. In the port every rank already holds only its data shard's
tokens, so "sharded" and "ragged" compute the same function.

Training on a "model" axis: the replicated tokens and routing weights
enter the rank's share of the split experts (``Shard.enter``), so their
gradients are summed over the ranks, and a split router's gathered logits
give each rank its slice of their gradient. Both dispatches run backward
on split expert stacks.

Aux losses: the load-balance loss (Switch-style) and the router z-loss,
returned as the reference returns them, over the global batch: when the
batch's rows are split over data ranks (``rows``), the expert counts, the
probability sums and the squared log-partition sums are summed over those
ranks in rank order before the losses are formed (a product of means is not
a mean of products).
"""

from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import is_fake

from repro_torch.models.layers.basic import act_fn, dense


def init_moe(d_model: int, n_experts: int, d_ff: int, n_shared: int = 0,
             shared_d_ff: int = 0):
    p = {
        "router": dense((d_model, n_experts), scale=0.02),
        "w_in": dense((n_experts, d_model, d_ff)),
        "w_gate": dense((n_experts, d_model, d_ff)),
        "w_out": dense((n_experts, d_ff, d_model)),
    }
    if n_shared > 0:
        sf = shared_d_ff or d_ff
        p["shared_w_in"] = dense((d_model, n_shared * sf))
        p["shared_w_gate"] = dense((d_model, n_shared * sf))
        p["shared_w_out"] = dense((n_shared * sf, d_model))
    return p


_SHARD_MESH = {"mesh": None}


def set_shard_mesh(mesh) -> None:
    """Register the mesh that dispatch="sharded" uses when the caller
    passes no ``Shard`` (the reference's launcher registers its mesh the
    same way before tracing)."""
    _SHARD_MESH["mesh"] = mesh


def _route(p, xt, top_k, sh=None, xe=None):
    """(logits, probs, top_p, top_e) of tokens ``xt``; a router split by
    columns multiplies ``xe`` (``xt`` entered into the rank's share, by
    default here) and its logits are gathered whole."""
    if sh is not None and sh.split(p, "router", 1):
        xe = sh.enter(xt) if xe is None else xe
        logits = sh.gather(xe @ p["router"].to(xt.dtype), -1)
    else:
        logits = xt @ p["router"].to(xt.dtype)                      # (T, E)
    logits = logits.float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, top_k, dim=-1)                 # (T, K)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    return logits, probs, top_p, top_e


def _counts(flat_e, n_experts):
    """``bincount(flat_e, minlength=n_experts)`` without the host read that
    CUDA's bincount makes to size its output."""
    return torch.zeros(n_experts, dtype=torch.int64,
                       device=flat_e.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))


def _group_sizes(flat_e, n_experts):
    """Rows routed to each expert, read on the host. A fake tensor (the
    dry run, ``launch.dryrun``) holds no values: it gets balanced groups,
    ``len(flat_e) / n_experts`` rows each (the first ones one more when it
    does not divide), as the reference's static shapes assume."""
    if is_fake(flat_e):
        q, r = divmod(flat_e.numel(), n_experts)
        return [q + (e < r) for e in range(n_experts)]
    return _counts(flat_e, n_experts).tolist()


def _ragged_experts(w_in, w_gate, w_out, xt, top_p, top_e, n_experts, top_k,
                    act):
    """Sort-and-group dispatch: rows sorted by expert, one product per
    non-empty group, rows put back in token order and combined."""
    t, d = xt.shape
    flat_e = top_e.reshape(-1)                                       # (T*K,)
    order = torch.argsort(flat_e, stable=True)
    # each token's K copies, then sorted: both steps' backward passes are
    # sums in a fixed order (no scatter-add of duplicate indices)
    rows = xt.repeat_interleave(top_k, dim=0)[order]                # (T*K, d)
    sizes = _group_sizes(flat_e, n_experts)                          # host read
    groups = []
    for e, r in zip(range(n_experts), torch.split(rows, sizes)):
        if r.shape[0]:
            h = act_fn(act)(r @ w_gate[e]) * (r @ w_in[e])
            groups.append(h @ w_out[e])
    out_rows = torch.cat(groups)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=order.device)
    out_rows = out_rows[inv].reshape(t, top_k, d)
    return torch.einsum("tkd,tk->td", out_rows, top_p.to(xt.dtype))


def _aux_losses(logits, probs, top_e, n_experts, top_k, rows):
    """(lb_loss, z_loss) of the global batch; ``rows`` (or None) are the
    ranks this rank's tokens are one share of."""
    t = logits.shape[0]
    counts = _counts(top_e.reshape(-1), n_experts)
    lse2 = torch.logsumexp(logits, dim=-1) ** 2
    if rows is None:
        # load balance: E * sum_e f_e * P_e  (f = fraction routed, P = mean
        # prob)
        f = counts.float() / (t * top_k)
        pbar = probs.mean(dim=0)
        return n_experts * torch.sum(f * pbar), torch.mean(lse2)
    sums = rows.sum(torch.cat([counts.float(), probs.sum(dim=0),
                               lse2.sum()[None]]))
    n = t * rows.size
    f = sums[:n_experts] / (n * top_k)
    pbar = sums[n_experts:2 * n_experts] / n
    return n_experts * torch.sum(f * pbar), sums[-1] / n


def moe(p, x, *, n_experts: int, top_k: int, act: str = "silu",
        dispatch: str = "ragged", sh=None, rows=None):
    """x: (B, S, d), this rank's tokens. Returns (out, aux) with aux =
    (lb_loss, z_loss). ``sh``: this rank on the "model" axis, or None;
    ``rows``: the ranks the batch's rows are split over, or None."""
    if dispatch == "sharded" and sh is None:
        mesh = _SHARD_MESH["mesh"]
        if mesh is None:
            raise ValueError("moe dispatch='sharded' needs a mesh: build the "
                             "model with mesh=..., or set_shard_mesh(mesh)")
        from repro_torch.models.layers.parallel import Shard
        sh = Shard.of(mesh)
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    partial = sh is not None and sh.split(p, "w_out", 1)
    shared_partial = "shared_w_in" in p and sh is not None and \
        sh.split(p, "shared_w_out", 0)
    # the replicated tokens (and routing weights) entering the rank's share,
    # once for the router, the experts and the shared experts
    split = partial or shared_partial or (
        sh is not None and sh.split(p, "router", 1))
    xe = sh.enter(xt) if split else xt
    logits, probs, top_p, top_e = _route(p, xt, top_k, sh, xe)
    xs = xe if shared_partial else xt
    xr, pr = (xe, sh.enter(top_p)) if partial else (xt, top_p)

    if dispatch == "dense":
        w_full = torch.zeros(top_e.shape + (n_experts,), dtype=x.dtype,
                             device=x.device).scatter_(
            -1, top_e[..., None], 1.0)                               # (T,K,E)
        w_full = torch.einsum("tke,tk->te", w_full, pr.to(x.dtype))
        h_in = torch.einsum("td,edf->tef", xr, p["w_in"].to(x.dtype))
        h_gate = torch.einsum("td,edf->tef", xr, p["w_gate"].to(x.dtype))
        h = act_fn(act)(h_gate) * h_in
        out = torch.einsum("tef,efd,te->td", h, p["w_out"].to(x.dtype),
                           w_full)
    else:
        out = _ragged_experts(p["w_in"].to(x.dtype), p["w_gate"].to(x.dtype),
                              p["w_out"].to(x.dtype), xr, pr, top_e,
                              n_experts, top_k, act)

    if "shared_w_in" in p:
        hs = (act_fn(act)(xs @ p["shared_w_gate"].to(x.dtype))
              * (xs @ p["shared_w_in"].to(x.dtype)))
        shared = hs @ p["shared_w_out"].to(x.dtype)
        if shared_partial and not partial:
            shared = sh.sum(shared)
        elif partial and not shared_partial:
            out, partial = sh.sum(out), False
        out = out + shared          # both partial: one sum of both below
    if partial:
        out = sh.sum(out)

    aux = _aux_losses(logits, probs, top_e, n_experts, top_k, rows)
    return out.reshape(b, s, d), aux
