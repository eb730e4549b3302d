"""Model assembly: init / train-forward / prefill / decode for every family
(a port of ``repro.models.model``).

``Model`` is an ``nn.Module`` whose parameters keep the reference's pytree
names (``embed.table``, ``blocks.3.attn.wq``, ...). Where the reference
scans weights stacked on a leading L axis, the port holds one module per
layer in an ``nn.ModuleList`` (``lead_blocks``, ``blocks``,
``enc_blocks``) and loops over them. Decode caches keep the reference's
stacked layout, {"main": {"k": (L, B, S, KVH, D), ...}}; each layer reads
and writes views of the stack in place, so ``decode_step`` returns the
cache it was given, updated.

Storage: matmul weights in the config's dtype; norm weights, ``A_log``,
``D``, ``dt_bias``, the embedding and head tables and MLA's ``w_uv`` in
float32, since the reference uses them in float32 (``storage_dtype``).
Training keeps float32 masters instead (``repro_torch.train``) and hands
``forward_train`` the tensors to compute with, by parameter name.

Batch dict contract (all optional keys per family):
  tokens   (B, S)  int          text tokens (decoder tokens for enc-dec)
  labels   (B, S)  int          next-token labels, -1 = masked
  frontend_embeds (B, T, d)     vlm: patch embeddings (prepended);
                                audio: encoder frame embeddings
Decode: tokens (B, 1), pos an int or a 0-d integer tensor, plus the cache.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, NamedTuple, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core.graph import resolve_device
from repro_torch.models import blocks as B
from repro_torch.models.layers import attention as A
from repro_torch.models.layers.basic import (Leaf, const, dense, dense_init,
                                             embed, init_embedding, rms_norm,
                                             unembed)

# parameters the reference uses in float32 whatever the config's dtype
F32_LEAVES = frozenset({
    "ln1", "ln2", "lnx", "final_norm", "enc_norm", "norm", "q_norm",
    "k_norm", "kv_norm", "norm_w", "A_log", "D", "dt_bias", "table", "w_uv"})
STACKS = ("lead_blocks", "blocks", "enc_blocks")


def storage_dtype(name: str, dtype: torch.dtype) -> torch.dtype:
    """The dtype the port stores parameter ``name`` (a dotted path) in."""
    return torch.float32 if name.rsplit(".", 1)[-1] in F32_LEAVES else dtype


def stacked_ndim(name: str, t) -> int:
    """The ndim of parameter ``name`` in the reference's tree, where every
    leaf of a block stack carries a leading L axis: ``t.ndim + 1`` under
    ``lead_blocks``, ``blocks`` and ``enc_blocks``, ``t.ndim`` elsewhere
    (the MTP head's block is not stacked). The reference decides by this
    ndim which leaves a train step casts and AdamW decays."""
    return len(t.shape) + (name.split(".", 1)[0] in STACKS)


def param_tree(params: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """Flat ``{dotted name: tensor}`` (a ``state_dict``'s layout) as the
    nested tree the layer functions read: dicts, and each block stack as
    a list of per-layer dicts."""
    tree: Dict[str, Any] = {}
    for name, t in params.items():
        *path, leaf = name.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = t
    for stack in STACKS:
        if stack in tree:
            tree[stack] = [tree[stack][str(i)]
                           for i in range(len(tree[stack]))]
    return tree


def _xent(logits: torch.Tensor, labels: torch.Tensor):
    """Masked mean cross-entropy; labels -1 are ignored. logits f32.
    Returns (loss, number of unmasked labels)."""
    mask = labels >= 0
    safe = labels.clamp_min(0).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = torch.where(mask, logz - gold, 0.0)
    denom = mask.sum().clamp_min(1)
    return nll.sum() / denom, denom


def _remat(fn, remat: bool, *args):
    """``fn(*args)``, recomputed in the backward pass when ``remat`` (the
    reference's ``jax.checkpoint``: only the inputs are kept)."""
    if remat:
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def model_dtype(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def sinusoid(positions: torch.Tensor, d: int) -> torch.Tensor:
    """Absolute sinusoidal embeddings (whisper), (..., d) float32: sin at
    even features, cos at odd, computed in float64 on the positions'
    device, for prefill and decode alike."""
    dim = torch.arange(0, d, 2, dtype=torch.float64,
                       device=positions.device) / d
    ang = positions[..., None].double() / (10000.0 ** dim)
    return torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1).reshape(
        *positions.shape, d).float()


class CacheSpec(NamedTuple):
    shape: Tuple[int, ...]
    dtype: torch.dtype


class ParamTree(nn.Module):
    """A nested mapping of parameters built from a spec: a dict of
    ``Leaf``s, sub-dicts and lists of sub-dicts (per-layer stacks).
    ``p["attn"]["wq"]`` and ``"w_gate" in p`` read it as the reference's
    layer functions read a params dict."""

    def __init__(self, spec, dtype, device, prefix, leaves):
        super().__init__()
        _register(self, spec, dtype, device, prefix, leaves)

    def __getitem__(self, key):
        return getattr(self, key)

    def __contains__(self, key) -> bool:
        return key in self._parameters or key in self._modules


def _register(module: nn.Module, spec, dtype, device, prefix, leaves):
    """Add ``spec``'s parameters and subtrees to ``module``; record each
    parameter's ``Leaf`` under its dotted name in ``leaves``."""
    for key, sub in spec.items():
        name = prefix + key
        if isinstance(sub, Leaf):
            t = torch.empty(sub.shape, dtype=storage_dtype(name, dtype),
                            device=device)
            module.register_parameter(key, nn.Parameter(t,
                                                        requires_grad=False))
            leaves[name] = sub
        elif isinstance(sub, list):
            module.add_module(key, nn.ModuleList(
                ParamTree(s, dtype, device, f"{name}.{i}.", leaves)
                for i, s in enumerate(sub)))
        else:
            module.add_module(key, ParamTree(sub, dtype, device, name + ".",
                                             leaves))


class Model(nn.Module):
    """Family-polymorphic model bound to an ArchConfig, on ``device`` (the
    GPU unless the caller passes ``device="cpu"``). Parameters are
    allocated uninitialized; ``init_params`` fills them from a generator,
    or ``load_state_dict(params_from_reference(cfg, tree))`` carries the
    reference's."""

    def __init__(self, cfg: ArchConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = model_dtype(cfg)
        self._leaves: Dict[str, Leaf] = {}
        _register(self, self._param_spec(), self.dtype, self.device, "",
                  self._leaves)

    def __getitem__(self, key):
        """``model["blocks"]`` reads the model as ``param_tree`` reads a
        flat mapping, so one set of helpers serves both."""
        return getattr(self, key)

    # ------------------------------------------------------------- init --

    def _layer_kinds(self) -> Tuple[str, int, str, int]:
        """(lead_kind, lead_n, main_kind, main_n)."""
        cfg = self.cfg
        if cfg.ssm:
            return ("ssm", 0, "ssm", cfg.n_layers)
        if cfg.hybrid:
            return ("hybrid", 0, "hybrid", cfg.n_layers)
        if cfg.n_experts > 0:
            return ("dense", cfg.n_dense_layers, "moe",
                    cfg.n_layers - cfg.n_dense_layers)
        return ("dense", 0, "dense", cfg.n_layers)

    def _param_spec(self) -> Dict[str, Any]:
        """The reference's parameter tree as ``Leaf`` specs, with each
        stacked block tree as a list of per-layer trees."""
        cfg = self.cfg
        p: Dict[str, Any] = {"embed": init_embedding(cfg.padded_vocab,
                                                     cfg.d_model),
                             "final_norm": const((cfg.d_model,), 1.0)}
        lead_kind, lead_n, main_kind, main_n = self._layer_kinds()
        if cfg.enc_dec:
            p["enc_blocks"] = [B.init_enc_block(cfg)
                               for _ in range(cfg.n_enc_layers)]
            p["enc_norm"] = const((cfg.d_model,), 1.0)
            p["blocks"] = [B.init_xdec_block(cfg) for _ in range(cfg.n_layers)]
        else:
            if lead_n:
                p["lead_blocks"] = [B.init_block(cfg, lead_kind)
                                    for _ in range(lead_n)]
            p["blocks"] = [B.init_block(cfg, main_kind)
                           for _ in range(main_n)]
        if not cfg.tie_embeddings:
            p["lm_head"] = {"table": dense((cfg.padded_vocab, cfg.d_model))}
        if cfg.mtp:
            p["mtp"] = {"proj": dense((2 * cfg.d_model, cfg.d_model)),
                        "block": B.init_block(cfg, "dense"),
                        "norm": const((cfg.d_model,), 1.0)}
        return p

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "Model":
        """Fill every parameter: dense weights drawn N(0, scale^2) in
        float32 on the generator's device (then cast and moved to the
        model's), the rest constant. Returns the model."""
        params = dict(self.named_parameters())
        for name, leaf in self._leaves.items():
            if leaf.scale is None:
                params[name].fill_(leaf.fill)
            else:
                params[name].copy_(dense_init(generator, leaf.shape,
                                              leaf.scale))
        return self

    # ------------------------------------------------------- embeddings --

    def _embed_inputs(self, p, batch: Dict[str, torch.Tensor]):
        """Returns (x (B,S,d), positions (B,S), labels-or-None); for the
        vision frontend the labels are padded with -1 over the patches."""
        cfg = self.cfg
        x = embed(p["embed"], batch["tokens"].to(self.device), self.dtype)
        labels = batch.get("labels")
        if labels is not None:
            labels = labels.to(self.device)
        if cfg.frontend == "vision" and "frontend_embeds" in batch:
            fe = batch["frontend_embeds"].to(self.device, self.dtype)
            x = torch.cat([fe, x], dim=1)
            if labels is not None:
                labels = torch.cat([labels.new_full(fe.shape[:2], -1),
                                    labels], dim=1)
        b, s = x.shape[0], x.shape[1]
        positions = torch.arange(s, dtype=torch.int32,
                                 device=self.device).expand(b, s)
        if cfg.rope_theta == 0.0:  # absolute sinusoidal (whisper)
            x = x + sinusoid(positions, cfg.d_model).to(self.dtype)
        return x, positions, labels

    def _unembed(self, p, x: torch.Tensor) -> torch.Tensor:
        head = p["embed"] if self.cfg.tie_embeddings else p["lm_head"]
        return unembed(head, x)

    # ----------------------------------------------------------- encode --

    def _encode(self, p, frames: torch.Tensor) -> torch.Tensor:
        """Whisper encoder over stub frame embeddings (B, S_enc, d)."""
        x = frames.to(self.device, self.dtype)
        s = x.shape[1]
        positions = torch.arange(s, dtype=torch.int32,
                                 device=self.device).expand(x.shape[0], s)
        x = x + sinusoid(positions, self.cfg.d_model).to(self.dtype)
        for p_l in p["enc_blocks"]:
            x = B.enc_block_forward(p_l, x, positions, self.cfg)
        return rms_norm(p["enc_norm"], x)

    # ------------------------------------------------------------ train --

    def forward_train(self, params: Mapping[str, torch.Tensor],
                      batch: Dict[str, torch.Tensor], *, remat: bool = True):
        """Returns (loss, metrics dict) as the reference computes them:
        the masked mean cross-entropy of ``batch["labels"]``, plus 0.01 x
        the MoE load-balance loss and 1e-3 x the router z-loss (each
        averaged over the MoE layers) and 0.3 x the MTP loss. Metrics:
        ``xent``, ``n_tokens``, ``lb_loss`` and ``z_loss`` (MoE),
        ``mtp_loss`` (MTP), ``loss``.

        ``params`` maps every parameter name to the tensor to compute with
        (``dict(model.named_parameters())``, or a train step's cast
        copies); gradients flow back to those tensors. With ``remat`` each
        block is recomputed in the backward pass."""
        cfg = self.cfg
        p = param_tree(params)
        if cfg.enc_dec:
            return self._forward_train_encdec(p, batch, remat=remat)
        x, positions, labels = self._embed_inputs(p, batch)
        lead_kind, lead_n, main_kind, main_n = self._layer_kinds()
        lb_loss = z_loss = torch.zeros((), dtype=torch.float32,
                                       device=self.device)
        for stack, kind in (("lead_blocks", lead_kind), ("blocks", main_kind)):
            def block(p_l, x, kind=kind):
                x, _, (l1, l2) = B.block_forward(p_l, x, positions, cfg, kind)
                return x, l1, l2
            for p_l in p.get(stack, ()):
                x, l1, l2 = _remat(block, remat, p_l, x)
                lb_loss, z_loss = lb_loss + l1, z_loss + l2
        x = rms_norm(p["final_norm"], x)
        logits = self._unembed(p, x)
        loss, n_tok = _xent(logits, labels)
        metrics = {"xent": loss, "n_tokens": n_tok}
        total = loss
        if cfg.n_experts:
            metrics["lb_loss"] = lb_loss / main_n
            metrics["z_loss"] = z_loss / main_n
            total = total + 0.01 * metrics["lb_loss"] \
                + 1e-3 * metrics["z_loss"]
        if cfg.mtp:
            mtp_loss = self._mtp_loss(p, x, batch, positions)
            metrics["mtp_loss"] = mtp_loss
            total = total + 0.3 * mtp_loss
        metrics["loss"] = total
        return total, metrics

    def _mtp_loss(self, p, h, batch, positions):
        """DeepSeek-V3 multi-token prediction (depth 1): predict t+2 from
        [h_t ; emb(tok_{t+1})]."""
        cfg = self.cfg
        tokens = batch["tokens"].to(self.device)
        labels = batch["labels"].to(self.device)
        emb_next = embed(p["embed"], torch.roll(tokens, -1, dims=1),
                         self.dtype)
        z = torch.cat([h.to(self.dtype), emb_next], dim=-1)
        z = z @ p["mtp"]["proj"].to(self.dtype)
        z, _, _ = B.block_forward(p["mtp"]["block"], z, positions, cfg,
                                  "dense")
        z = rms_norm(p["mtp"]["norm"], z)
        logits = self._unembed(p, z)
        mtp_labels = torch.roll(labels, -1, dims=1)
        mtp_labels[:, -2:] = -1
        loss, _ = _xent(logits, mtp_labels)
        return loss

    def _forward_train_encdec(self, p, batch, *, remat: bool = True):
        cfg = self.cfg
        enc_out = self._encode(p, batch["frontend_embeds"])
        x, positions, labels = self._embed_inputs(p, batch)

        def block(p_l, x):
            ek, ev = A.cross_kv(p_l["xattn"], enc_out, n_heads=cfg.n_heads,
                                head_dim=cfg.resolved_head_dim)
            out, _ = B.xdec_block_forward(p_l, x, positions, ek, ev, cfg)
            return out

        for p_l in p["blocks"]:
            x = _remat(block, remat, p_l, x)
        x = rms_norm(p["final_norm"], x)
        logits = self._unembed(p, x)
        loss, n_tok = _xent(logits, labels)
        return loss, {"xent": loss, "loss": loss, "n_tokens": n_tok}

    # ---------------------------------------------------------- prefill --

    @torch.no_grad()
    def prefill(self, batch: Dict[str, torch.Tensor]):
        """Full-prompt forward; returns (last-position logits, cache)."""
        cfg = self.cfg
        if cfg.enc_dec:
            return self._prefill_encdec(batch)
        x, positions, _ = self._embed_inputs(self, batch)
        lead_kind, lead_n, main_kind, main_n = self._layer_kinds()
        caches = {}
        for name, stack, kind in (("lead", "lead_blocks", lead_kind),
                                  ("main", "blocks", main_kind)):
            if stack not in self._modules:
                continue
            per_layer = []
            for p_l in self._modules[stack]:
                x, cache, _ = B.block_forward(p_l, x, positions, cfg, kind)
                per_layer.append(cache)
            caches[name] = _stack(per_layer)
        x = rms_norm(self.final_norm, x)
        logits = self._unembed(self, x[:, -1:])
        return logits[:, 0], caches

    def _prefill_encdec(self, batch):
        cfg = self.cfg
        enc_out = self._encode(self, batch["frontend_embeds"])
        x, positions, _ = self._embed_inputs(self, batch)
        per_layer = []
        for p_l in self.blocks:
            ek, ev = A.cross_kv(p_l["xattn"], enc_out, n_heads=cfg.n_heads,
                                head_dim=cfg.resolved_head_dim)
            x, cache = B.xdec_block_forward(p_l, x, positions, ek, ev, cfg)
            per_layer.append(dict(cache, cross_k=ek, cross_v=ev))
        x = rms_norm(self.final_norm, x)
        logits = self._unembed(self, x[:, -1:])
        return logits[:, 0], {"main": _stack(per_layer)}

    # ----------------------------------------------------------- decode --

    @torch.no_grad()
    def decode_step(self, cache, tokens: torch.Tensor, pos):
        """One new token. tokens (B, 1); cache as returned by ``init_cache``
        or ``prefill`` (padded to the serve length), updated in place.
        ``pos`` is an int or a 0-d integer tensor; a tensor on the model's
        device keeps the step free of host reads. Returns (logits (B,
        vocab), cache)."""
        cfg = self.cfg
        pos = A.as_pos(pos, self.device)
        x = embed(self.embed, tokens.to(self.device), self.dtype)
        if cfg.rope_theta == 0.0:
            # absolute sinusoidal at position `pos` (whisper)
            x = x + sinusoid(pos, cfg.d_model).to(self.dtype)
        lead_kind, lead_n, main_kind, main_n = self._layer_kinds()

        if cfg.enc_dec:
            main = cache["main"]
            for i, p_l in enumerate(self.blocks):
                c_l = {k: v[i] for k, v in main.items()}
                x, _ = B.xdec_block_decode(p_l, x, c_l, c_l["cross_k"],
                                           c_l["cross_v"], pos, cfg)
        else:
            for name, stack, kind in (("lead", "lead_blocks", lead_kind),
                                      ("main", "blocks", main_kind)):
                if stack not in self._modules:
                    continue
                for i, p_l in enumerate(self._modules[stack]):
                    c_l = {k: v[i] for k, v in cache[name].items()}
                    x, _ = B.block_decode(p_l, x, c_l, pos, cfg, kind)

        x = rms_norm(self.final_norm, x)
        logits = self._unembed(self, x)
        return logits[:, 0], cache

    # ------------------------------------------------------ cache specs --

    def _block_cache_spec(self, kind: str, b: int, s: int):
        cfg = self.cfg
        dt = self.dtype
        f32, i32 = torch.float32, torch.int32
        kvh, hd = cfg.n_kv_heads, cfg.resolved_head_dim
        if kind in ("ssm", "hybrid"):
            h = cfg.d_inner // cfg.ssm_head_p
            spec = {"ssm": CacheSpec((b, h, cfg.ssm_head_p, cfg.ssm_state),
                                     f32),
                    "conv": CacheSpec((b, 3, cfg.d_inner + 2 * cfg.ssm_state),
                                      dt)}
            if kind == "ssm":
                return spec
            w = cfg.sliding_window
            return {"k": CacheSpec((b, w, kvh, hd), dt),
                    "v": CacheSpec((b, w, kvh, hd), dt),
                    "pos": CacheSpec((w,), i32), **spec}
        if cfg.mla:
            return {"c_kv": CacheSpec((b, s, cfg.kv_lora_rank), dt),
                    "k_rope": CacheSpec((b, s, cfg.qk_rope_dim), dt)}
        spec = {"k": CacheSpec((b, s, kvh, hd), dt),
                "v": CacheSpec((b, s, kvh, hd), dt)}
        if cfg.enc_dec:
            spec["cross_k"] = CacheSpec((b, s, cfg.n_heads, hd), dt)
            spec["cross_v"] = CacheSpec((b, s, cfg.n_heads, hd), dt)
        return spec

    def init_cache_specs(self, batch_size: int, seq_len: int):
        """{"main": {name: CacheSpec}, "lead": ...} for the decode cache at
        serve length, each stacked on a leading layer axis."""
        lead_kind, lead_n, main_kind, main_n = self._layer_kinds()

        def stack(spec, n):
            return {k: CacheSpec((n,) + sd.shape, sd.dtype)
                    for k, sd in spec.items()}
        out = {"main": stack(self._block_cache_spec(main_kind, batch_size,
                                                    seq_len), main_n)}
        if lead_n:
            out["lead"] = stack(self._block_cache_spec(lead_kind, batch_size,
                                                       seq_len), lead_n)
        return out

    def init_cache(self, batch_size: int, seq_len: int):
        """Zero-initialized cache on the model's device (hybrid 'pos'
        slots = -1)."""
        cache = {group: {k: torch.zeros(sd.shape, dtype=sd.dtype,
                                        device=self.device)
                         for k, sd in spec.items()}
                 for group, spec in self.init_cache_specs(batch_size,
                                                          seq_len).items()}
        if self.cfg.hybrid:
            cache["main"]["pos"].fill_(-1)
        return cache


def _stack(per_layer):
    """Per-layer cache dicts -> one dict of (L, ...) stacks."""
    return {k: torch.stack([c[k] for c in per_layer]) for k in per_layer[0]}


def build_model(cfg: ArchConfig, device="cuda") -> Model:
    return Model(cfg, device=device)
