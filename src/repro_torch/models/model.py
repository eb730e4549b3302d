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

On a mesh (``build_model(cfg, device, mesh=...)``, a ``DeviceMesh`` with
axes ("data", "model")), the model allocates only this rank's blocks of the
parameters, as ``repro_torch.launch.sharding.param_shardings`` places
them, and serves with the same API: every rank passes the same whole
batch, keeps its rows of it (``batch_shardings``: B over the data axes when
divisible, else replicated), runs tensor-parallel attention, MLP and MoE
over "model" (``layers.parallel``) and returns the whole logits, gathered
over the data axes. Caches are this rank's blocks (``cache_shardings``:
B on data, the sequence on "model"; the SSM state on its heads or head
columns, the conv state whole) in a ``ShardedCache``, which records their
layout for ``decode_step``. Every family runs over "model": attention, MLP
and MoE (dense, vlm, granite), the SSM and hybrid blocks (mamba2, hymba:
the scan on the rank's block of the state, the sliding-window ring split
along its slots), MLA (deepseek: the rank's heads, the latent cache split
along the sequence, the MTP head row-parallel) and the encoder-decoder
(whisper: the encoder and both attentions on the rank's heads, the cross
caches split along the encoder sequence). Where one split does not line
up with the next, the layers gather whole activations and keep the weights
split (but for MLA's absorbed decode when its heads do not divide the
axis, which gathers ``w_uk`` and ``w_uv``).

Training on a mesh (``forward_train``) computes the loss of the global
batch on every rank: the rank's rows go through the tensor-parallel layers,
whose collectives carry gradients (``layers.parallel``), and the loss's
sums and the MoE aux losses' sums are added over the ranks that split the
rows (``Rows``), in rank order. The train step then sums each parameter's
gradient over those ranks. ``mode="fsdp"`` holds ZeRO-3 shards (the rules'
``_fsdp_pspec``) and runs every family without tensor parallelism: the
batch's rows split over every axis, each layer's shards gathered whole
inside the layer's remat block (the cast copy, so the gathered weight dies
with the layer), their gradient reduce-scattered in rank order on the way
back. It serves the same way, every leaf gathered for the call.

Batch dict contract (all optional keys per family):
  tokens   (B, S)  int          text tokens (decoder tokens for enc-dec)
  labels   (B, S)  int          next-token labels, -1 = masked
  frontend_embeds (B, T, d)     vlm: patch embeddings (prepended);
                                audio: encoder frame embeddings
Decode: tokens (B, 1), pos an int or a 0-d integer tensor, plus the cache.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, NamedTuple, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core.graph import resolve_device
from repro_torch.dist import comm
from repro_torch.launch.mesh import axes_group
from repro_torch.launch.sharding import (P, batch_shardings, cache_shardings,
                                         gather_tensor, local_shape,
                                         param_shardings, shard_tensor)
from repro_torch.models import blocks as B
from repro_torch.models.layers import attention as A
from repro_torch.models.layers.basic import (Leaf, const, dense, dense_init,
                                             embed, init_embedding, rms_norm,
                                             unembed)
from repro_torch.models.layers.parallel import (Rows, Shard,
                                                row_parallel)

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


def _xent(logits: torch.Tensor, labels: torch.Tensor, rows=None):
    """Masked mean cross-entropy; labels -1 are ignored. logits f32.
    Returns (loss, number of unmasked labels). With ``rows`` (this rank's
    rows are one share of the batch) the sum and the count are the global
    batch's, added over the ranks (the sum in rank order, its backward the
    identity): the mean of per-rank means would weigh each rank's labels
    by its own count."""
    mask = labels >= 0
    safe = labels.clamp_min(0).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = torch.where(mask, logz - gold, 0.0)
    total, count = nll.sum(), mask.sum()
    if rows is not None:
        total, count = rows.sum(total), rows.count(count)
    denom = count.clamp_min(1)
    return total / denom, denom


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


#: a parameter's global shape and storage dtype (``Model.param_specs``)
ParamSpec = CacheSpec


class ShardedCache(dict):
    """A decode cache of a model on a mesh: ``{group: {name: this rank's
    block}}`` as a dict, plus ``specs``, the ``cache_shardings`` of the
    whole cache, which say how the blocks split it."""

    def __init__(self, groups, specs):
        super().__init__(groups)
        self.specs = specs


class _Specs:
    """Per-parameter partition specs of a module (empty off a mesh)."""

    def spec(self, key: str):
        """The ``P`` this module's parameter ``key`` is placed by, or None
        (a model on one device)."""
        return self._specs.get(key)


class _SpecDict(_Specs, dict):
    """A dict of one module's tensors that answers ``spec`` as the module
    does, so a layer reads a split of the tensors a step computes with."""

    def __init__(self, items, specs):
        super().__init__(items)
        self._specs = specs


def _with_specs(tree, module):
    """``param_tree``'s nested dicts of ``module``'s tensors as
    ``_SpecDict``s carrying the module's (and each submodule's) specs."""
    out = {}
    for key, sub in tree.items():
        if isinstance(sub, list):
            out[key] = [_with_specs(t, m) for t, m in zip(sub, module[key])]
        elif isinstance(sub, Mapping):
            out[key] = _with_specs(sub, module[key])
        else:
            out[key] = sub
    return _SpecDict(out, module._specs)


class ParamTree(_Specs, nn.Module):
    """A nested mapping of parameters built from a spec: a dict of
    ``Leaf``s, sub-dicts and lists of sub-dicts (per-layer stacks).
    ``p["attn"]["wq"]`` and ``"w_gate" in p`` read it as the reference's
    layer functions read a params dict."""

    def __init__(self, spec, dtype, device, prefix, leaves, place):
        super().__init__()
        _register(self, spec, dtype, device, prefix, leaves, place)

    def __getitem__(self, key):
        return getattr(self, key)

    def __contains__(self, key) -> bool:
        return key in self._parameters or key in self._modules


def _register(module: nn.Module, spec, dtype, device, prefix, leaves,
              place):
    """Add ``spec``'s parameters and subtrees to ``module``; record each
    parameter's ``Leaf`` under its dotted name in ``leaves``. ``place``
    maps a name to its ``(P, local shape)`` on the model's mesh, or is None
    on one device."""
    module._specs = {}
    for key, sub in spec.items():
        name = prefix + key
        if isinstance(sub, Leaf):
            shape = sub.shape
            if place is not None:
                module._specs[key], shape = place(name)
            t = torch.empty(shape, dtype=storage_dtype(name, dtype),
                            device=device)
            module.register_parameter(key, nn.Parameter(t,
                                                        requires_grad=False))
            leaves[name] = sub
        elif isinstance(sub, list):
            module.add_module(key, nn.ModuleList(
                ParamTree(s, dtype, device, f"{name}.{i}.", leaves, place)
                for i, s in enumerate(sub)))
        else:
            module.add_module(key, ParamTree(sub, dtype, device, name + ".",
                                             leaves, place))


def layer_kinds(cfg: ArchConfig) -> Tuple[str, int, str, int]:
    """(lead_kind, lead_n, main_kind, main_n)."""
    if cfg.ssm:
        return ("ssm", 0, "ssm", cfg.n_layers)
    if cfg.hybrid:
        return ("hybrid", 0, "hybrid", cfg.n_layers)
    if cfg.n_experts > 0:
        return ("dense", cfg.n_dense_layers, "moe",
                cfg.n_layers - cfg.n_dense_layers)
    return ("dense", 0, "dense", cfg.n_layers)


def param_leaves(cfg: ArchConfig) -> Dict[str, Any]:
    """The reference's parameter tree as ``Leaf`` specs, with each stacked
    block tree as a list of per-layer trees."""
    p: Dict[str, Any] = {"embed": init_embedding(cfg.padded_vocab,
                                                 cfg.d_model),
                         "final_norm": const((cfg.d_model,), 1.0)}
    lead_kind, lead_n, main_kind, main_n = layer_kinds(cfg)
    if cfg.enc_dec:
        p["enc_blocks"] = [B.init_enc_block(cfg)
                           for _ in range(cfg.n_enc_layers)]
        p["enc_norm"] = const((cfg.d_model,), 1.0)
        p["blocks"] = [B.init_xdec_block(cfg) for _ in range(cfg.n_layers)]
    else:
        if lead_n:
            p["lead_blocks"] = [B.init_block(cfg, lead_kind)
                                for _ in range(lead_n)]
        p["blocks"] = [B.init_block(cfg, main_kind) for _ in range(main_n)]
    if not cfg.tie_embeddings:
        p["lm_head"] = {"table": dense((cfg.padded_vocab, cfg.d_model))}
    if cfg.mtp:
        p["mtp"] = {"proj": dense((2 * cfg.d_model, cfg.d_model)),
                    "block": B.init_block(cfg, "dense"),
                    "norm": const((cfg.d_model,), 1.0)}
    return p


def param_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    """``{parameter name: ParamSpec(global shape, storage dtype)}`` of
    ``Model(cfg)``, in ``init_params``'s draw order, nothing allocated (the
    twin of the reference's ``Model.param_specs``, under the port's
    per-layer names)."""
    out: Dict[str, ParamSpec] = {}

    def walk(tree, prefix):
        for key, sub in tree.items():
            name = prefix + key
            if isinstance(sub, Leaf):
                out[name] = ParamSpec(sub.shape,
                                      storage_dtype(name, model_dtype(cfg)))
            elif isinstance(sub, list):
                for i, layer in enumerate(sub):
                    walk(layer, f"{name}.{i}.")
            else:
                walk(sub, name + ".")
    walk(param_leaves(cfg), "")
    return out


def _module_spec(module: nn.Module, name: str):
    """The ``P`` of parameter ``name`` (dotted) of ``module``, or None."""
    *path, leaf = name.split(".")
    for part in path:
        module = module._modules[part]
    return module.spec(leaf)


class Model(_Specs, nn.Module):
    """Family-polymorphic model bound to an ArchConfig, on ``device`` (the
    GPU unless the caller passes ``device="cpu"``). Parameters are
    allocated uninitialized; ``init_params`` fills them from a generator,
    or ``load_state_dict(params_from_reference(cfg, tree))`` carries the
    reference's (``shard_state_dict`` of it on a mesh).

    ``mesh``: a ``DeviceMesh`` with axes ("data", "model") (``ElasticMesh``
    builds one) to hold, serve and train this rank's shards, placed by
    ``param_shardings(mesh, ..., mode)``: ``mode="tp"`` (tensor-parallel
    over "model", batch over "data") or ``mode="fsdp"`` (ZeRO-3 shards over
    both axes, batch over both, no tensor parallelism)."""

    def __init__(self, cfg: ArchConfig, device="cuda", mesh=None,
                 mode: str = "tp"):
        super().__init__()
        if mode not in ("tp", "fsdp"):
            raise ValueError(f"mode must be 'tp' or 'fsdp', got {mode!r}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = model_dtype(cfg)
        self.mesh = mesh
        self.mode = mode
        self.shard = None
        self.zero3 = None       # (size, group) of the ZeRO-3 shards
        place = None
        if mesh is not None:
            shapes = param_specs(cfg)
            pspecs = param_shardings(mesh, shapes, mode)

            def place(name):
                return pspecs[name], local_shape(shapes[name].shape,
                                                 pspecs[name], mesh)
            if mode == "tp":
                self.shard = Shard.of(mesh)
            else:   # the layers compute whole: a "model" axis of one rank
                self.shard = Shard(mp=1, rank=0, group=None)
                self.zero3 = axes_group(mesh, ("data", "model"))
        self._leaves: Dict[str, Leaf] = {}
        _register(self, param_leaves(cfg), self.dtype, self.device, "",
                  self._leaves, place)

    def __getitem__(self, key):
        """``model["blocks"]`` reads the model as ``param_tree`` reads a
        flat mapping, so one set of helpers serves both."""
        return getattr(self, key)

    def __contains__(self, key) -> bool:
        return key in self._parameters or key in self._modules

    # ------------------------------------------------------------- init --

    def _layer_kinds(self) -> Tuple[str, int, str, int]:
        """(lead_kind, lead_n, main_kind, main_n)."""
        return layer_kinds(self.cfg)

    def param_specs(self) -> Dict[str, ParamSpec]:
        """Every parameter's global shape and storage dtype, nothing
        allocated (``param_specs(cfg)``)."""
        return param_specs(self.cfg)

    def spec_of(self, name: str):
        """The ``P`` that parameter ``name`` (dotted) is placed by on the
        model's mesh, or None on one device."""
        return _module_spec(self, name)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "Model":
        """Fill every parameter: dense weights drawn N(0, scale^2) in
        float32 on the generator's device (then cast and moved to the
        model's), the rest constant. On a mesh each whole leaf is drawn,
        in the same order, and this rank keeps its block, so the shards
        are those of the one-device model of the same generator. Returns
        the model."""
        params = dict(self.named_parameters())
        for name, leaf in self._leaves.items():
            if leaf.scale is None:
                params[name].fill_(leaf.fill)
                continue
            full = dense_init(generator, leaf.shape, leaf.scale)
            spec = self.spec_of(name)
            if spec:
                full = shard_tensor(full, spec, self.mesh)
            params[name].copy_(full)
        return self

    # ------------------------------------------------------------- mesh --

    def _batch_spec(self, shape) -> P:
        return batch_shardings(self.mesh, {"x": tuple(shape)},
                               self.mode)["x"]

    def rows(self, b: int):
        """The ``Rows`` that a batch of ``b`` rows is split over on this
        model's mesh (``batch_shardings``), or None: no mesh, or the batch
        replicated (``b`` does not divide), when every rank holds every
        row."""
        if self.mesh is None:
            return None
        first = self._batch_spec((b,))[0]
        axes = () if first is None else \
            ((first,) if isinstance(first, str) else tuple(first))
        size, group = axes_group(self.mesh, axes)
        return Rows(size, group, axes) if size > 1 else None

    def _whole(self, tree, module, rows):
        """``tree`` (nested dicts of ``module``'s parameters as computed
        with: the rank's ZeRO-3 shards) with every split leaf gathered
        whole. The gather's backward gives the rank its slice of the
        rank-order sum of the ranks' gradients when they hold different
        rows (a reduce-scatter), of its own gradient otherwise. Off ZeRO-3
        ``tree`` itself."""
        if self.zero3 is None or self.zero3[0] == 1:
            return tree
        out = {}
        for key, sub in tree.items():
            if isinstance(sub, Mapping):
                out[key] = self._whole(sub, module[key], rows)
                continue
            spec = module.spec(key) or ()
            dims = [d for d, e in enumerate(spec) if e is not None]
            out[key] = sub if not dims else comm.all_gather_cat(
                sub, dims[0], self.zero3[1],
                grad="slice" if rows is None else "sum")
        return out

    def _rows(self, t):
        """This rank's rows of a whole-batch tensor (``batch_shardings``)."""
        if self.mesh is None or t is None:
            return t
        return shard_tensor(t, self._batch_spec(t.shape), self.mesh)

    def _all_rows(self, t: torch.Tensor, b: int) -> torch.Tensor:
        """The whole batch (of ``b`` rows) from this rank's rows of it."""
        if self.mesh is None:
            return t
        return gather_tensor(t, self._batch_spec((b,) + tuple(t.shape[1:])),
                             self.mesh)

    def _shard_cache(self, caches, b: int):
        """Per-layer-stacked caches with this rank's batch rows and every
        other dimension whole -> ``ShardedCache`` of this rank's blocks."""
        if self.mesh is None:
            return caches
        specs = self._cache_place({
            g: {k: tuple(t.shape) if k == "pos"
                else (t.shape[0], b) + tuple(t.shape[2:])
                for k, t in leaves.items()}
            for g, leaves in caches.items()})
        split = self.shard is not None and self.shard.mp > 1
        out = {}
        for g, leaves in caches.items():
            out[g] = {}
            for k, t in leaves.items():
                model_only = P(*(e if e == "model" else None
                                 for e in specs[g][k]))
                out[g][k] = shard_tensor(t, model_only, self.mesh) \
                    if "model" in model_only and split else t
        return ShardedCache(out, specs)

    def _cache_place(self, shapes):
        """The specs ``{group: {name: P}}`` of a cache of global ``shapes``
        on the mesh: ``cache_shardings`` (B on data, the sequence on
        "model"), or under ZeRO-3 the batch's rows only (B as
        ``batch_shardings(mode="fsdp")`` splits it)."""
        if self.mode == "tp":
            return cache_shardings(self.mesh, shapes)

        def rule(k, shape):
            shape = tuple(getattr(shape, "shape", shape))
            if k == "pos" or len(shape) <= 1:
                return P()
            return P(None, self._batch_spec((shape[1],))[0],
                     *([None] * (len(shape) - 2)))
        return {g: {k: rule(k, v) for k, v in leaves.items()}
                for g, leaves in shapes.items()}

    def _decode_shard(self, cache, group: str, key: str = None):
        """The layers' ``Shard`` for decoding ``cache[group]``: whether the
        sequence of its leaf ``key`` (by default the attention cache's,
        ``k`` or ``c_kv``) is split over "model" comes from the cache's
        specs."""
        if self.shard is None or self.shard.mp == 1:
            return self.shard
        if not isinstance(cache, ShardedCache):
            raise TypeError("a model sharded over 'model' decodes from a "
                            "ShardedCache (its init_cache or prefill)")
        specs = cache.specs[group]
        spec = specs.get(key or ("c_kv" if "c_kv" in specs else "k"))
        return dataclasses.replace(self.shard, seq=bool(spec)
                                   and spec[2] == "model")

    # ------------------------------------------------------- embeddings --

    def _embed_inputs(self, p, batch: Dict[str, torch.Tensor]):
        """Returns (x (B,S,d), positions (B,S), labels-or-None) of this
        rank's rows; for the vision frontend the labels are padded with -1
        over the patches."""
        cfg = self.cfg
        x = embed(p["embed"], self._rows(batch["tokens"].to(self.device)),
                  self.dtype, self.shard)
        labels = self._rows(batch.get("labels"))
        if labels is not None:
            labels = labels.to(self.device)
        if cfg.frontend == "vision" and "frontend_embeds" in batch:
            fe = self._rows(batch["frontend_embeds"].to(self.device,
                                                        self.dtype))
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
        return unembed(head, x, self.shard)

    def _top(self, p, rows):
        """The parameters outside the block stacks (and the MTP head), the
        ZeRO-3 shards gathered whole: the tied table once for both uses."""
        top = {k: v for k, v in p.items() if k not in STACKS + ("mtp",)}
        return dict(p, **self._whole(top, self, rows))

    # ----------------------------------------------------------- encode --

    def _encode(self, p, frames: torch.Tensor,
                whole=lambda p_l, module: p_l) -> torch.Tensor:
        """Whisper encoder over stub frame embeddings (B, S_enc, d);
        ``whole(p_l, module)`` gives a layer's parameters to compute with
        (training gathers ZeRO-3 shards there)."""
        x = frames.to(self.device, self.dtype)
        s = x.shape[1]
        positions = torch.arange(s, dtype=torch.int32,
                                 device=self.device).expand(x.shape[0], s)
        x = x + sinusoid(positions, self.cfg.d_model).to(self.dtype)
        for i, p_l in enumerate(p["enc_blocks"]):
            x = B.enc_block_forward(whole(p_l, self.enc_blocks[i]), x,
                                    positions, self.cfg, sh=self.shard)
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
        block is recomputed in the backward pass.

        On a mesh every rank passes the whole batch and computes the loss
        of the whole batch from its rows (see the module docstring); the
        parameters are the rank's shards, and so are their gradients,
        which are partial over the ranks that split the rows
        (``rows``): the train step sums them."""
        cfg = self.cfg
        rows = self.rows(batch["tokens"].shape[0])
        p = param_tree(params)
        if self.shard is not None:
            p = _with_specs(p, self)
        p = self._top(p, rows)
        if cfg.enc_dec:
            return self._forward_train_encdec(p, batch, rows, remat=remat)
        x, positions, labels = self._embed_inputs(p, batch)
        lead_kind, lead_n, main_kind, main_n = self._layer_kinds()
        lb_loss = z_loss = torch.zeros((), dtype=torch.float32,
                                       device=self.device)
        for stack, kind in (("lead_blocks", lead_kind), ("blocks", main_kind)):
            for i, p_l in enumerate(p.get(stack, ())):
                def block(p_l, x, kind=kind, module=self._modules[stack][i]):
                    p_l = self._whole(p_l, module, rows)
                    x, _, (l1, l2) = B.block_forward(
                        p_l, x, positions, cfg, kind, sh=self.shard,
                        rows=rows, keep_cache=False)
                    return x, l1, l2
                x, l1, l2 = _remat(block, remat, p_l, x)
                lb_loss, z_loss = lb_loss + l1, z_loss + l2
        x = rms_norm(p["final_norm"], x)
        logits = self._unembed(p, x)
        loss, n_tok = _xent(logits, labels, rows)
        metrics = {"xent": loss, "n_tokens": n_tok}
        total = loss
        if cfg.n_experts:
            metrics["lb_loss"] = lb_loss / main_n
            metrics["z_loss"] = z_loss / main_n
            total = total + 0.01 * metrics["lb_loss"] \
                + 1e-3 * metrics["z_loss"]
        if cfg.mtp:
            mtp_loss = self._mtp_loss(p, x, batch, positions, rows)
            metrics["mtp_loss"] = mtp_loss
            total = total + 0.3 * mtp_loss
        metrics["loss"] = total
        return total, metrics

    def _mtp_loss(self, p, h, batch, positions, rows=None):
        """DeepSeek-V3 multi-token prediction (depth 1): predict t+2 from
        [h_t ; emb(tok_{t+1})]."""
        cfg = self.cfg
        tokens = self._rows(batch["tokens"].to(self.device))
        labels = self._rows(batch["labels"].to(self.device))
        mtp = self._whole(p["mtp"], self.mtp, rows)
        emb_next = embed(p["embed"], torch.roll(tokens, -1, dims=1),
                         self.dtype, self.shard)
        z = torch.cat([h.to(self.dtype), emb_next], dim=-1)
        z = row_parallel(mtp, "proj", z, self.shard)
        z, _, _ = B.block_forward(mtp["block"], z, positions, cfg, "dense",
                                  sh=self.shard, rows=rows, keep_cache=False)
        z = rms_norm(mtp["norm"], z)
        logits = self._unembed(p, z)
        mtp_labels = torch.roll(labels, -1, dims=1)
        mtp_labels[:, -2:] = -1
        loss, _ = _xent(logits, mtp_labels, rows)
        return loss

    def _forward_train_encdec(self, p, batch, rows, *, remat: bool = True):
        cfg = self.cfg
        enc_out = self._encode(p, self._rows(batch["frontend_embeds"]),
                               lambda p_l, m: self._whole(p_l, m, rows))
        x, positions, labels = self._embed_inputs(p, batch)

        for i, p_l in enumerate(p["blocks"]):
            def block(p_l, x, module=self.blocks[i]):
                p_l = self._whole(p_l, module, rows)
                ek, ev = A.cross_kv(p_l["xattn"], enc_out,
                                    n_heads=cfg.n_heads,
                                    head_dim=cfg.resolved_head_dim,
                                    sh=self.shard)
                out, _ = B.xdec_block_forward(p_l, x, positions, ek, ev, cfg,
                                              sh=self.shard, keep_cache=False)
                return out
            x = _remat(block, remat, p_l, x)
        x = rms_norm(p["final_norm"], x)
        logits = self._unembed(p, x)
        loss, n_tok = _xent(logits, labels, rows)
        return loss, {"xent": loss, "loss": loss, "n_tokens": n_tok}

    # ---------------------------------------------------------- prefill --

    def _served(self):
        """The parameters to serve with: the model itself, or on ZeRO-3
        shards over more than one rank a tree of every leaf gathered whole
        for the call."""
        if self.zero3 is None or self.zero3[0] == 1:
            return self
        return param_tree({
            n: gather_tensor(t, self.spec_of(n) or P(), self.mesh)
            for n, t in self.named_parameters()})

    @torch.no_grad()
    def prefill(self, batch: Dict[str, torch.Tensor]):
        """Full-prompt forward; returns (last-position logits, cache). On a
        mesh: the whole batch's logits and this rank's cache blocks."""
        cfg = self.cfg
        b = batch["tokens"].shape[0]
        p = self._served()
        if cfg.enc_dec:
            return self._prefill_encdec(p, batch, b)
        x, positions, _ = self._embed_inputs(p, batch)
        lead_kind, lead_n, main_kind, main_n = self._layer_kinds()
        caches = {}
        for name, stack, kind in (("lead", "lead_blocks", lead_kind),
                                  ("main", "blocks", main_kind)):
            if stack not in p:
                continue
            per_layer = []
            for p_l in p[stack]:
                x, cache, _ = B.block_forward(p_l, x, positions, cfg, kind,
                                              sh=self.shard)
                per_layer.append(cache)
            caches[name] = _stack(per_layer)
        x = rms_norm(p["final_norm"], x)
        logits = self._unembed(p, x[:, -1:])
        return (self._all_rows(logits[:, 0], b),
                self._shard_cache(caches, b))

    def _prefill_encdec(self, p, batch, b):
        cfg = self.cfg
        enc_out = self._encode(p, self._rows(batch["frontend_embeds"]))
        x, positions, _ = self._embed_inputs(p, batch)
        per_layer = []
        for p_l in p["blocks"]:
            ek, ev = A.cross_kv(p_l["xattn"], enc_out, n_heads=cfg.n_heads,
                                head_dim=cfg.resolved_head_dim, sh=self.shard)
            x, cache = B.xdec_block_forward(p_l, x, positions, ek, ev, cfg,
                                            sh=self.shard)
            ek, ev = A.cross_heads(p_l["xattn"], ek, ev, n_heads=cfg.n_heads,
                                   sh=self.shard)
            per_layer.append(dict(cache, cross_k=ek, cross_v=ev))
        x = rms_norm(p["final_norm"], x)
        logits = self._unembed(p, x[:, -1:])
        return (self._all_rows(logits[:, 0], b),
                self._shard_cache({"main": _stack(per_layer)}, b))

    # ----------------------------------------------------------- decode --

    @torch.no_grad()
    def decode_step(self, cache, tokens: torch.Tensor, pos):
        """One new token. tokens (B, 1); cache as returned by ``init_cache``
        or ``prefill`` (padded to the serve length), updated in place.
        ``pos`` is an int or a 0-d integer tensor; a tensor on the model's
        device keeps the step free of host reads. Returns (logits (B,
        vocab), cache). On a mesh ``tokens`` is the whole batch, the logits
        are the whole batch's and ``cache`` holds this rank's blocks."""
        cfg = self.cfg
        b = tokens.shape[0]
        pos = A.as_pos(pos, self.device)
        p = self._served()
        x = embed(p["embed"], self._rows(tokens.to(self.device)), self.dtype,
                  self.shard)
        if cfg.rope_theta == 0.0:
            # absolute sinusoidal at position `pos` (whisper)
            x = x + sinusoid(pos, cfg.d_model).to(self.dtype)
        lead_kind, lead_n, main_kind, main_n = self._layer_kinds()

        if cfg.enc_dec:
            sh = self._decode_shard(cache, "main")
            xsh = self._decode_shard(cache, "main", "cross_k")
            for i, p_l in enumerate(p["blocks"]):
                c_l = {k: v[i] for k, v in cache["main"].items()}
                x, _ = B.xdec_block_decode(p_l, x, c_l, c_l["cross_k"],
                                           c_l["cross_v"], pos, cfg, sh, xsh)
        else:
            for name, stack, kind in (("lead", "lead_blocks", lead_kind),
                                      ("main", "blocks", main_kind)):
                if stack not in p:
                    continue
                sh = self._decode_shard(cache, name)
                for i, p_l in enumerate(p[stack]):
                    c_l = {k: v[i] for k, v in cache[name].items()}
                    x, _ = B.block_decode(p_l, x, c_l, pos, cfg, kind, sh)

        x = rms_norm(p["final_norm"], x)
        logits = self._unembed(p, x)
        return self._all_rows(logits[:, 0], b), cache

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
        serve length, each stacked on a leading layer axis (global shapes
        on a mesh too)."""
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
        slots = -1); on a mesh a ``ShardedCache`` of this rank's blocks."""
        specs = self.init_cache_specs(batch_size, seq_len)
        place = None if self.mesh is None else self._cache_place(specs)
        cache = {group: {k: torch.zeros(
            sd.shape if place is None
            else local_shape(sd.shape, place[group][k], self.mesh),
            dtype=sd.dtype, device=self.device) for k, sd in spec.items()}
            for group, spec in specs.items()}
        if self.cfg.hybrid:
            cache["main"]["pos"].fill_(-1)
        return cache if place is None else ShardedCache(cache, place)


def _stack(per_layer):
    """Per-layer cache dicts -> one dict of (L, ...) stacks."""
    return {k: torch.stack([c[k] for c in per_layer]) for k in per_layer[0]}


def build_model(cfg: ArchConfig, device="cuda", mesh=None,
                mode: str = "tp") -> Model:
    """``Model(cfg)`` on ``device``; on ``mesh`` it holds this rank's
    shards only (see ``Model``)."""
    return Model(cfg, device=device, mesh=mesh, mode=mode)
