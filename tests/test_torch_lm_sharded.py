"""The LM stack's sharded serving path in the port, held against the JAX
reference's sharded runs and the port's one-device runs.

Two gloo worlds on the CPU -- 2 ranks (meshes ``(1, 2)`` and ``(2, 1)``)
and 4 ranks (``(2, 2)`` and ``(1, 4)``) -- run in spawned processes started
together by one module fixture, a ``FileStore`` each under the test's tmp
dir, with a process-group timeout and a join deadline. Beside them, one
JAX subprocess with four host devices runs the reference's own sharded
prefill and decode (``jax.jit`` on parameters, batches and caches placed
by its ``param_shardings``, ``batch_shardings`` and ``cache_shardings``, on
a mesh of Auto axes: its vocab-sharded embedding gather does not lower on
Explicit ones). Both packages load the same weights, drawn per leaf with
numpy from a seed.

Families sharded over "model": qwen3, gemma, mistral, starcoder2, pixtral
(its text path, with stub patch embeddings) and granite under all three
MoE dispatches, at ``reduced()`` (H = 4, KV = 2, head_dim 16: at four
"model" ranks a rank holds half a KV head's columns, so attention gathers
whole heads). For each:

- prefill logits and 8 decode steps within 1e-4 of the reference's sharded
  run and of the port's one-device run;
- every rank's logits bitwise equal;
- every rank's cache blocks, put together, within 1e-4 of the one-device
  caches, each block of the shape ``cache_shardings`` gives it.

Layer checks inside the ranks: the vocab-parallel embedding lookup is
bitwise the one-device lookup; routing on gathered router logits equals
one device's at an exact tie; ``gather_tensor`` inverts ``shard_tensor``
bitwise; a sharded ``init_params`` holds the slices of the one-device
draw; ``make_production_mesh`` names the world size it cannot lay out.
The SSM, hybrid, MLA and encoder-decoder families run data-parallel at
``(2, 1)`` here; their tensor parallelism is held in
``test_torch_lm_sharded_blocks.py``.
"""

import dataclasses
import datetime
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)
import torch.multiprocessing as mp

from repro_torch import configs as TC
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.launch.sharding import cache_shardings, local_shape, unshard
from repro_torch.models import build_model, params_from_reference
from repro_torch.models.convert import stack_like_reference
from repro_torch.models.layers.basic import Leaf
from repro_torch.models.model import param_leaves

TOL = 1e-4
B, S, STEPS = 2, 8, 8
PG_TIMEOUT_S = 60
JOIN_TIMEOUT_S = 300
CPU = "cpu"
NAMES = ("data", "model")
REPO = pathlib.Path(__file__).resolve().parent.parent

#: (case id, arch, moe dispatch) of the families sharded over "model"
CASES = [("qwen3", "qwen3_4b", None), ("gemma", "gemma_7b", None),
         ("mistral", "mistral_large_123b", None),
         ("starcoder2", "starcoder2_3b", None),
         ("pixtral", "pixtral_12b", None),
         ("granite-ragged", "granite_moe_3b_a800m", "ragged"),
         ("granite-dense", "granite_moe_3b_a800m", "dense"),
         ("granite-sharded", "granite_moe_3b_a800m", "sharded")]
#: the block families, run here data-parallel only (their tensor
#: parallelism: test_torch_lm_sharded_blocks.py)
DATA_ONLY = [("mamba2", "mamba2_130m"), ("hymba", "hymba_1_5b"),
             ("deepseek", "deepseek_v3_671b"),
             ("whisper", "whisper_medium")]
#: the meshes of each world: {ranks: (model-axis sizes)}
WORLDS = {2: (2, 1), 4: (2, 4)}
MESHES = [(1, 2), (2, 1), (2, 2), (1, 4)]
#: the reference's sharded runs (its compiles dominate the fixture)
REF_RUNS = [(c, (2, 2)) for c, _, _ in CASES] + [
    ("qwen3", (1, 4)), ("granite-sharded", (1, 4)),
    ("granite-sharded", (1, 2))]


def case_cfg(arch, dispatch=None):
    cfg = TC.get(arch).reduced()
    return dataclasses.replace(cfg, moe_dispatch=dispatch) \
        if dispatch else cfg


def numpy_weights(cfg, seed=0):
    """``{port parameter name: float32 array}``: each dense leaf drawn
    N(0, scale^2) by numpy, the rest constant, in ``init_params``'s
    order."""
    rng = np.random.default_rng(seed)
    out = {}

    def walk(tree, prefix):
        for key, sub in tree.items():
            name = prefix + key
            if isinstance(sub, Leaf):
                out[name] = (np.full(sub.shape, sub.fill, np.float32)
                             if sub.scale is None else
                             (sub.scale * rng.standard_normal(sub.shape))
                             .astype(np.float32))
            elif isinstance(sub, list):
                for i, layer in enumerate(sub):
                    walk(layer, f"{name}.{i}.")
            else:
                walk(sub, name + ".")
    walk(param_leaves(cfg), "")
    return out


def reference_tree(cfg, seed=0):
    """The reference's parameter tree of ``numpy_weights``."""
    return stack_like_reference(numpy_weights(cfg, seed))


def inputs(cfg, seed=1):
    """(prompt batch, decode tokens (STEPS, B, 1)) as numpy arrays."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.frontend == "vision":
        batch["frontend_embeds"] = (0.1 * rng.standard_normal(
            (B, cfg.n_frontend_tokens, cfg.d_model))).astype(np.float32)
    if cfg.frontend == "audio":
        batch["frontend_embeds"] = (0.1 * rng.standard_normal(
            (B, S, cfg.d_model))).astype(np.float32)
    steps = rng.integers(0, cfg.vocab, (STEPS, B, 1)).astype(np.int32)
    return batch, steps


def port_run(model, cfg):
    """Prefill and STEPS decode steps from ``init_cache``: (prefill
    logits, prefill cache, [step logits], decode cache)."""
    batch, steps = inputs(cfg)
    logits, cache = model.prefill({k: torch.from_numpy(v)
                                   for k, v in batch.items()})
    dcache = model.init_cache(B, S + STEPS)
    out = []
    for t in range(STEPS):
        lg, dcache = model.decode_step(dcache, torch.from_numpy(steps[t]), t)
        out.append(lg)
    return logits, cache, out, dcache


# ------------------------------------------------------- inside each rank --

def _layer_checks(mesh, out):
    """Embedding, routing at a tie, placement, ``init_params`` slices."""
    from repro_torch.launch.sharding import (P, gather_tensor, param_shardings,
                                             shard_tensor)
    from repro_torch.models import shard_state_dict
    from repro_torch.models.layers import moe as M
    from repro_torch.models.layers.basic import embed
    cfg = case_cfg("qwen3_4b")
    state = params_from_reference(cfg, reference_tree(cfg))
    model = build_model(cfg, device=CPU, mesh=mesh)
    model.load_state_dict(shard_state_dict(cfg, state, mesh))
    tokens = torch.from_numpy(inputs(cfg)[0]["tokens"]).long()
    out["embed_bitwise"] = torch.equal(
        embed(model.embed, tokens, torch.float32, model.shard),
        state["embed.table"][tokens])
    # routing on gathered logits at exact ties: each rank's half of the
    # router's columns is the other's, so every expert ties with a twin
    cfg = case_cfg("granite_moe_3b_a800m", "sharded")
    state = params_from_reference(cfg, reference_tree(cfg))
    router = state["blocks.0.moe.router"]
    half = router.shape[1] // 2
    router[:, half:] = router[:, :half]
    model = build_model(cfg, device=CPU, mesh=mesh)
    model.load_state_dict(shard_state_dict(cfg, state, mesh))
    xt = torch.randn(16, cfg.d_model,
                     generator=torch.Generator().manual_seed(3))
    got = M._route(model.blocks[0].moe, xt, cfg.experts_per_token,
                   model.shard)
    want = M._route({"router": router}, xt, cfg.experts_per_token)
    out["route_tie"] = dict(
        top_e_equal=torch.equal(got[3], want[3]),
        logits_equal=torch.equal(got[0], want[0]),
        ties=bool((got[1][:, :half] == got[1][:, half:]).all()))
    # "sharded" dispatch on a mesh registered by set_shard_mesh, the
    # weights whole on every rank: the rank's tokens through all experts
    p = {k: state[f"blocks.0.moe.{k}"] for k in ("router", "w_in",
                                                 "w_gate", "w_out")}
    x = xt.reshape(2, 8, -1)
    kw = dict(n_experts=cfg.n_experts, top_k=cfg.experts_per_token)
    M.set_shard_mesh(mesh)
    try:
        registered = M.moe(p, x, dispatch="sharded", **kw)[0]
    finally:
        M.set_shard_mesh(None)
    out["registered_mesh"] = torch.equal(
        registered, M.moe(p, x, dispatch="ragged", **kw)[0])
    # placement over the mesh's groups
    t = torch.randn(8, 12, generator=torch.Generator().manual_seed(4))
    out["gather_bitwise"] = all(
        torch.equal(gather_tensor(shard_tensor(t, spec, mesh), spec, mesh), t)
        for spec in (P(None, "model"), P("data", "model"),
                     P(("data", "model"), None), P(None, ("model", "data")),
                     P()))
    # a sharded init draws the whole leaf and keeps the rank's block
    one = build_model(cfg, device=CPU).init_params(
        torch.Generator().manual_seed(5))
    shard = build_model(cfg, device=CPU, mesh=mesh).init_params(
        torch.Generator().manual_seed(5))
    specs = param_shardings(mesh, one.param_specs())
    out["init_slices"] = all(
        torch.equal(p, shard_tensor(dict(one.named_parameters())[n],
                                    specs[n], mesh))
        for n, p in shard.named_parameters())
    out["init_split_leaves"] = sum(
        tuple(p.shape) != tuple(dict(one.named_parameters())[n].shape)
        for n, p in shard.named_parameters())


def _rank_main(rank, world, out_dir):
    import torch.distributed as dist
    from repro_torch.dist import comm
    from repro_torch.ft import ElasticMesh
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import shard_state_dict
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(f"{out_dir}/store", world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    try:
        out = {"runs": {}}
        t0 = time.perf_counter()
        for mp_ in WORLDS[world]:
            mesh = ElasticMesh(mp_, device=CPU).current()
            shape = tuple(mesh.mesh.shape)
            coord = tuple(mesh.get_coordinate())
            cases = [(c, a, d) for c, a, d in CASES] + [
                (c, a, None) for c, a in DATA_ONLY if shape == (2, 1)]
            for case, arch, dispatch in cases:
                cfg = case_cfg(arch, dispatch)
                model = build_model(cfg, device=CPU, mesh=mesh)
                state = params_from_reference(cfg, reference_tree(cfg))
                model.load_state_dict(shard_state_dict(cfg, state, mesh))
                comm.reset_stats()
                logits, cache, steps, dcache = port_run(model, cfg)
                out["runs"][(case, shape)] = dict(
                    coord=coord, logits=logits, steps=steps,
                    cache={g: dict(v) for g, v in cache.items()},
                    dcache={g: dict(v) for g, v in dcache.items()},
                    specs=cache.specs, dspecs=dcache.specs,
                    collectives=comm.STATS["collectives"])
            if shape == (1, 2):
                _layer_checks(mesh, out)
        try:
            make_production_mesh(device=CPU)
        except ValueError as e:
            out["production"] = str(e)
        out["seconds"] = time.perf_counter() - t0
        torch.save(out, f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------- the reference --

_REFERENCE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, sys.argv[1])
import dataclasses, json
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro import configs as RC
from repro.launch.sharding import (batch_shardings, cache_shardings,
                                   param_shardings)
from repro.models import build_model
from repro.models.layers import moe as RM
import test_torch_lm_sharded as T

cases = {c: (a, d) for c, a, d in T.CASES}
out = {}
for case, shape in T.REF_RUNS:
    arch, dispatch = cases[case]
    cfg = RC.get(arch).reduced()
    if dispatch:
        cfg = dataclasses.replace(cfg, moe_dispatch=dispatch)
    n = shape[0] * shape[1]
    mesh = jax.make_mesh(shape, ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:n])
    RM.set_shard_mesh(mesh)
    model = build_model(cfg)
    tree = jax.tree.map(jnp.asarray, T.reference_tree(T.case_cfg(arch,
                                                                 dispatch)))
    params = jax.device_put(tree, param_shardings(mesh, model.param_specs()))
    batch, steps = T.inputs(cfg)
    bspec = batch_shardings(mesh, {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
                                   for k, v in batch.items()})
    batch = {k: jax.device_put(jnp.asarray(v), bspec[k])
             for k, v in batch.items()}
    tspec = batch_shardings(mesh, {"t": jax.ShapeDtypeStruct(
        steps.shape[1:], jnp.int32)})["t"]
    logits, _ = jax.jit(model.prefill)(params, batch)
    cache = jax.device_put(
        model.init_cache(T.B, T.S + T.STEPS),
        cache_shardings(mesh, model.init_cache_specs(T.B, T.S + T.STEPS)))
    decode = jax.jit(model.decode_step)
    key = f"{case}|{shape[0]}x{shape[1]}"
    out[key + "|prefill"] = np.asarray(logits)
    for t in range(T.STEPS):
        lg, cache = decode(params, cache, jax.device_put(
            jnp.asarray(steps[t]), tspec), jnp.int32(t))
        out[f"{key}|step{t}"] = np.asarray(lg)
np.savez(sys.argv[2], **out)
print(json.dumps({"runs": len(T.REF_RUNS)}))
"""


# ------------------------------------------------------------- fixtures --

@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{"ranks": {world size: [rank 0's results, ...]}, "ref": {key: numpy
    logits}}: both gloo worlds and the reference's subprocess, started
    together."""
    dirs = {w: tmp_path_factory.mktemp(f"lm-world{w}") for w in WORLDS}
    ref_out = tmp_path_factory.mktemp("lm-ref") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=f"{REPO / 'src'}:{REPO / 'tests'}")
    ref = subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, str(REPO / "tests"), str(ref_out)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    running = {w: mp.start_processes(_rank_main, args=(w, str(d)), nprocs=w,
                                     join=False, start_method="spawn")
               for w, d in dirs.items()}
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    try:
        while running:
            for w, ctx in list(running.items()):
                if ctx.join(timeout=0.5):
                    del running[w]
            if running and time.monotonic() > deadline:
                raise TimeoutError(f"worlds {sorted(running)} did not finish "
                                   f"in {JOIN_TIMEOUT_S} s")
        _, err = ref.communicate(timeout=max(
            1.0, deadline - time.monotonic()))
    finally:
        for ctx in running.values():
            for p in ctx.processes:
                p.kill()
        if ref.poll() is None:
            ref.kill()
    assert ref.returncode == 0, err[-4000:]
    return dict(ranks={w: [torch.load(d / f"rank{r}.pt", weights_only=False)
                           for r in range(w)] for w, d in dirs.items()},
                ref=dict(np.load(ref_out)))


@pytest.fixture(scope="module")
def one_device():
    """The port's one-device runs of every case ("sharded" runs as
    "ragged": the same function on one device)."""
    out = {}
    for case, arch, dispatch in CASES + [(c, a, None) for c, a in DATA_ONLY]:
        cfg = case_cfg(arch, "ragged" if dispatch == "sharded" else dispatch)
        model = build_model(cfg, device=CPU)
        model.load_state_dict(params_from_reference(cfg, reference_tree(cfg)))
        out[case] = port_run(model, cfg)
    return out


def ranks_of(worlds, shape):
    return worlds["ranks"][shape[0] * shape[1]]


def close(got, want, tol=TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = want.detach().float().numpy() if isinstance(want, torch.Tensor) \
        else np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


# ------------------------------------------------------------- the tests --

@pytest.mark.parametrize("case,shape", REF_RUNS,
                         ids=[f"{c}-{s[0]}x{s[1]}" for c, s in REF_RUNS])
def test_matches_the_reference_sharded_run(worlds, case, shape):
    ref = worlds["ref"]
    key = f"{case}|{shape[0]}x{shape[1]}"
    run = ranks_of(worlds, shape)[0]["runs"][(case, shape)]
    close(run["logits"], ref[key + "|prefill"])
    for t in range(STEPS):
        close(run["steps"][t], ref[f"{key}|step{t}"])


@pytest.mark.parametrize("shape", MESHES,
                         ids=[f"{s[0]}x{s[1]}" for s in MESHES])
@pytest.mark.parametrize("case", [c for c, _, _ in CASES])
def test_matches_one_device_and_ranks_agree(worlds, one_device, case, shape):
    ranks = ranks_of(worlds, shape)
    run = ranks[0]["runs"][(case, shape)]
    logits, _, steps, _ = one_device[case]
    assert run["logits"].shape == (B, logits.shape[1])
    close(run["logits"], logits)
    for got, want in zip(run["steps"], steps):
        close(got, want)
    for other in ranks[1:]:
        r = other["runs"][(case, shape)]
        assert torch.equal(r["logits"], run["logits"])
        assert all(torch.equal(a, b) for a, b in zip(r["steps"],
                                                     run["steps"]))
    if shape[1] > 1:          # one gather or sum per split product at least
        assert run["collectives"] > 0


@pytest.mark.parametrize("shape", MESHES,
                         ids=[f"{s[0]}x{s[1]}" for s in MESHES])
@pytest.mark.parametrize("case", [c for c, _, _ in CASES])
def test_cache_blocks_are_slices_of_one_device(worlds, one_device, case,
                                               shape):
    ranks = ranks_of(worlds, shape)
    mesh = AbstractMesh(shape, NAMES)
    _, cache, _, dcache = one_device[case]
    for which, specs_key, whole in (("cache", "specs", cache),
                                    ("dcache", "dspecs", dcache)):
        specs = ranks[0]["runs"][(case, shape)][specs_key]
        assert specs == cache_shardings(mesh, {
            g: {k: tuple(v.shape) for k, v in leaves.items()}
            for g, leaves in whole.items()})
        for group, leaves in whole.items():
            for name, t in leaves.items():
                blocks = {r["runs"][(case, shape)]["coord"]:
                          r["runs"][(case, shape)][which][group][name]
                          for r in ranks}
                for block in blocks.values():
                    assert tuple(block.shape) == local_shape(
                        t.shape, specs[group][name], mesh)
                close(unshard(blocks, specs[group][name], mesh), t)
    # the serve length divides every "model" size here: S on "model"
    assert specs["main"]["k"][2] == "model"


@pytest.mark.parametrize("case", [c for c, _ in DATA_ONLY])
def test_block_families_run_data_parallel(worlds, one_device, case):
    ranks = worlds["ranks"][2]
    run = ranks[0]["runs"][(case, (2, 1))]
    logits, _, steps, dcache = one_device[case]
    close(run["logits"], logits)
    for got, want in zip(run["steps"], steps):
        close(got, want)
    assert torch.equal(ranks[1]["runs"][(case, (2, 1))]["logits"],
                       run["logits"])
    mesh = AbstractMesh((2, 1), NAMES)
    for group, leaves in dcache.items():
        for name, t in leaves.items():
            spec = run["dspecs"][group][name]
            close(unshard({r["runs"][(case, (2, 1))]["coord"]:
                           r["runs"][(case, (2, 1))]["dcache"][group][name]
                           for r in ranks}, spec, mesh), t)


def test_vocab_parallel_embed_is_bitwise(worlds):
    assert all(r["embed_bitwise"] for r in worlds["ranks"][2])


def test_routing_on_gathered_logits_at_a_tie(worlds):
    for r in worlds["ranks"][2]:
        tie = r["route_tie"]
        assert tie["ties"] and tie["logits_equal"] and tie["top_e_equal"]


def test_sharded_dispatch_on_a_registered_mesh(worlds):
    assert all(r["registered_mesh"] for r in worlds["ranks"][2])


def test_gather_tensor_inverts_shard_tensor(worlds):
    assert all(r["gather_bitwise"] for r in worlds["ranks"][2])


def test_sharded_init_holds_the_one_device_slices(worlds):
    for r in worlds["ranks"][2]:
        assert r["init_slices"] and r["init_split_leaves"] > 0


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_production_mesh_names_the_world_size(worlds, world):
    msg = worlds["ranks"][world][0]["production"]
    assert f"this world has {world}" in msg and "(16, 16)" in msg

