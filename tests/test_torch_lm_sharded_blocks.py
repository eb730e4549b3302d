"""Tensor parallelism of the SSM, hybrid, MLA and encoder-decoder blocks in
the port, serving and training, held against the JAX reference's sharded
runs and the port's one-device runs.

Two gloo worlds on the CPU -- 2 ranks (meshes ``(1, 2)`` and ``(2, 1)``)
and 4 ranks (``(2, 2)`` and ``(1, 4)``) -- run in spawned processes started
together by one module fixture, a ``FileStore`` each under the test's tmp
dir, with a process-group timeout and a join deadline. Beside them one JAX
subprocess with four host devices runs the reference's own sharded
prefill, decode and ``"tp"`` train steps under ``jax.jit``, everything
placed by its sharding rules, on meshes of Auto axes. Both packages load
the same weights, drawn per leaf with numpy from a seed.

Cases, at ``reduced()``: mamba2 (the ``w_in`` cut falls inside a group),
hymba (parallel attention and SSM heads, the sliding-window ring), deepseek
(MLA, a dense lead-in layer, MoE, the MTP head in training), whisper (the
encoder, self- and cross-attention), ``hymba-p``: hymba at d_model 80,
whose five SSM heads divide no "model" axis, so the state splits on its
head columns P and ``w_out``'s row blocks cut across heads, and
``deepseek-h3``: MLA with three heads, whose split ``w_uq``/``w_uk``/
``w_uv`` columns cut across heads, so every rank computes every head. For
each, on every mesh:

- prefill logits and 8 decode steps within 1e-4 of one device (and of the
  reference's sharded run where it ran); every rank's logits bitwise equal;
  every rank's cache blocks, put together, within 1e-4 of one device's
  caches, each block of the shape ``cache_shardings`` gives it;
- 3 ``"tp"`` train steps: metrics within 1e-5, step 0's gradients and the
  masters and moments after within 1e-4 of each leaf's largest magnitude
  (of one device, and of the reference's sharded step where it ran); every
  rank's metrics and every block two ranks both hold bitwise equal.

Extra cases: hymba decoded 40 steps, past its ring of W = 32 slots split
over "model"; whisper prefilled with frontend embeddings, its decode
reading the prefill's cross caches split along the encoder sequence;
``repro_torch.launch.train --model-parallel 2 --sharding tp`` on mamba2
against the launcher on one device. Last, the sharded bf16 MoE drift of
Granite at ``reduced()``: the port's prefill over "model" against one
device, as a share of the largest logit, within twice the reference's own
drift at the same size, for the "ragged" and "sharded" dispatches at
``(1, 2)`` and ``(1, 4)``.
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
from repro_torch.launch.sharding import (_block_index, cache_shardings,
                                         local_shape, param_shardings,
                                         unshard)
from repro_torch.models import (build_model, param_specs,
                                params_from_reference)
from test_torch_lm_sharded import close, reference_tree
from test_torch_lm_sharded_train import (_rank_run, check_run, port_run as
                                         train_run)

TOL = 1e-4
B, S, STEPS = 2, 8, 8
SE = S + STEPS               # whisper's encoder frames in the prefilled case
RING_STEPS = 40              # past the reduced window, W = 32
PG_TIMEOUT_S = 60
JOIN_TIMEOUT_S = 400
CPU = "cpu"
NAMES = ("data", "model")
REPO = pathlib.Path(__file__).resolve().parent.parent

#: (case id, arch) of the block families
CASES = [("mamba2", "mamba2_130m"), ("hymba", "hymba_1_5b"),
         ("deepseek", "deepseek_v3_671b"), ("whisper", "whisper_medium"),
         ("hymba-p", "hymba_1_5b"), ("deepseek-h3", "deepseek_v3_671b")]
IDS = [c for c, _ in CASES]
#: the meshes of each world: {ranks: (model-axis sizes)}
WORLDS = {2: (2, 1), 4: (2, 4)}
MESHES = [(1, 2), (2, 1), (2, 2), (1, 4)]
SPLIT = [m for m in MESHES if m[1] > 1]
#: the reference's sharded runs: serving, and "tp" train steps
REF_SERVE = [(c, m) for c in IDS[:4] for m in ((2, 2), (1, 4))] + [
    ("hymba-p", (1, 2))]
REF_TRAIN = [(c, (2, 2)) for c in IDS[:4]]
#: Granite's sharded bf16 drift: (dispatch, mesh)
DRIFT = [(d, m) for d in ("ragged", "sharded") for m in ((1, 2), (1, 4))]
LAUNCH = ["--arch", "mamba2_130m", "--reduced", "--steps", "3", "--batch",
          "4", "--seq", "16", "--device", CPU, "--log-every", "100"]


def case_cfg(case, configs=TC):
    """The config of a case (from ``configs``, either package's)."""
    cfg = configs.get(dict(CASES)[case]).reduced()
    if case == "hymba-p":
        return dataclasses.replace(cfg, d_model=80)
    return dataclasses.replace(cfg, n_heads=3) if case == "deepseek-h3" \
        else cfg


def drift_cfg(dispatch, configs=TC):
    cfg = configs.get("granite_moe_3b_a800m").reduced()
    return dataclasses.replace(cfg, moe_dispatch=dispatch, dtype="bfloat16")


def serve_inputs(cfg, seed=1):
    """(prompt batch, decode tokens (STEPS, B, 1)) as numpy arrays."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.frontend == "audio":
        batch["frontend_embeds"] = (0.1 * rng.standard_normal(
            (B, S, cfg.d_model))).astype(np.float32)
    steps = rng.integers(0, cfg.vocab, (STEPS, B, 1)).astype(np.int32)
    return batch, steps


def ring_tokens(cfg, seed=3):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (RING_STEPS, B, 1)).astype(np.int32)


def prefilled_inputs(cfg, seed=2):
    """Whisper's prompt with SE encoder frames, and its decode tokens."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
             "frontend_embeds": (0.1 * rng.standard_normal(
                 (B, SE, cfg.d_model))).astype(np.float32)}
    return batch, rng.integers(0, cfg.vocab, (STEPS, B, 1)).astype(np.int32)


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _decode(model, cache, toks):
    out = []
    for t, tok in enumerate(toks):
        lg, cache = model.decode_step(cache, torch.from_numpy(tok), t)
        out.append(lg)
    return out, cache


def serve_run(model, cfg):
    """Prefill, and STEPS decode steps from ``init_cache``: (prefill logits,
    prefill cache, [step logits], decode cache)."""
    batch, steps = serve_inputs(cfg)
    logits, cache = model.prefill(_t(batch))
    out, dcache = _decode(model, model.init_cache(B, S + STEPS), steps)
    return logits, cache, out, dcache


def ring_run(model, cfg):
    """RING_STEPS decode steps from ``init_cache``: ([logits], cache)."""
    return _decode(model, model.init_cache(B, RING_STEPS), ring_tokens(cfg))


def prefilled_run(model, cfg):
    """Whisper's prefill over SE frames, then STEPS decode steps from a
    cache of SE positions holding the prefill's cross caches: (prefill
    logits, [step logits], decode cache)."""
    batch, steps = prefilled_inputs(cfg)
    logits, pcache = model.prefill(_t(batch))
    cache = model.init_cache(B, SE)
    for k in ("cross_k", "cross_v"):
        cache["main"][k].copy_(pcache["main"][k])
    out, cache = _decode(model, cache, steps)
    return logits, out, cache


def _loaded(cfg, mesh=None):
    from repro_torch.models import shard_state_dict
    model = build_model(cfg, device=CPU, mesh=mesh)
    state = params_from_reference(cfg, reference_tree(cfg))
    model.load_state_dict(state if mesh is None
                          else shard_state_dict(cfg, state, mesh))
    return model


def _plain(cache):
    return {g: dict(v) for g, v in cache.items()}


# ------------------------------------------------------- inside each rank --

def _rank_main(rank, world, out_dir):
    import torch.distributed as dist
    from repro_torch.ft import ElasticMesh
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.sharding import gather_tensor
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(f"{out_dir}/store", world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    try:
        out = {"serve": {}, "train": {}, "ring": {}, "prefilled": {},
               "drift": {}}
        t0 = time.perf_counter()
        for mp_ in WORLDS[world]:
            mesh = ElasticMesh(mp_, device=CPU).current()
            shape = tuple(mesh.mesh.shape)
            coord = tuple(mesh.get_coordinate())
            for case in IDS:
                cfg = case_cfg(case)
                logits, cache, steps, dcache = serve_run(_loaded(cfg, mesh),
                                                         cfg)
                out["serve"][(case, shape)] = dict(
                    coord=coord, logits=logits, steps=steps,
                    cache=_plain(cache), dcache=_plain(dcache),
                    specs=cache.specs, dspecs=dcache.specs)
                out["train"][(case, shape)] = _rank_run(cfg, mesh, "tp")
            if shape[1] == 1:
                continue
            cfg = case_cfg("hymba")
            steps, cache = ring_run(_loaded(cfg, mesh), cfg)
            out["ring"][shape] = dict(coord=coord, steps=steps,
                                      cache=_plain(cache), specs=cache.specs)
            cfg = case_cfg("whisper")
            logits, steps, cache = prefilled_run(_loaded(cfg, mesh), cfg)
            out["prefilled"][shape] = dict(coord=coord, logits=logits,
                                           steps=steps, cache=_plain(cache),
                                           specs=cache.specs)
            if shape[0] == 1:
                for dispatch in ("ragged", "sharded"):
                    cfg = drift_cfg(dispatch)
                    out["drift"][(dispatch, shape)] = _loaded(
                        cfg, mesh).prefill(_t(serve_inputs(cfg)[0]))[0]
        if world == 2:
            mesh = ElasticMesh(2, device=CPU).current()
            state = launch_train.main(LAUNCH + ["--model-parallel", "2",
                                                "--sharding", "tp"])
            cfg = TC.get("mamba2_130m").reduced()
            specs = param_shardings(mesh, param_specs(cfg))
            out["launch"] = {n: gather_tensor(t.detach(), specs[n], mesh)
                             for n, t in state.params.items()}
        out["seconds"] = time.perf_counter() - t0
        torch.save(out, f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------- the reference --

_REFERENCE = r"""
import os, sys
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           "--xla_backend_optimization_level=0")
sys.path.insert(0, sys.argv[1])
import pickle
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro import configs as RC
from repro.launch.sharding import (batch_shardings, cache_shardings,
                                   param_shardings, train_state_shardings)
from repro.models import build_model
from repro.models.layers import moe as RM
from repro.train import step as RS
from repro.train.optimizer import adamw_init
from repro_torch.models.convert import unstack_reference
import test_torch_lm_sharded_blocks as T
import test_torch_lm_sharded_train as TT

def mesh_of(shape):
    return jax.make_mesh(shape, ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:shape[0] * shape[1]])

def placed(mesh, model, tcfg, batch):
    params = jax.device_put(
        jax.tree.map(jnp.asarray, T.reference_tree(tcfg)),
        param_shardings(mesh, model.param_specs()))
    bspec = batch_shardings(mesh, {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
                                   for k, v in batch.items()})
    return params, {k: jax.device_put(jnp.asarray(v), bspec[k])
                    for k, v in batch.items()}

def flat(tree):
    return {n: TT.sample(a) for n, a in unstack_reference(
        jax.tree.map(np.asarray, tree)).items()}

out = {"serve": {}, "train": {}, "drift": {}}
for case, shape in T.REF_SERVE:
    tcfg, cfg = T.case_cfg(case), T.case_cfg(case, RC)
    mesh = mesh_of(shape)
    RM.set_shard_mesh(mesh)
    model = build_model(cfg)
    batch, steps = T.serve_inputs(tcfg)
    params, batch = placed(mesh, model, tcfg, batch)
    logits, _ = jax.jit(model.prefill)(params, batch)
    cache = jax.device_put(
        model.init_cache(T.B, T.S + T.STEPS),
        cache_shardings(mesh, model.init_cache_specs(T.B, T.S + T.STEPS)))
    tspec = batch_shardings(mesh, {"t": jax.ShapeDtypeStruct(
        steps.shape[1:], jnp.int32)})["t"]
    decode = jax.jit(model.decode_step)
    run = {"prefill": np.asarray(logits), "steps": []}
    for t in range(T.STEPS):
        lg, cache = decode(params, cache, jax.device_put(
            jnp.asarray(steps[t]), tspec), jnp.int32(t))
        run["steps"].append(np.asarray(lg))
    out["serve"][(case, shape)] = run

for case, shape in T.REF_TRAIN:
    tcfg, cfg = T.case_cfg(case), T.case_cfg(case, RC)
    mesh = mesh_of(shape)
    RM.set_shard_mesh(mesh)
    model = build_model(cfg)
    params = jax.tree.map(jnp.asarray, TT.stack_like_reference(
        TT.numpy_weights(tcfg)))
    state = RS.TrainState(params=params, opt=adamw_init(params),
                          step=jnp.zeros((), jnp.int32))
    with mesh:
        ssh = train_state_shardings(mesh, RS.train_state_specs(model),
                                    mode="tp")
        state = jax.device_put(state, ssh)
        step = RS.make_train_step(model, base_lr=TT.LR, warmup=1,
                                  total_steps=10)
        b0 = TT.train_batch(tcfg, 0)
        bsh = batch_shardings(mesh, {k: jax.ShapeDtypeStruct(v.shape,
                                                             v.dtype)
                                     for k, v in b0.items()})
        fn = jax.jit(step, in_shardings=(ssh, bsh),
                     out_shardings=(ssh, None))
        run = {"m": []}
        for i in range(TT.STEPS):
            state, m = fn(state, {k: jnp.asarray(v) for k, v in
                                  TT.train_batch(tcfg, i).items()})
            run["m"].append({k: float(v) for k, v in m.items()})
            if i == 0:
                run["mu0"] = flat(state.opt.mu)
        run["final"] = {"params": flat(state.params),
                        "mu": flat(state.opt.mu), "nu": flat(state.opt.nu)}
    out["train"][(case, shape)] = run

# Granite's bf16 prefill, sharded over "model" and on one device
for dispatch, shape in [(None, None)] + T.DRIFT:
    tcfg = T.drift_cfg(dispatch or "ragged")
    cfg = T.drift_cfg(dispatch or "ragged", RC)
    model = build_model(cfg)
    batch = T.serve_inputs(tcfg)[0]
    # the weights in the dtypes the reference keeps them in
    params = jax.tree.map(lambda a, sd: jnp.asarray(a, sd.dtype),
                          T.reference_tree(tcfg), model.param_specs())
    if shape is not None:
        mesh = mesh_of(shape)
        RM.set_shard_mesh(mesh)
        params = jax.device_put(params, param_shardings(
            mesh, model.param_specs()))
        batch = placed(mesh, model, tcfg, batch)[1]
    logits, _ = jax.jit(model.prefill)(params, {
        k: jnp.asarray(v) for k, v in batch.items()})
    out["drift"][(dispatch, shape)] = np.asarray(logits.astype(jnp.float32))
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
"""


# ------------------------------------------------------------- fixtures --

@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{"ranks": {world size: [rank 0's results, ...]}, "ref": the
    reference's runs}: both gloo worlds and the reference's subprocess,
    started together."""
    import pickle
    dirs = {w: tmp_path_factory.mktemp(f"blocks-world{w}") for w in WORLDS}
    ref_out = tmp_path_factory.mktemp("blocks-ref") / "ref.pkl"
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
    with open(ref_out, "rb") as f:
        refs = pickle.load(f)
    return dict(ranks={w: [torch.load(d / f"rank{r}.pt", weights_only=False)
                           for r in range(w)] for w, d in dirs.items()},
                ref=refs)


@pytest.fixture(scope="module")
def one_device():
    """The port's one-device runs, on the module's one thread, as the
    worlds' ranks run."""
    from repro_torch.launch import train as launch_train
    out = {"serve": {}, "train": {}}
    for case in IDS:
        cfg = case_cfg(case)
        out["serve"][case] = serve_run(_loaded(cfg), cfg)
        out["train"][case] = train_run(cfg)
    cfg = case_cfg("hymba")
    out["ring"] = ring_run(_loaded(cfg), cfg)
    cfg = case_cfg("whisper")
    out["prefilled"] = prefilled_run(_loaded(cfg), cfg)
    cfg = drift_cfg("ragged")
    out["drift"] = _loaded(cfg).prefill(_t(serve_inputs(cfg)[0]))[0]
    state = launch_train.main(LAUNCH)
    out["launch"] = {n: t.detach() for n, t in state.params.items()}
    return out


def ranks_of(worlds, shape):
    return worlds["ranks"][shape[0] * shape[1]]


def check_blocks(runs, whole, mesh, which="cache", specs_key="specs"):
    """Each rank's cache blocks of the shape ``cache_shardings`` gives,
    put together within TOL of the one-device cache ``whole``."""
    specs = runs[0][specs_key]
    assert specs == cache_shardings(mesh, {
        g: {k: tuple(v.shape) for k, v in leaves.items()}
        for g, leaves in whole.items()})
    for group, leaves in whole.items():
        for name, t in leaves.items():
            blocks = {r["coord"]: r[which][group][name] for r in runs}
            for block in blocks.values():
                assert tuple(block.shape) == local_shape(
                    t.shape, specs[group][name], mesh)
            close(unshard(blocks, specs[group][name], mesh), t)
    return specs


def check_logits(runs, logits, steps, got_steps="steps"):
    """Rank 0's logits within TOL of one device's; every rank's bitwise
    rank 0's."""
    run = runs[0]
    if logits is not None:
        close(run["logits"], logits)
    for got, want in zip(run[got_steps], steps):
        close(got, want)
    for other in runs[1:]:
        if logits is not None:
            assert torch.equal(other["logits"], run["logits"])
        assert all(torch.equal(a, b) for a, b in zip(other[got_steps],
                                                     run[got_steps]))


def check_train_ranks(ranks, case, shape):
    """Every rank's metrics bitwise equal; every block two ranks both hold
    bitwise equal."""
    runs = [r["train"][(case, shape)] for r in ranks]
    assert all(r["m"] == runs[0]["m"] for r in runs[1:])
    mesh = AbstractMesh(shape, NAMES)
    specs = param_shardings(mesh, param_specs(case_cfg(case)))
    sizes = dict(zip(NAMES, shape))
    for (which, n), _ in runs[0]["blocks"].items():
        held = {}
        for r in runs:
            coord = dict(zip(NAMES, r["coord"]))
            idx = tuple(_block_index(e, coord, sizes)[0] for e in specs[n])
            held.setdefault(idx, set()).add(r["blocks"][(which, n)])
        assert all(len(v) == 1 for v in held.values()), (which, n)


# ------------------------------------------------------------- the tests --

@pytest.mark.parametrize("case,shape", REF_SERVE,
                         ids=[f"{c}-{s[0]}x{s[1]}" for c, s in REF_SERVE])
def test_serving_matches_the_reference_sharded_run(worlds, case, shape):
    run = ranks_of(worlds, shape)[0]["serve"][(case, shape)]
    ref = worlds["ref"]["serve"][(case, shape)]
    close(run["logits"], ref["prefill"])
    for got, want in zip(run["steps"], ref["steps"]):
        close(got, want)


@pytest.mark.parametrize("shape", MESHES,
                         ids=[f"{s[0]}x{s[1]}" for s in MESHES])
@pytest.mark.parametrize("case", IDS)
def test_serving_matches_one_device_and_ranks_agree(worlds, one_device,
                                                    case, shape):
    runs = [r["serve"][(case, shape)] for r in ranks_of(worlds, shape)]
    logits, _, steps, _ = one_device["serve"][case]
    assert runs[0]["logits"].shape == logits.shape
    check_logits(runs, logits, steps)


@pytest.mark.parametrize("shape", MESHES,
                         ids=[f"{s[0]}x{s[1]}" for s in MESHES])
@pytest.mark.parametrize("case", IDS)
def test_cache_blocks_are_slices_of_one_device(worlds, one_device, case,
                                               shape):
    runs = [r["serve"][(case, shape)] for r in ranks_of(worlds, shape)]
    mesh = AbstractMesh(shape, NAMES)
    _, cache, _, dcache = one_device["serve"][case]
    check_blocks(runs, cache, mesh)
    specs = check_blocks(runs, dcache, mesh, "dcache", "dspecs")
    if shape[1] > 1 and "ssm" in specs["main"]:
        # mamba2 and hymba: the state on its heads; hymba-p: on its columns
        assert specs["main"]["ssm"][2 if case != "hymba-p" else 3] == "model"
        assert "model" not in specs["main"]["conv"]


@pytest.mark.parametrize("case,shape", REF_TRAIN,
                         ids=[f"{c}-{s[0]}x{s[1]}" for c, s in REF_TRAIN])
def test_train_steps_match_the_reference_sharded_step(worlds, case, shape):
    run = ranks_of(worlds, shape)[0]["train"][(case, shape)]
    check_run(run, worlds["ref"]["train"][(case, shape)], exact_grads=False)


@pytest.mark.parametrize("shape", MESHES,
                         ids=[f"{s[0]}x{s[1]}" for s in MESHES])
@pytest.mark.parametrize("case", IDS)
def test_train_steps_match_one_device_and_ranks_agree(worlds, one_device,
                                                      case, shape):
    ranks = ranks_of(worlds, shape)
    check_run(ranks[0]["train"][(case, shape)], one_device["train"][case])
    check_train_ranks(ranks, case, shape)


@pytest.mark.parametrize("shape", SPLIT, ids=[f"{s[0]}x{s[1]}" for s in SPLIT])
def test_ring_decodes_past_its_window(worlds, one_device, shape):
    """Hymba over RING_STEPS > W = 32 decode steps, the ring split along
    its slots: each step within TOL of one device, the ring's blocks and
    the state's slices of one device's."""
    runs = [r["ring"][shape] for r in ranks_of(worlds, shape)]
    steps, cache = one_device["ring"]
    assert len(steps) == RING_STEPS > case_cfg("hymba").sliding_window
    check_logits(runs, None, steps)
    specs = check_blocks(runs, cache, AbstractMesh(shape, NAMES))
    assert specs["main"]["k"][2] == "model"
    assert int(cache["main"]["pos"].min()) == RING_STEPS - 32  # wrapped


@pytest.mark.parametrize("shape", SPLIT, ids=[f"{s[0]}x{s[1]}" for s in SPLIT])
def test_whisper_decodes_its_prefilled_cross_caches(worlds, one_device,
                                                    shape):
    """Whisper prefilled with SE encoder frames: its decode reads the
    prefill's cross caches, split along the encoder sequence."""
    runs = [r["prefilled"][shape] for r in ranks_of(worlds, shape)]
    logits, steps, cache = one_device["prefilled"]
    check_logits(runs, logits, steps)
    specs = check_blocks(runs, cache, AbstractMesh(shape, NAMES))
    assert specs["main"]["cross_k"][2] == "model"
    held = cache["main"]["cross_k"].abs().sum(dim=(0, 1, 3, 4))
    assert bool((held > 0).all())           # every encoder position


def test_launcher_trains_mamba2_tensor_parallel(worlds, one_device):
    """``launch.train --model-parallel 2 --sharding tp`` on mamba2: the
    gathered masters after 3 steps within 1e-4 of each leaf's largest
    magnitude of the launcher on one device; both ranks hold them."""
    ranks = worlds["ranks"][2]
    want = one_device["launch"]
    for r in ranks:
        assert r["launch"].keys() == want.keys()
        for n, t in want.items():
            err = float((r["launch"][n] - t).abs().max())
            assert err <= TOL * max(float(t.abs().max()), 1e-30), (n, err)
    assert all(torch.equal(ranks[1]["launch"][n], t)
               for n, t in ranks[0]["launch"].items())


@pytest.mark.parametrize("dispatch,shape", DRIFT,
                         ids=[f"{d}-{s[0]}x{s[1]}" for d, s in DRIFT])
def test_bf16_moe_drift_within_twice_the_reference(worlds, one_device,
                                                   dispatch, shape):
    """Granite at ``reduced()`` in bf16, prefill sharded over "model"
    against one device, max|d| / max|logit|: the port's drift within twice
    the reference's at the same size and inputs (a difference of rounding
    order, not a fault)."""
    ref = worlds["ref"]["drift"]
    ref_one = ref[(None, None)]
    ref_drift = np.abs(ref[(dispatch, shape)] - ref_one).max() / \
        np.abs(ref_one).max()
    one = one_device["drift"].float()
    got = ranks_of(worlds, shape)[0]["drift"][(dispatch, shape)].float()
    drift = float((got - one).abs().max() / one.abs().max())
    assert 0 < ref_drift and drift <= 2 * ref_drift, (drift, ref_drift)
