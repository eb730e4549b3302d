"""The LM stack's sharded training in the port, held against the JAX
reference's own sharded train step and the port's one-device step.

Two gloo worlds on the CPU -- 2 ranks (meshes ``(1, 2)`` and ``(2, 1)``)
and 4 ranks (``(2, 2)`` and ``(1, 4)``) -- run in spawned processes started
together by one module fixture, a ``FileStore`` each under the test's tmp
dir, with a process-group timeout and a join deadline. Beside them one JAX
subprocess with four host devices runs the reference's ``make_train_step``
under ``jax.jit`` with the state placed by its ``train_state_shardings`` and
the batch by its ``batch_shardings`` (``grad_shardings`` pinned under
``"fsdp"``, as its dry run does), on meshes of Auto axes. Both packages
load the same weights, drawn per leaf with numpy from a seed.

- Tensor parallelism (``mode="tp"``): the six families that shard over
  "model" (granite under ``"ragged"`` and ``"sharded"``) at ``reduced()``,
  meshes ``(1, 2)``, ``(2, 1)`` and ``(2, 2)``.
- ZeRO-3 (``mode="fsdp"``): all ten families at ``(2, 2)`` and ``(1, 4)``,
  at ``reduced()`` with a vocabulary of 16,384 and wider ``d_ff`` (16,384
  dense, 2,048 per expert), so that the table and the block matrices reach
  the rule's 2**20 elements and are sharded (at ``reduced()`` widths every
  leaf replicates).
- Each run: 3 steps, warmup 1, base_lr 1e-4, remat on (the recompute
  re-issues the layers' collectives), on batches whose label masks differ
  between the data shards. Held: loss and metrics within 1e-5 and the
  grad norm within 1e-5 relative of each step's; the gathered gradients of
  step 0 (against the reference: its first moment after step 0, which is
  the clipped gradient over 10) and the gathered masters and moments after
  step 3 within 1e-4 of each leaf's largest magnitude, on a fixed sample of
  each leaf's elements (every element of leaves up to 4,096); every rank's
  metrics, and every block that two ranks both hold, bitwise equal.

The trouble spots: the loss over unequal label masks is the global batch's
where the mean of per-shard means misses; MoE's ``lb_loss`` the same; a
batch of 3 rows, which no data axis divides, is replicated and its
gradients taken once, where a d-fold sum misses. ZeRO-3 shards serve too
(prefill on ``(2, 2)`` against one device).
"""

import dataclasses
import datetime
import functools
import hashlib
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
from repro_torch.launch.sharding import _block_index, param_shardings
from repro_torch.models import build_model, param_specs, shard_state_dict
from repro_torch.models.convert import stack_like_reference
from repro_torch.models.layers.basic import Leaf
from repro_torch.models.model import param_leaves
from repro_torch.train.step import init_train_state, make_train_step

METRIC_TOL = 1e-5
LEAF_TOL = 1e-4
B, S, STEPS, LR = 4, 8, 3, 1e-4
SAMPLE = 4096
PG_TIMEOUT_S = 60
JOIN_TIMEOUT_S = 600
CPU = "cpu"
NAMES = ("data", "model")
REPO = pathlib.Path(__file__).resolve().parent.parent

#: (case id, arch, moe dispatch) that shard over "model"
TP_CASES = [("qwen3", "qwen3_4b", None), ("gemma", "gemma_7b", None),
            ("mistral", "mistral_large_123b", None),
            ("starcoder2", "starcoder2_3b", None),
            ("pixtral", "pixtral_12b", None),
            ("granite-ragged", "granite_moe_3b_a800m", "ragged"),
            ("granite-sharded", "granite_moe_3b_a800m", "sharded")]
FSDP_CASES = [("qwen3", "qwen3_4b"), ("gemma", "gemma_7b"),
              ("mistral", "mistral_large_123b"),
              ("starcoder2", "starcoder2_3b"), ("pixtral", "pixtral_12b"),
              ("granite", "granite_moe_3b_a800m"), ("mamba2", "mamba2_130m"),
              ("hymba", "hymba_1_5b"), ("deepseek", "deepseek_v3_671b"),
              ("whisper", "whisper_medium")]
TP_MESHES = [(1, 2), (2, 1), (2, 2)]
FSDP_MESHES = [(2, 2), (1, 4)]
#: indivisible batches: (case, mode, mesh)
ODD = [("qwen3", "tp", (2, 1)), ("granite-ragged", "tp", (2, 2)),
       ("granite", "fsdp", (2, 2))]
#: {world size: {mode: meshes}}
WORLDS = {2: {"tp": [(1, 2), (2, 1)], "fsdp": []},
          4: {"tp": [(2, 2)], "fsdp": FSDP_MESHES}}
#: the reference's sharded runs, every family in each mode once (its
#: compiles set the fixture's pace)
REF_RUNS = [("tp", c, (2, 2)) for c, _, _ in TP_CASES] + [
    ("fsdp", c, (2, 2) if i < 5 else (1, 4))
    for i, (c, _) in enumerate(FSDP_CASES)]


def case_arch(mode, case):
    """(arch id, moe dispatch or None) of a case."""
    if mode == "tp":
        return next(c for c in TP_CASES if c[0] == case)[1:]
    return dict(FSDP_CASES)[case], None


def case_cfg(mode, case, configs=TC):
    """The config of a case (from ``configs``, either package's):
    ``reduced()``; under "fsdp" widened so the ZeRO-3 rule shards the
    table and the block matrices."""
    arch, dispatch = case_arch(mode, case)
    cfg = configs.get(arch).reduced()
    if dispatch:
        cfg = dataclasses.replace(cfg, moe_dispatch=dispatch)
    if mode == "tp":
        return cfg
    return dataclasses.replace(cfg, vocab=16384,
                               d_ff=2048 if cfg.n_experts else 16384)


@functools.lru_cache(maxsize=4)
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


def train_batch(cfg, step, b=B):
    """Step ``step``'s batch as numpy arrays; the label masks differ
    between the rows (and so between the data shards)."""
    rng = np.random.default_rng(100 + step)
    toks = rng.integers(0, cfg.vocab, (b, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :S], "labels": toks[:, 1:].copy()}
    batch["labels"][0, :3] = -1
    batch["labels"][b // 2, 1:] = -1
    if cfg.frontend == "vision":
        batch["frontend_embeds"] = (0.1 * rng.standard_normal(
            (b, cfg.n_frontend_tokens, cfg.d_model))).astype(np.float32)
    if cfg.frontend == "audio":
        batch["frontend_embeds"] = (0.1 * rng.standard_normal(
            (b, S, cfg.d_model))).astype(np.float32)
    return batch


def sample(arr):
    """(max |arr|, arr at a fixed sample of its flat positions)."""
    flat = np.asarray(arr, np.float32).reshape(-1)
    n = flat.size
    idx = np.arange(n) if n <= SAMPLE else np.sort(
        np.random.default_rng(n).choice(n, SAMPLE, replace=False))
    return float(np.abs(flat).max()), flat[idx]


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def port_run(cfg, mesh=None, mode="tp", b=B, gather=None):
    """3 steps from the numpy weights: {"g0", "m", "mu0", "final"}; on a
    mesh ``gather(name, tensor, tree)`` makes each tensor whole."""
    model = build_model(cfg, device=CPU, mesh=mesh, mode=mode)
    state = init_train_state(model, torch.Generator().manual_seed(0))
    whole = {n: torch.from_numpy(w) for n, w in numpy_weights(cfg).items()}
    mine = whole if mesh is None else shard_state_dict(cfg, whole, mesh,
                                                       mode)
    with torch.no_grad():
        for n, p in state.params.items():
            p.copy_(mine[n])
    step = make_train_step(model, base_lr=LR, warmup=1, total_steps=10)
    keep = gather or (lambda n, t, tree: t.detach().clone())
    g0, _ = step.gradients(state, torch_batch(train_batch(cfg, 0, b)))
    out = {"g0": {n: keep(n, g, "params") for n, g in g0.items()},
           "m": [], "blocks": {}}
    for i in range(STEPS):
        _, m = step(state, torch_batch(train_batch(cfg, i, b)))
        out["m"].append({k: float(v) for k, v in m.items()})
        if i == 0:
            out["mu0"] = {n: keep(n, t, "mu") for n, t in
                          state.opt.mu.items()}
    out["final"] = {which: {n: keep(n, t, which) for n, t in tree.items()}
                    for which, tree in (("params", state.params),
                                        ("mu", state.opt.mu),
                                        ("nu", state.opt.nu))}
    out["blocks"] = {(which, n): hashlib.sha1(
        t.detach().contiguous().numpy().tobytes()).hexdigest()
        for which, tree in (("params", state.params), ("mu", state.opt.mu))
        for n, t in tree.items()}
    return out


def summarize(run):
    """Whole tensors -> ``sample``s (what is kept and compared)."""
    out = dict(run)
    out["g0"] = {n: sample(t) for n, t in run["g0"].items()}
    out["mu0"] = {n: sample(t) for n, t in run["mu0"].items()}
    out["final"] = {w: {n: sample(t) for n, t in tree.items()}
                    for w, tree in run["final"].items()}
    return out


# ------------------------------------------------------- inside each rank --

def _rank_run(cfg, mesh, mode, b=B):
    """``port_run`` on ``mesh``, every tensor gathered whole (every rank
    takes part); rank 0 keeps the samples, every rank its metrics and
    block digests."""
    import torch.distributed as dist
    from repro_torch.launch.sharding import gather_tensor
    specs = param_shardings(mesh, param_specs(cfg), mode)
    lead = dist.get_rank() == 0

    def gather(name, t, _tree):
        whole = gather_tensor(t.detach(), specs[name], mesh)
        return whole.numpy().copy() if lead else None
    run = port_run(cfg, mesh, mode, b, gather)
    if lead:
        run = summarize(run)
    return dict(m=run["m"], blocks=run["blocks"],
                coord=tuple(mesh.get_coordinate()),
                **({k: run[k] for k in ("g0", "mu0", "final")}
                   if lead else {}))


def _rank_main(rank, world, out_dir):
    import torch.distributed as dist
    from repro_torch.ft import ElasticMesh
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(f"{out_dir}/store", world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    try:
        out = {"runs": {}, "odd": {}, "served": {}}
        t0 = time.perf_counter()
        for mode, meshes in WORLDS[world].items():
            cases = [c for c, _, _ in TP_CASES] if mode == "tp" else \
                [c for c, _ in FSDP_CASES]
            for shape in meshes:
                mesh = ElasticMesh(shape[1], device=CPU).current()
                assert tuple(mesh.mesh.shape) == shape
                for case in cases:
                    out["runs"][(mode, case, shape)] = _rank_run(
                        case_cfg(mode, case), mesh, mode)
                for case, m, s in ODD:
                    if (m, s) == (mode, shape):
                        out["odd"][(case, mode, shape)] = _rank_run(
                            case_cfg(mode, case), mesh, mode, b=3)
                if (mode, shape) == ("fsdp", (2, 2)):
                    for case in ("qwen3", "mamba2"):
                        cfg = case_cfg(mode, case)
                        model = build_model(cfg, device=CPU, mesh=mesh,
                                            mode=mode)
                        model.load_state_dict(shard_state_dict(cfg, {
                            n: torch.from_numpy(w) for n, w in
                            numpy_weights(cfg).items()}, mesh, mode))
                        out["served"][case] = model.prefill(torch_batch(
                            {"tokens": train_batch(cfg, 0)["tokens"]}))[0]
        out["seconds"] = time.perf_counter() - t0
        torch.save(out, f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------- the reference --

_REFERENCE = r"""
import os, sys
# LLVM's -O0 for the host code: a third less compile time (the suite
# shares the CPU), the same HLO
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           "--xla_backend_optimization_level=0")
sys.path.insert(0, sys.argv[1])
import dataclasses, pickle
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro import configs as RC
from repro.launch.sharding import batch_shardings, train_state_shardings
from repro.models import build_model
from repro.models.layers import moe as RM
from repro.train import step as RS
from repro.train.optimizer import adamw_init
from repro_torch.models.convert import unstack_reference
import test_torch_lm_sharded_train as T

def flat(tree):
    return {n: T.sample(a) for n, a in unstack_reference(
        jax.tree.map(np.asarray, tree)).items()}

out = {}
for mode, case, shape in T.REF_RUNS:
    tcfg = T.case_cfg(mode, case)
    cfg = T.case_cfg(mode, case, RC)
    mesh = jax.make_mesh(shape, ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:shape[0] * shape[1]])
    RM.set_shard_mesh(mesh)
    model = build_model(cfg)
    params = jax.tree.map(jnp.asarray, T.stack_like_reference(
        T.numpy_weights(tcfg)))
    state = RS.TrainState(params=params, opt=adamw_init(params),
                          step=jnp.zeros((), jnp.int32))
    with mesh:
        ssh = train_state_shardings(mesh, RS.train_state_specs(model),
                                    mode=mode)
        state = jax.device_put(state, ssh)
        step = RS.make_train_step(
            model, base_lr=T.LR, warmup=1, total_steps=10,
            grad_shardings=ssh.params if mode == "fsdp" else None)
        b0 = T.train_batch(tcfg, 0)
        bsh = batch_shardings(mesh, {k: jax.ShapeDtypeStruct(v.shape,
                                                             v.dtype)
                                     for k, v in b0.items()}, mode=mode)
        fn = jax.jit(step, in_shardings=(ssh, bsh),
                     out_shardings=(ssh, None))
        run = {"m": []}
        for i in range(T.STEPS):
            state, m = fn(state, {k: jnp.asarray(v) for k, v in
                                  T.train_batch(tcfg, i).items()})
            run["m"].append({k: float(v) for k, v in m.items()})
            if i == 0:
                run["mu0"] = flat(state.opt.mu)
        run["final"] = {"params": flat(state.params),
                        "mu": flat(state.opt.mu), "nu": flat(state.opt.nu)}
    out[(mode, case, shape)] = run
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
"""


# ------------------------------------------------------------- fixtures --

@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{"ranks": {world size: [rank 0's results, ...]}, "ref": {(mode,
    case, shape): run}}: both gloo worlds and the reference's subprocess,
    started together."""
    import pickle
    dirs = {w: tmp_path_factory.mktemp(f"train-world{w}") for w in WORLDS}
    ref_out = tmp_path_factory.mktemp("train-ref") / "ref.pkl"
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
    """The port's one-device runs: {(mode, case, rows): whole run}, on the
    module's one thread, as the worlds' ranks run."""
    return _one_device_runs()


def _one_device_runs():
    out = {}
    for mode, cases in (("tp", [c for c, _, _ in TP_CASES]),
                        ("fsdp", [c for c, _ in FSDP_CASES])):
        for case in cases:
            cfg = case_cfg(mode, case)
            if cfg.moe_dispatch == "sharded":     # one device: "ragged"
                cfg = dataclasses.replace(cfg, moe_dispatch="ragged")
            out[(mode, case, B)] = port_run(cfg)
    for case, mode, _ in ODD:
        cfg = case_cfg(mode, case)
        out[(mode, case, 3)] = port_run(cfg, b=3)
    return out


def world_of(worlds, shape):
    return worlds["ranks"][shape[0] * shape[1]]


def check_run(got, want, exact_grads=True):
    """Metrics, grad norm, step-0 gradients, masters and moments of ``got``
    (sampled) against ``want`` (sampled or whole)."""
    for a, c in zip(got["m"], want["m"]):
        assert a.keys() == c.keys()
        for k in c:
            tol = METRIC_TOL * max(1.0, abs(c[k])) if k == "grad_norm" \
                else METRIC_TOL
            assert abs(a[k] - c[k]) <= tol, (k, a[k], c[k])
    pairs = [("mu0", got["mu0"], want["mu0"])]
    if exact_grads:
        pairs.append(("g0", got["g0"], want["g0"]))
    pairs += [(w, got["final"][w], want["final"][w])
              for w in ("params", "mu", "nu")]
    for which, mine, theirs in pairs:
        assert mine.keys() == theirs.keys()
        for n in theirs:
            peak, values = theirs[n] if isinstance(theirs[n], tuple) \
                else sample(theirs[n].detach().numpy())
            err = np.abs(mine[n][1] - values).max(initial=0.0)
            assert err <= LEAF_TOL * max(peak, 1e-30), (which, n, err, peak)


def check_ranks(ranks, key, group="runs"):
    """Every rank's metrics bitwise equal; every block two ranks both hold
    bitwise equal."""
    runs = [r[group][key] for r in ranks]
    assert all(r["m"] == runs[0]["m"] for r in runs[1:])
    mode, shape = key[-2] if group == "odd" else key[0], key[-1]
    cfg = case_cfg(mode, key[0] if group == "odd" else key[1])
    mesh = AbstractMesh(shape, NAMES)
    specs = param_shardings(mesh, param_specs(cfg), mode)
    sizes = dict(zip(NAMES, shape))
    checked = 0
    for (which, n), digest in runs[0]["blocks"].items():
        held = {}
        for r in runs:
            coord = dict(zip(NAMES, r["coord"]))
            idx = tuple(_block_index(e, coord, sizes)[0] for e in specs[n])
            held.setdefault(idx, set()).add(r["blocks"][(which, n)])
        assert all(len(v) == 1 for v in held.values()), (which, n)
        checked += sum(len(v) for v in held.values())
    assert checked > 0


# ------------------------------------------------------------- the tests --

@pytest.mark.parametrize("mode,case,shape", REF_RUNS,
                         ids=[f"{m}-{c}-{s[0]}x{s[1]}"
                              for m, c, s in REF_RUNS])
def test_matches_the_reference_sharded_step(worlds, mode, case, shape):
    run = world_of(worlds, shape)[0]["runs"][(mode, case, shape)]
    check_run(run, worlds["ref"][(mode, case, shape)], exact_grads=False)


@pytest.mark.parametrize("shape", TP_MESHES,
                         ids=[f"{s[0]}x{s[1]}" for s in TP_MESHES])
@pytest.mark.parametrize("case", [c for c, _, _ in TP_CASES])
def test_tensor_parallel_matches_one_device_and_ranks_agree(
        worlds, one_device, case, shape):
    ranks = world_of(worlds, shape)
    check_run(ranks[0]["runs"][("tp", case, shape)],
              one_device[("tp", case, B)])
    check_ranks(ranks, ("tp", case, shape))


@pytest.mark.parametrize("shape", FSDP_MESHES,
                         ids=[f"{s[0]}x{s[1]}" for s in FSDP_MESHES])
@pytest.mark.parametrize("case", [c for c, _ in FSDP_CASES])
def test_zero3_matches_one_device_and_ranks_agree(worlds, one_device, case,
                                                  shape):
    ranks = world_of(worlds, shape)
    check_run(ranks[0]["runs"][("fsdp", case, shape)],
              one_device[("fsdp", case, B)])
    check_ranks(ranks, ("fsdp", case, shape))


def test_zero3_shards_the_wide_leaves():
    """The widened configs shard the table and block matrices under the
    rule (at ``reduced()`` widths every leaf would replicate)."""
    mesh = AbstractMesh((2, 2), NAMES)
    for case, _ in FSDP_CASES:
        cfg = case_cfg("fsdp", case)
        specs = param_shardings(mesh, param_specs(cfg), "fsdp")
        split = [n for n, p in specs.items() if any(p)]
        assert "embed.table" in split, case
        assert not any(any(p) for p in param_shardings(
            mesh, param_specs(TC.get(case_arch("fsdp", case)[0]).reduced()),
            "fsdp").values())
        if case not in ("mamba2", "hymba"):
            assert any(n.startswith("blocks.") for n in split), case


def _share_runs(cfg, shares):
    """One-device metrics of each data shard's rows alone."""
    out = []
    for rows in shares:
        model = build_model(cfg, device=CPU)
        model.load_state_dict({n: torch.from_numpy(w) for n, w in
                               numpy_weights(cfg).items()})
        batch = {k: torch.from_numpy(v[rows])
                 for k, v in train_batch(cfg, 0).items()}
        _, m = model.forward_train(dict(model.named_parameters()), batch)
        out.append({k: float(v) for k, v in m.items()})
    return out


@pytest.mark.parametrize("case", ["qwen3", "granite-ragged"])
def test_global_loss_where_the_mean_of_shard_means_misses(worlds,
                                                          one_device, case):
    """(2, 1): the two data shards' label counts differ; the port's loss
    and ``lb_loss`` are the global batch's, the means of the shards' are
    not."""
    got = worlds["ranks"][2][0]["runs"][("tp", case, (2, 1))]["m"][0]
    want = one_device[("tp", case, B)]["m"][0]
    shares = _share_runs(case_cfg("tp", case), [slice(0, 2), slice(2, 4)])
    keys = ["xent"] + (["lb_loss"] if "lb_loss" in want else [])
    for k in keys:
        assert abs(got[k] - want[k]) <= METRIC_TOL
        mean_of_means = sum(s[k] for s in shares) / len(shares)
        assert abs(mean_of_means - want[k]) > 100 * METRIC_TOL, k


@pytest.mark.parametrize("case,mode,shape", ODD,
                         ids=[f"{c}-{m}-{s[0]}x{s[1]}" for c, m, s in ODD])
def test_indivisible_batch_takes_one_copy(worlds, one_device, case, mode,
                                          shape):
    """B = 3 divides no data axis: the batch replicates, and the
    gradients are each rank's own, once; a sum over the d data ranks
    misses."""
    ranks = world_of(worlds, shape)
    run = ranks[0]["odd"][(case, mode, shape)]
    want = one_device[(mode, case, 3)]
    check_run(run, want)
    check_ranks(ranks, (case, mode, shape), group="odd")
    d = shape[0] * (shape[1] if mode == "fsdp" else 1)
    n, (peak, g) = max(run["g0"].items(), key=lambda kv: kv[1][0])
    assert np.abs(d * g - sample(want["g0"][n].numpy())[1]).max() > \
        LEAF_TOL * peak


@pytest.mark.parametrize("case", ["qwen3", "mamba2"])
def test_zero3_shards_serve(worlds, case):
    cfg = case_cfg("fsdp", case)
    model = build_model(cfg, device=CPU)
    model.load_state_dict({n: torch.from_numpy(w) for n, w in
                           numpy_weights(cfg).items()})
    want, _ = model.prefill(torch_batch(
        {"tokens": train_batch(cfg, 0)["tokens"]}))
    for r in worlds["ranks"][4]:
        torch.testing.assert_close(r["served"][case], want, rtol=LEAF_TOL,
                                   atol=LEAF_TOL)
