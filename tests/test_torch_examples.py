"""The port's entry points (``repro_torch.examples``,
``repro_torch.experiments``) against the reference's drivers
(``examples/*.py``, ``experiments/render_roofline.py``).

One reference subprocess (``JAX_PLATFORMS=cpu``) runs every reference
driver through ``runpy`` with its ``sys.argv`` and captures what it
prints, plus the few reference numbers a driver does not print (RBP at a
pinned frontier, RnBP's marginals at the fixed point, the one-device
beliefs behind ``distributed_bp``, exact parameter counts). It starts
when the module does and runs beside the port's drivers, which run here
in-process with ``--device cpu``; both outputs go through the same
parsers. ``distributed_bp`` runs in one gloo world of two spawned ranks.

What must match (ROADMAP's rules of the port):

- quickstart: LBP stalls at 8000 rounds in both; RBP converges in both,
  and at the pinned ``p = 1/48`` its rounds are equal and its updates
  within 1 % (at the printed ``p = 1/128`` a near-tie moves the greedy
  order: 662 against 668 rounds, ROADMAP queue 3); both RnBP rows
  converge; RnBP's marginals at eps = 1e-5 within 1e-3 (the draws are
  not threefry's);
- stereo_bp (RBP and LBP): rounds, accuracies, energies and the disparity
  map as printed;
- ldpc_decode (``--words 2``, LBP and RBP): the BER table as printed,
  wall seconds aside;
- bp_serving under LBP: per-request rounds and P(x0) in sync, ``--async``
  and ``--async --workload mixed``, and the stats line from chunks to
  wasted sweeps; the deadline policy: rounds and status per rid; the
  router with stealing: rounds, P(x0) and status per rid (routed runs
  depend on interleaving in both packages); RnBP: converged counts;
- distributed_bp: sharded LBP and RnBP bitwise the port's one-device runs
  and within 5e-3 of the reference's one-device beliefs; banded LBP's
  round parity; both ranks' messages equal;
- train_lm (qwen3_4b, granite_moe_3b_a800m, reduced, 6 steps): the
  parameter count, a resume drift of exactly 0, the last loss below the
  first;
- render_roofline: the reference renderer's rows on records written here,
  apart from the fit column (the port reads ``peak_ok_80GB``).
"""

import contextlib
import datetime
import io
import json
import os
import pathlib
import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

from repro_torch.examples import (bp_serving, distributed_bp, ldpc_decode,
                                  quickstart, stereo_bp, train_lm)
from repro_torch.experiments import render_roofline

REPO = pathlib.Path(__file__).resolve().parent.parent
CPU = ["--device", "cpu"]
TOL = 5e-3                  # multi-device vs the reference's one device
FIXED_EPS = 1e-5            # RnBP compared at its fixed point (ROADMAP)
MARGINAL_TOL = 1e-3
RBP_PINNED = 1 / 48         # equal rounds in both packages on this graph
DIST_SIZE = 32
REF_TIMEOUT_S = 600
JOIN_TIMEOUT_S = 300

#: (key, reference driver, argv): what the reference subprocess runs
SERVE = ["--requests", "6", "--scheduler", "lbp"]
STEAL = ["--replicas", "2", "--routing", "least_loaded", "--steal"]
TRAIN = ["--steps", "6"]
JOBS = {
    "quickstart": ("examples/quickstart.py", []),
    "stereo/rbp": ("examples/stereo_bp.py", []),
    "stereo/lbp": ("examples/stereo_bp.py", ["--scheduler", "lbp"]),
    "ldpc/lbp": ("examples/ldpc_decode.py", ["--words", "2"]),
    "ldpc/rbp": ("examples/ldpc_decode.py",
                 ["--words", "2", "--scheduler", "rbp"]),
    "serve/sync": ("examples/bp_serving.py", SERVE),
    "serve/async": ("examples/bp_serving.py", SERVE + ["--async"]),
    "serve/mixed": ("examples/bp_serving.py",
                    SERVE + ["--async", "--workload", "mixed",
                             "--requests", "10"]),
    "serve/deadline": ("examples/bp_serving.py",
                       SERVE + ["--async", "--policy", "deadline",
                                "--slo-ms", "1e6"]),
    "serve/steal": ("examples/bp_serving.py", SERVE + STEAL),
    "serve/rnbp": ("examples/bp_serving.py", ["--requests", "6"]),
    "train/qwen3_4b": ("examples/train_lm.py",
                       ["--arch", "qwen3_4b"] + TRAIN),
    "train/granite_moe_3b_a800m": ("examples/train_lm.py",
                                   ["--arch", "granite_moe_3b_a800m"]
                                   + TRAIN),
}

_REF = r"""
import contextlib, io, json, runpy, sys
import jax
import numpy as np

jobs, records, out_path = json.loads(sys.argv[1])
out = {}
for key, (path, argv) in jobs.items():
    sys.argv = [path] + argv
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        runpy.run_path(path, run_name="__main__")
    out[key] = buf.getvalue()

buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    runpy.run_path("experiments/render_roofline.py")["render"](
        d=records, mesh_filter="16x16")
out["render"] = buf.getvalue()

from repro.core import BPConfig, BPEngine
from repro.pgm import ising_grid, ising_grid_fast
pgm = ising_grid(40, C=2.5, seed=2)
res = BPEngine(BPConfig(eps=1e-3, max_rounds=8000), scheduler="rbp",
               scheduler_kwargs={"p": %(rbp)r}).run(pgm, jax.random.key(0))
out["rbp_pinned"] = [int(res.rounds), int(res.updates), bool(res.converged)]
fixed = {}
for low_p in (0.4, 0.1):
    res = BPEngine(BPConfig(eps=%(eps)r, max_rounds=8000), scheduler="rnbp",
                   scheduler_kwargs={"low_p": low_p}).run(pgm,
                                                           jax.random.key(0))
    b = np.exp(np.asarray(res.beliefs))[:pgm.n_real_vertices, 1]
    fixed[str(low_p)] = dict(converged=bool(res.converged),
                             marginals=b.tolist())
out["fixed_point"] = fixed

g = ising_grid_fast(%(size)r, 2.5, seed=0)
one = {}
for name, spec, kw in (("LBP", "lbp", {}), ("RnBP", "rnbp", {"low_p": 0.7})):
    res = BPEngine(BPConfig(scheduler=spec, scheduler_kwargs=kw, eps=1e-3,
                            max_rounds=6000)).run(g, jax.random.key(0))
    one[name] = dict(rounds=int(res.rounds), converged=bool(res.converged),
                     beliefs=np.asarray(res.beliefs).tolist())
out["dist_one"] = one

from repro.configs import get
from repro.models import build_model
out["n_params"] = {
    arch: int(sum(x.size for x in jax.tree.leaves(
        build_model(get(arch).reduced()).init_params(jax.random.key(0)))))
    for arch in ("qwen3_4b", "granite_moe_3b_a800m")}
with open(out_path, "w") as f:
    json.dump(out, f)
""" % dict(rbp=RBP_PINNED, eps=FIXED_EPS, size=DIST_SIZE)


# ---------------------------------------------------------------- parsers --

def parse_quickstart(text):
    rows = {}
    for m in re.finditer(r"^(\w+)\s+\((.*?)\)\s+(converged|STALLED)\s+"
                         r"rounds=\s*(\d+) committed-updates=\s*(\d+)",
                         text, re.M):
        rows[m[2]] = dict(converged=m[3] == "converged", rounds=int(m[4]),
                          updates=int(m[5]))
    return rows


def parse_stereo(text):
    head = re.search(r"converged=(\w+) rounds=(\d+)", text)
    acc = re.search(r"observation=([\d.]+) BP=([\d.]+)", text)
    en = re.search(r"truth=([-\d.]+) observation=([-\d.]+) BP=([-\d.]+)",
                   text)
    rows = text.split("(rows top to bottom):\n", 1)[1].split()
    return dict(converged=head[1], rounds=int(head[2]),
                accuracy=acc.groups(), energy=en.groups(), map=rows)


def parse_ldpc(text):
    """BER rows without the wall seconds."""
    return [line.split()[:-1] for line in text.splitlines()
            if re.match(r"\s+\d+\.\d\s", line)]


_REQ = re.compile(r"^req\s+(\d+) (\S+)\s+(ok|FAIL|EVIC)\s+rounds=\s*(\d+) "
                  r"latency=.*?(?: r(\d)([* ]))? P\(x0\)=\[(.*)\]$", re.M)
_STATS = re.compile(r"^chunks=(\d+) evacuated=(\d+) backfilled=(\d+) "
                    r"compactions=(\d+) admission_holds=(\d+) sweeps: "
                    r"device=(\d+) useful=(\d+) wasted=(\d+)$", re.M)


def parse_serving(text):
    reqs = {int(m[1]): dict(kind=m[2], tag=m[3], rounds=int(m[4]),
                            p_x0=[float(x) for x in m[7].split()])
            for m in _REQ.finditer(text)}
    served = re.search(r"served (\d+)/(\d+) converged", text)
    stats = _STATS.search(text)
    return dict(requests=reqs, converged=int(served[1]),
                total=int(served[2]),
                stats=None if stats is None else tuple(map(int,
                                                           stats.groups())),
                slo=re.search(r"attainment (\d+)/(\d+).*?(\d+) evicted",
                              text))


def parse_render(text):
    return [[c.strip() for c in line.strip("|").split("|")]
            for line in text.splitlines()
            if line.startswith("| ") and not line.startswith("| cell")]


# --------------------------------------------------------------- fixtures --

def _record(arch, shape, status, mesh="16x16", fits80=True, fits16=False,
            **terms):
    rec = dict(arch=arch, shape=shape, mesh=mesh, status=status)
    if status == "ok":
        rec.update(kind=terms.pop("kind"), bottleneck=terms.pop("dom"),
                   useful_ratio=terms.pop("useful"),
                   memory_per_device={"peak_ok_80GB": fits80,
                                      "peak_ok_16GB": fits16}, **terms)
    return rec


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """A dry run's records: two ``ok`` cells and a ``FAIL``, one ``ok``
    cell on the other mesh (left out of a ``16x16`` table)."""
    d = tmp_path_factory.mktemp("dryrun_torch")
    recs = [
        _record("qwen3_4b", "decode_32k", "ok", kind="decode", dom="memory",
                useful=0.4213, t_compute=2.1e-4, t_memory=9.07e-3,
                t_collective=4.2e-3),
        _record("bp_ising_512", "-", "ok", kind="bp", dom="collective",
                useful=0.0712, fits80=False, fits16=True, t_compute=0.0,
                t_memory=3.8e-4, t_collective=1.9),
        _record("gemma_7b", "train_4k", "FAIL"),
        _record("mamba2_130m", "decode_32k", "ok", mesh="2x16x16",
                kind="decode", dom="memory", useful=0.5, t_compute=1e-6,
                t_memory=2e-6, t_collective=3e-6),
    ]
    for i, rec in enumerate(recs):
        (d / f"{i}_{rec['arch']}.json").write_text(json.dumps(rec))
    return d


@pytest.fixture(scope="module")
def ref_proc(records, tmp_path_factory):
    """The reference subprocess, started at once; ``ref`` waits for it."""
    out = tmp_path_factory.mktemp("ref") / "ref.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO / "src"),
               OMP_NUM_THREADS="1")
    arg = json.dumps([JOBS, str(records), str(out)])
    proc = subprocess.Popen([sys.executable, "-c", _REF, arg], cwd=REPO,
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    yield proc, out
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def ref(ref_proc):
    """{job key: the reference driver's stdout, plus the extras}."""
    proc, out = ref_proc
    try:
        _, err = proc.communicate(timeout=REF_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise
    assert proc.returncode == 0, err[-4000:]
    return json.loads(out.read_text())


def _rank_main(rank, world, out_dir, size):
    """One rank of the gloo world: ``distributed_bp``'s driver, printing
    on rank 0; its results go to ``out_dir/rank<r>.pt``."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(f"{out_dir}/store", world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=60))
    try:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            out = distributed_bp.main(["--size", str(size)] + CPU)
        bits = lambda t: t.view(torch.int32)                # noqa: E731
        keep = dict(world=out["world"], stdout=buf.getvalue(),
                    banded=out["banded"], bitwise={}, sharded={})
        for name, row in out["sharded"].items():
            res, one = row["result"], out["one"][name]
            keep["bitwise"][name] = all(torch.equal(
                bits(getattr(res, f)), bits(getattr(one, f)))
                for f in ("logm", "beliefs")) and int(res.rounds) == \
                int(one.rounds)
            keep["sharded"][name] = dict(rounds=int(res.rounds),
                                         converged=bool(res.converged),
                                         beliefs=res.beliefs,
                                         logm=res.logm)
        torch.save(keep, f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def dist_world(ref_proc, tmp_path_factory):
    """[rank 0's results, rank 1's]: ``distributed_bp`` over two gloo
    ranks."""
    d = tmp_path_factory.mktemp("dist")
    ctx = mp.start_processes(_rank_main, args=(2, str(d), DIST_SIZE),
                             nprocs=2, join=False, start_method="spawn")
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    while not ctx.join(timeout=0.5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise AssertionError("the gloo world outlived its deadline")
    return [torch.load(d / f"rank{r}.pt", weights_only=False)
            for r in range(2)]


def drive(module, argv, capsys):
    """A port driver's ``main(argv + --device cpu)``: (returned, stdout)."""
    out = module.main(argv + CPU)
    return out, capsys.readouterr().out


# ------------------------------------------------------------------ tests --

@pytest.mark.parametrize("arch", ["qwen3_4b", "granite_moe_3b_a800m"])
def test_train_lm_resumes_exactly_and_learns(arch, capsys):
    out, text = drive(train_lm, ["--arch", arch] + TRAIN, capsys)
    assert "replay drift: 0.00e+00 (exact = 0)" in text
    assert out["drift"] == 0.0
    assert out["losses"][-1] < out["losses"][0]
    assert len(out["losses"]) == 6


def test_distributed_bp_sharded_bitwise_and_banded_parity(dist_world):
    r0, r1 = dist_world
    assert r0["world"] == r1["world"] == 2
    assert "devices: 2" in r0["stdout"] and r1["stdout"] == ""
    assert "edges over 2 shards" in r0["stdout"]
    for rank in dist_world:
        assert rank["bitwise"] == {"LBP": True, "RnBP": True}
        assert rank["banded"]["parity"] and rank["banded"]["converged"]
    for name in ("LBP", "RnBP"):
        assert torch.equal(r0["sharded"][name]["logm"],
                           r1["sharded"][name]["logm"])
    assert torch.equal(r0["banded"]["logm"], r1["banded"]["logm"])
    assert "round-parity-vs-ref=True" in r0["stdout"]
    assert "max-belief-diff-vs-ref=0.00e+00" in r0["stdout"]   # RnBP


@pytest.fixture(scope="module")
def quick(ref_proc):
    """quickstart's printed run and its RnBP rows at the fixed point, run
    while the reference's subprocess works."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = quickstart.main(CPU)
    rnbp = [e for e in quickstart.ENGINES if e[1] == "rnbp"]
    fixed = quickstart.run("cpu", eps=FIXED_EPS, engines=rnbp)
    pinned = quickstart.run("cpu", engines=[("RBP", "rbp",
                                             {"p": RBP_PINNED})])
    return out, buf.getvalue(), fixed, pinned


def test_quickstart_stalls_lbp_and_converges_the_others(quick, ref):
    out, text, _, _ = quick
    port, want = parse_quickstart(text), parse_quickstart(ref["quickstart"])
    assert list(port) == list(want) == [r[0].split("(")[1].rstrip(") ")
                                        for r in quickstart.ENGINES]
    lbp = "all messages"
    assert port[lbp] == want[lbp] == dict(converged=False, rounds=8000,
                                          updates=8000 * out["n_edges"])
    for name in list(port)[1:]:
        assert port[name]["converged"] and want[name]["converged"]
    assert "first 5 marginals P(x_i = 1):" in text


def test_quickstart_rbp_rounds_at_the_pinned_frontier(quick, ref):
    """RBP's greedy order turns a 1-ulp difference at a near-tie into
    another trajectory at the printed p = 1/128 (662 rounds here, 668 in
    the reference); at p = 1/48 the rounds agree, and ties admitted at the
    k-th residual keep the updates within 1 %."""
    row = quick[3]["rows"][0]
    rounds, updates, converged = ref["rbp_pinned"]
    assert row["converged"] and converged
    assert row["rounds"] == rounds
    assert abs(row["updates"] - updates) <= 0.01 * updates


def test_quickstart_marginals_at_the_fixed_point(quick, ref):
    out = quick[2]
    assert all(r["converged"] for r in out["rows"])
    for want in ref["fixed_point"].values():
        assert want["converged"]
    assert out["rnbp"]["converged"]
    want = np.asarray(ref["fixed_point"]["0.4"]["marginals"])
    assert out["marginals"].shape == want.shape
    assert np.abs(out["marginals"] - want).max() <= MARGINAL_TOL


@pytest.mark.parametrize("arch", ["qwen3_4b", "granite_moe_3b_a800m"])
def test_train_lm_parameter_count(arch, capsys, ref):
    out, text = drive(train_lm, ["--arch", arch, "--steps", "1", "--batch",
                                 "2", "--seq", "8"], capsys)
    assert out["n_params"] == ref["n_params"][arch]
    want = re.search(r"^(\S+): ([\d.]+)M params",
                     ref[f"train/{arch}"], re.M).groups()
    assert re.search(r"^(\S+): ([\d.]+)M params", text, re.M).groups() \
        == want
    assert "replay drift: 0.00e+00" in ref[f"train/{arch}"]


@pytest.mark.parametrize("sched", ["rbp", "lbp"])
def test_stereo_bp_decodes_as_the_reference(sched, capsys, ref):
    out, text = drive(stereo_bp, ["--scheduler", sched], capsys)
    port, want = parse_stereo(text), parse_stereo(ref[f"stereo/{sched}"])
    assert port == want
    assert port["converged"] == "True"
    assert out["accuracy"]["bp"] >= out["accuracy"]["observation"]
    assert out["energy"]["bp"] <= out["energy"]["truth"]


@pytest.mark.parametrize("sched", ["lbp", "rbp"])
def test_ldpc_decode_ber_table(sched, capsys, ref):
    argv = ["--words", "2"] + (["--scheduler", sched] if sched != "lbp"
                               else [])
    out, text = drive(ldpc_decode, argv, capsys)
    assert parse_ldpc(text) == parse_ldpc(ref[f"ldpc/{sched}"])
    assert len(out["rows"]) == 3
    assert sum(r["coded_ber"] < r["uncoded_ber"] for r in out["rows"]) >= 2


@pytest.mark.parametrize("key,argv", [
    ("serve/sync", SERVE), ("serve/async", SERVE + ["--async"]),
    ("serve/mixed", SERVE + ["--async", "--workload", "mixed",
                             "--requests", "10"])])
def test_bp_serving_lbp_matches_request_for_request(key, argv, capsys, ref):
    out, text = drive(bp_serving, argv, capsys)
    assert text.splitlines()[0] == "backend=ref device=cpu"
    port, want = parse_serving(text), parse_serving(ref[key])
    assert sorted(port["requests"]) == sorted(want["requests"])
    assert port["converged"] == want["converged"] == port["total"]
    for rid, w in want["requests"].items():
        p = port["requests"][rid]
        assert (p["kind"], p["tag"], p["rounds"]) == \
            (w["kind"], w["tag"], w["rounds"]), rid
        np.testing.assert_allclose(p["p_x0"], w["p_x0"], atol=1.01e-3)
    assert port["stats"] == want["stats"] is not None
    assert out["stats"]["device_sweeps"] == port["stats"][5]


def test_bp_serving_deadline_policy_rounds_and_status(capsys, ref):
    argv = SERVE + ["--async", "--policy", "deadline", "--slo-ms", "1e6"]
    _, text = drive(bp_serving, argv, capsys)
    port, want = parse_serving(text), parse_serving(ref["serve/deadline"])
    assert {r: (v["tag"], v["rounds"]) for r, v in
            port["requests"].items()} == \
        {r: (v["tag"], v["rounds"]) for r, v in want["requests"].items()}
    assert port["slo"].groups() == want["slo"].groups()


def test_bp_serving_routed_with_stealing(capsys, ref):
    """Routed runs depend on the replicas' interleaving in both packages:
    rounds, P(x0) and status per rid only."""
    out, text = drive(bp_serving, SERVE + STEAL, capsys)
    port, want = parse_serving(text), parse_serving(ref["serve/steal"])
    assert sorted(port["requests"]) == sorted(want["requests"])
    for rid, w in want["requests"].items():
        p = port["requests"][rid]
        assert (p["tag"], p["rounds"]) == (w["tag"], w["rounds"]), rid
        np.testing.assert_allclose(p["p_x0"], w["p_x0"], atol=1.01e-3)
    assert "replicas=2 routed=" in text
    assert out["stats"]["replicas"] == 2


def test_bp_serving_default_rnbp_converges_alike(capsys, ref):
    _, text = drive(bp_serving, ["--requests", "6"], capsys)
    port, want = parse_serving(text), parse_serving(ref["serve/rnbp"])
    assert port["converged"] == want["converged"] == 6


def test_bp_serving_backend_is_taken_as_given(capsys):
    out, text = drive(bp_serving, ["--requests", "2", "--backend", "pallas",
                                   "--scheduler", "lbp"], capsys)
    assert text.splitlines()[0] == "backend=pallas device=cpu"
    assert out["backend"] == "pallas" and out["converged"] == 2


def test_bp_serving_choices_come_from_the_registries():
    from repro_torch.core import (list_admission_policies, list_backends,
                                  list_schedulers)
    from repro_torch.pgm import list_workloads
    from repro_torch.serve import list_routing_policies
    acts = {a.dest: a for a in bp_serving.parser()._actions}
    assert acts["policy"].choices == list_admission_policies()
    assert acts["scheduler"].choices == list_schedulers()
    assert acts["backend"].choices == list_backends()
    assert acts["routing"].choices == list_routing_policies()
    assert acts["workload"].choices == ["legacy", "mixed"] + list_workloads()


def test_distributed_bp_within_the_reference(dist_world, ref):
    """The reference's own sharded path fails on the installed jax: the
    port's sharded runs are held against its one-device beliefs."""
    r0 = dist_world[0]
    for name, want in ref["dist_one"].items():
        s = r0["sharded"][name]
        assert s["converged"] and want["converged"]
        b = np.exp(s["beliefs"].numpy())
        w = np.exp(np.asarray(want["beliefs"], dtype=np.float32))
        assert np.abs(b - w).max() <= TOL
    assert r0["sharded"]["LBP"]["rounds"] == ref["dist_one"]["LBP"]["rounds"]
    assert r0["banded"]["rounds"] == ref["dist_one"]["LBP"]["rounds"]


def test_render_roofline_rows_match_the_reference(records, capsys, ref):
    table = render_roofline.render(d=str(records), mesh_filter="16x16")
    text = capsys.readouterr().out
    port, want = parse_render(text), parse_render(ref["render"])
    assert len(port) == len(want) == 2
    assert [r[:-1] for r in port] == [r[:-1] for r in want]
    assert [r[-1] for r in port] == ["yes", "NO"]       # peak_ok_80GB
    assert [r[-1] for r in want] == ["NO", "yes"]       # peak_ok_16GB
    assert "fits 80GB" in text and "H100 SXM5" in text
    assert "TPU" not in text
    assert [r["cell"] for r in table] == ["qwen3_4b x decode_32k",
                                          "bp_ising_512 x -"]
