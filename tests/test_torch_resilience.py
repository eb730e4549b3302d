"""Checkpoints and resilient runs: the port's ``repro_torch.checkpoint``
and ``repro_torch.ft`` against the reference's, and against the port's
own monolithic engine runs.

- A numpy tree saved by either package gives the same layout (the
  ``step_%09d`` directory, the manifest's keys, shapes, dtypes and extra,
  the npz's keys and arrays); each package restores what the other wrote.
  A stale ``.tmp`` directory is ignored, and overwritten on the next save.
- ``run_bp_resilient`` is bitwise the monolithic ``engine.run`` when
  chunked, when resumed from a mid-run checkpoint after the later ones are
  deleted, and after a crash between chunks (the generator's state rides
  in the checkpoint). LBP through it gives the reference's rounds and
  beliefs within 1e-4. The legacy ``{logm, sstate}`` checkpoint resumes.
- ``StragglerMonitor`` gives the reference's events and EWMA on the same
  wall-time sequence.
"""

import dataclasses
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

from repro import checkpoint as JC
from repro.ft import StragglerMonitor as JMonitor
from repro.ft import run_bp_resilient as j_run_bp_resilient
from repro.pgm import datasets as JD
from repro_torch import checkpoint as TC
from repro_torch.core import BPConfig, BPEngine
from repro_torch.core.graph import PGM
from repro_torch.core.schedulers import RnBP
from repro_torch.ft import StragglerMonitor, run_bp_resilient
from repro_torch.pgm import datasets as TD

CPU = "cpu"
RNBP = RnBP(low_p=0.4, high_p=0.9)


def np_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"logm": rng.normal(size=(6, 3)).astype(np.float32),
            "sstate": (rng.integers(0, 9, 4).astype(np.int32),
                       {"q": rng.random(2), "b": np.array([True, False])}),
            "rng": rng.integers(0, 255, 16).astype(np.uint8),
            "rounds": np.int32(7), "none": None, "list": [np.zeros(1)]}


def read(path):
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "data.npz")) as data:
        return manifest, {k: data[k] for k in data.files}


def assert_tree_equal(a, b):
    assert type(a) is type(b) or (np.isscalar(a) or isinstance(
        a, np.ndarray)), (type(a), type(b))
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            assert_tree_equal(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_tree_equal(x, y)
    elif a is None:
        assert b is None
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def test_same_layout_and_manifest_as_reference(tmp_path):
    tree = np_tree()
    jpath = JC.save_pytree(str(tmp_path / "j"), 12, tree, extra={"a": 1})
    tpath = TC.save_pytree(str(tmp_path / "t"), 12, tree, extra={"a": 1})
    assert os.path.basename(jpath) == os.path.basename(tpath) == \
        "step_000000012"
    assert sorted(os.listdir(jpath)) == sorted(os.listdir(tpath)) == [
        "data.npz", "manifest.json"]
    jm, jd = read(jpath)
    tm, td = read(tpath)
    assert tm == jm
    assert sorted(td) == sorted(jd) == jm["keys"]
    assert "['sstate']/[1]/['b']" in jm["keys"]
    for k in jd:
        assert td[k].dtype == jd[k].dtype
        np.testing.assert_array_equal(td[k], jd[k])
    assert JC.latest_step(str(tmp_path / "j")) == \
        TC.latest_step(str(tmp_path / "t")) == 12


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_each_package_restores_the_others_tree(tmp_path, writer):
    tree = np_tree(1)
    save, restore = ((JC.save_pytree, TC.restore_pytree)
                     if writer == "reference"
                     else (TC.save_pytree, JC.restore_pytree))
    save(str(tmp_path), 3, tree, extra={"rounds": 3})
    got, extra = restore(str(tmp_path), 3, np_tree(2))
    assert extra == {"rounds": 3}
    assert_tree_equal(got, tree)


def test_torch_tree_round_trip_and_missing_key(tmp_path):
    @dataclasses.dataclass(frozen=True)
    class Carry:
        a: torch.Tensor
        b: tuple
    tree = {"c": Carry(torch.arange(6.0).reshape(2, 3),
                       (torch.tensor([True, False]), None)),
            "g": torch.Generator().manual_seed(3).get_state()}
    TC.save_pytree(str(tmp_path), 5, tree)
    like = {"c": Carry(torch.zeros(2, 3), (torch.zeros(2, dtype=torch.bool),
                                           None)),
            "g": torch.Generator().get_state()}
    got, extra = TC.restore_pytree(str(tmp_path), 5, like)
    assert extra == {} and isinstance(got["c"], Carry)
    assert torch.equal(got["c"].a, tree["c"].a)
    assert torch.equal(got["c"].b[0], tree["c"].b[0]) and got["c"].b[1] is None
    assert torch.equal(got["g"], tree["g"])
    with pytest.raises(KeyError):
        TC.restore_pytree(str(tmp_path), 5, {"missing": torch.zeros(1)})
    with pytest.raises(ValueError, match="shape"):
        TC.restore_pytree(str(tmp_path), 5, {"g": torch.zeros(3)})


def test_stale_tmp_is_ignored_and_replaced(tmp_path):
    d = str(tmp_path)
    assert TC.latest_step(d + "/nowhere") is None
    TC.save_pytree(d, 4, {"x": np.ones(2)})
    os.makedirs(os.path.join(d, "step_000000009.tmp"))  # a crash mid-save
    with open(os.path.join(d, "step_000000009.tmp", "junk"), "w") as f:
        f.write("partial")
    assert TC.latest_step(d) == JC.latest_step(d) == 4
    TC.save_pytree(d, 9, {"x": np.zeros(2)})
    assert TC.latest_step(d) == 9
    assert sorted(os.listdir(d)) == ["step_000000004", "step_000000009"]
    got, _ = TC.restore_pytree(d, 9, {"x": np.ones(2)})
    np.testing.assert_array_equal(got["x"], np.zeros(2))


def monolithic(pgm, max_rounds=400, seed=0):
    eng = BPEngine(BPConfig(scheduler=RNBP, eps=1e-3, max_rounds=max_rounds),
                   device=CPU)
    return eng.run(pgm, torch.Generator().manual_seed(seed))


def assert_same_run(got, want, rounds=None):
    for f in ("logm", "beliefs", "updates", "converged", "max_residual",
              "unconverged_history"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert int(got.rounds) == (int(want.rounds) if rounds is None
                               else rounds)


@pytest.fixture(scope="module")
def grid():
    pgm = TD.ising_grid(8, 2.5, seed=0, device=CPU)
    return pgm, monolithic(pgm)


@pytest.mark.parametrize("chunk", [1, 7, 1000])
def test_chunked_resilient_run_is_bitwise_monolithic(grid, tmp_path, chunk):
    pgm, want = grid
    assert int(want.rounds) > 7 and bool(want.converged)
    mon = StragglerMonitor()
    got = run_bp_resilient(pgm, RNBP, torch.Generator().manual_seed(0),
                           max_rounds=400, rounds_per_chunk=chunk,
                           ckpt_dir=str(tmp_path), monitor=mon, device=CPU)
    assert_same_run(got, want)
    # one monitor sample per step; one checkpoint per distinct round count
    eng = BPEngine(BPConfig(scheduler=RNBP, eps=1e-3, max_rounds=400,
                            chunk_rounds=chunk), device=CPU)
    state, rounds = eng.init(pgm, torch.Generator().manual_seed(0)), []
    while not eng.finished(state):
        state = eng.step(state)
        rounds.append(int(state.rounds))
    assert mon.rounds == len(rounds)
    assert sorted(os.listdir(tmp_path)) == [f"step_{r:09d}"
                                            for r in sorted(set(rounds))]


def test_resume_from_a_mid_run_checkpoint_is_bitwise(grid, tmp_path):
    pgm, want = grid
    d = str(tmp_path)
    run_bp_resilient(pgm, RNBP, torch.Generator().manual_seed(0),
                     max_rounds=400, rounds_per_chunk=5, ckpt_dir=d,
                     device=CPU)
    steps = sorted(int(n.split("_")[1]) for n in os.listdir(d))
    mid = steps[len(steps) // 2]
    for s in steps:
        if s > mid:
            shutil.rmtree(os.path.join(d, f"step_{s:09d}"))
    got = run_bp_resilient(pgm, RNBP, torch.Generator().manual_seed(99),
                           max_rounds=400, rounds_per_chunk=5, ckpt_dir=d,
                           device=CPU)
    assert_same_run(got, want, rounds=int(want.rounds) - mid)
    again = run_bp_resilient(pgm, RNBP, torch.Generator(), max_rounds=400,
                             rounds_per_chunk=5, ckpt_dir=d, device=CPU)
    assert int(again.rounds) == 0 and torch.equal(again.logm, want.logm)


class Crash(Exception):
    pass


class CrashingMonitor(StragglerMonitor):
    """Raises at the given chunk, before that chunk's checkpoint."""

    def __init__(self, at):
        super().__init__()
        self.at = at

    def record(self, wall_s):
        if self.rounds + 1 == self.at:
            raise Crash()
        return super().record(wall_s)


def test_crash_and_resume_is_bitwise(grid, tmp_path):
    pgm, want = grid
    d = str(tmp_path)
    with pytest.raises(Crash):
        run_bp_resilient(pgm, RNBP, torch.Generator().manual_seed(0),
                         max_rounds=400, rounds_per_chunk=4, ckpt_dir=d,
                         monitor=CrashingMonitor(3), device=CPU)
    assert TC.latest_step(d) == 8
    got = run_bp_resilient(pgm, RNBP, torch.Generator().manual_seed(0),
                           max_rounds=400, rounds_per_chunk=4, ckpt_dir=d,
                           device=CPU)
    assert_same_run(got, want, rounds=int(want.rounds) - 8)


def test_legacy_checkpoint_resumes_messages(tmp_path):
    pgm = TD.ising_grid(6, 2.0, seed=1, device=CPU)
    eng = BPEngine(BPConfig(scheduler="lbp", eps=1e-4, max_rounds=400,
                            chunk_rounds=3), device=CPU)
    state = eng.step(eng.init(pgm, torch.Generator()))
    TC.save_pytree(str(tmp_path), 3, {"logm": state.logm,
                                      "sstate": state.sched_state},
                   extra={"rounds": 3})
    got = run_bp_resilient(pgm, "lbp", torch.Generator(), eps=1e-4,
                           max_rounds=400, rounds_per_chunk=3,
                           ckpt_dir=str(tmp_path), device=CPU)
    want = eng.run(pgm, torch.Generator())
    assert torch.equal(got.logm, want.logm)
    assert int(got.rounds) == int(want.rounds) - 3


def bridge(jpgm):
    return PGM.from_numpy(vars(jpgm), jpgm.n_real_vertices, jpgm.n_real_edges,
                          device=CPU,
                          edge_count=int(jpgm.traced_edge_count()),
                          vertex_count=int(jpgm.traced_vertex_count()))


def test_lbp_resilient_matches_reference(tmp_path):
    jpgm = JD.ising_grid(7, 2.0, seed=2)
    want = j_run_bp_resilient(jpgm, "lbp", jax.random.key(0), eps=1e-4,
                              rounds_per_chunk=6,
                              ckpt_dir=str(tmp_path / "j"))
    got = run_bp_resilient(bridge(jpgm), "lbp", torch.Generator(), eps=1e-4,
                           rounds_per_chunk=6, ckpt_dir=str(tmp_path / "t"),
                           device=CPU)
    assert int(got.rounds) == int(want.rounds)
    np.testing.assert_allclose(np.exp(got.beliefs.numpy()),
                               np.exp(np.asarray(want.beliefs)), atol=1e-4)
    assert sorted(os.listdir(tmp_path / "t")) == \
        sorted(os.listdir(tmp_path / "j"))
    jm, _ = read(str(tmp_path / "j" / sorted(os.listdir(tmp_path / "j"))[0]))
    tm, _ = read(str(tmp_path / "t" / sorted(os.listdir(tmp_path / "t"))[0]))
    assert tm["extra"] == jm["extra"]
    # the port's payload keys: the reference's, with the generator state
    # under "rng" and LBP's empty scheduler state holding no leaf
    assert tm["keys"] == jm["keys"]


@pytest.mark.parametrize("seed", [0, 1])
def test_straggler_monitor_matches_reference(seed):
    rng = np.random.default_rng(seed)
    walls = list(rng.uniform(0.5, 1.5, 40))
    walls[5] = walls[17] = 9.0
    walls[0] = 0.0                       # a zero first sample re-seeds
    kw = dict(budget_factor=2.5, alpha=0.3)
    j, t = JMonitor(**kw), StragglerMonitor(**kw)
    assert [t.record(w) for w in walls] == [j.record(w) for w in walls]
    assert (t.events, t.rounds, t.ewma) == (j.events, j.rounds, j.ewma)
    assert t.events >= 2

