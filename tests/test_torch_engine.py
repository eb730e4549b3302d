"""The port's ``BPEngine`` (on CPU) against the reference's.

Identical graphs go to both packages through the numpy bridge.

- LBP, RBP and RS are deterministic: equal rounds, update counts within
  1%, marginals within 1e-4 (float32 exp/log implementations differ).
- RnBP draws from different generators in the two packages, so the runs
  differ; both must converge at eps=1e-5 to marginals within 1e-3.
- Max-product is exact arithmetic: the MAP assignment must be equal.
- Within the port, chunked ``step`` is bitwise equal to one ``run``.
- ``BPConfig.to_dict()`` is equal across the two packages.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro.core import BPConfig as JConfig
from repro.core import BPEngine as JEngine
from repro.core import messages as JM
from repro.core.schedulers import RnBP as JRnBP
from repro.pgm import datasets as JD
from repro_torch.core import BPConfig as TConfig
from repro_torch.core import BPEngine as TEngine
from repro_torch.core import messages as TM
from repro_torch.core.graph import PGM
from repro_torch.core.schedulers import RnBP as TRnBP
from repro_torch.kernels.ops import make_triton_update


GRAPHS = {
    "ising": lambda: JD.ising_grid(8, 2.0, seed=0),
    "chain": lambda: JD.chain_graph(300, seed=0),
    "protein": lambda: JD.protein_like_graph(40, seed=0),
}


def bridge(jpgm):
    """The reference graph's arrays, carried into the port."""
    return PGM.from_numpy(vars(jpgm), jpgm.n_real_vertices,
                          jpgm.n_real_edges, device="cpu")


@pytest.fixture(scope="module", params=sorted(GRAPHS))
def graphs(request):
    jpgm = GRAPHS[request.param]()
    return request.param, jpgm, bridge(jpgm)


def gen(seed=0):
    return torch.Generator().manual_seed(seed)


def marginals_close(jres, tres, tol):
    a = np.exp(np.asarray(jres.beliefs))
    b = np.exp(tres.beliefs.numpy())
    assert np.abs(a - b).max() <= tol


# RBP frontier multiplier per graph: every run converges, and the rounds
# agree. RBP's greedy order turns a 1-ulp exp/log difference at a near-tie
# into another trajectory, so some (graph, p) pairs end a few rounds apart
# (ROADMAP queue 3); these do not.
RBP_P = {"ising": 1 / 256, "chain": 1 / 32, "protein": 1 / 64}


@pytest.mark.parametrize("sched", ["lbp", "rbp", "rs"])
def test_deterministic_schedulers_match_reference(graphs, sched):
    name, jpgm, tpgm = graphs
    kw = {"p": RBP_P[name]} if sched == "rbp" else {}
    cfg = dict(scheduler=sched, scheduler_kwargs=kw, eps=1e-3,
               max_rounds=2000)
    jres = JEngine(JConfig(**cfg)).run(jpgm, jax.random.key(0))
    tres = TEngine(TConfig(**cfg), device="cpu").run(tpgm, gen())
    assert int(tres.rounds) == int(jres.rounds)
    assert bool(tres.converged) and bool(jres.converged)
    # RBP/RS admit every tie at the k-th residual; float32 differences in
    # the residuals can move a tie, so update counts agree to 1%.
    assert abs(int(tres.updates) - int(jres.updates)) <= \
        0.01 * int(jres.updates)
    marginals_close(jres, tres, 1e-4)
    assert tres.beliefs.shape == (tpgm.n_vertices, tpgm.n_states_max)


def test_kernel_backend_matches_reference_kernel_backend():
    """The reference's "triton" backend (Pallas interpret mode) against the
    port's "triton" backend (the kernel's plain version on CPU)."""
    jpgm = JD.ising_grid(6, 2.0, seed=1)
    cfg = dict(scheduler="lbp", eps=1e-3, max_rounds=200, backend="triton")
    jres = JEngine(JConfig(**cfg)).run(jpgm, jax.random.key(0))
    tres = TEngine(TConfig(**cfg), device="cpu").run(bridge(jpgm), gen())
    assert int(tres.rounds) == int(jres.rounds) and bool(tres.converged)
    marginals_close(jres, tres, 1e-4)


def test_rnbp_reaches_reference_fixed_point(graphs):
    name, jpgm, tpgm = graphs
    kw = {"low_p": 0.4, "high_p": 0.9}
    cfg = dict(scheduler="rnbp", scheduler_kwargs=kw, eps=1e-5,
               max_rounds=3000)
    jres = JEngine(JConfig(**cfg)).run(jpgm, jax.random.key(0))
    tres = TEngine(TConfig(**cfg, backend="triton"), device="cpu").run(tpgm, gen(7))
    assert bool(jres.converged) and bool(tres.converged), name
    marginals_close(jres, tres, 1e-3)


def test_max_product_map_matches_reference():
    jpgm = JD.ising_grid(7, 1.0, seed=2)
    tpgm = bridge(jpgm)
    cfg = dict(scheduler="lbp", eps=1e-4, max_rounds=300)
    jres = JEngine(JConfig(**cfg, backend="maxprod")).run(jpgm,
                                                          jax.random.key(0))
    for backend in ("maxprod", make_triton_update(semiring="max")):
        tres = TEngine(TConfig(**cfg, backend=backend),
                       device="cpu").run(tpgm, gen())
        assert int(tres.rounds) == int(jres.rounds)
        assert np.array_equal(
            np.asarray(JM.map_assignment(jpgm, jres.logm)),
            TM.map_assignment(tpgm, tres.logm).numpy())


def _fields(res):
    return [res.logm, res.rounds, res.updates, res.converged,
            res.max_residual, res.unconverged_history, res.beliefs]


@pytest.mark.parametrize("sched,kw,chunk", [
    ("lbp", {}, 7), ("rbp", {"p": 0.05}, 5), ("rs", {}, 5),
    ("rnbp", {"low_p": 0.4, "high_p": 0.9}, 7),
    ("rnbp", {"low_p": 0.4, "high_p": 0.9}, 40)])
def test_chunked_step_bitwise_equals_run(sched, kw, chunk):
    tpgm = bridge(JD.ising_grid(8, 2.5, seed=3))
    cfg = TConfig(scheduler=sched, scheduler_kwargs=kw, eps=1e-3,
                  max_rounds=300, backend="triton")
    eng = TEngine(cfg, device="cpu")
    whole = eng.run(tpgm, gen(5))
    state = eng.init(tpgm, gen(5))
    steps = 0
    while not eng.finished(state):
        state = eng.step(state, chunk_rounds=chunk)
        steps += 1
    parts = eng.result(state)
    assert steps > 1
    for a, b in zip(_fields(whole), _fields(parts)):
        assert torch.equal(a, b)
    if sched == "rnbp":
        assert torch.equal(whole.sched_state, parts.sched_state)
    # a finished state is a no-op
    again = eng.step(state)
    assert torch.equal(again.logm, state.logm) and int(again.chunk_iters) == 0


def test_chunk_iters_and_history():
    tpgm = bridge(JD.chain_graph(100, seed=1))
    eng = TEngine(TConfig(scheduler="lbp", eps=1e-3, max_rounds=100),
                  device="cpu")
    state = eng.step(eng.init(tpgm, gen()), chunk_rounds=10)
    assert int(state.rounds) == 10 and int(state.chunk_iters) == 10
    res = eng.run(tpgm, state=state)
    hist = res.unconverged_history.numpy()
    r = int(res.rounds)
    assert hist.shape == (100,) and np.all(hist[:r] > 0)
    assert hist[r] == 0 and np.all(hist[r + 1:] == -1)


def test_resume_reference_trajectory_in_port():
    """The messages bridge: the reference runs the first rounds, the port
    resumes from its messages and lands where the reference does."""
    jpgm = JD.ising_grid(8, 2.0, seed=0)
    tpgm = bridge(jpgm)
    jeng = JEngine(JConfig(scheduler="lbp", eps=1e-3, max_rounds=600))
    full = jeng.run(jpgm, jax.random.key(0))
    head = jeng.step(jeng.init(jpgm, jax.random.key(0)), chunk_rounds=6)
    teng = TEngine(TConfig(scheduler="lbp", eps=1e-3, max_rounds=600),
                   device="cpu")
    tail = teng.run(tpgm, state=teng.init(tpgm, gen(),
                                          logm=np.asarray(head.logm)))
    assert 6 + int(tail.rounds) == int(full.rounds)
    marginals_close(full, tail, 1e-4)
    state = teng.init(tpgm, gen(), logm=tail.logm)
    assert np.array_equal(state.messages_numpy(), tail.logm.numpy())


CONFIGS = [
    dict(),
    dict(scheduler="rnbp", scheduler_kwargs={"low_p": 0.4, "high_p": 0.9},
         eps=1e-4, max_rounds=500, backend="triton"),
    dict(scheduler="RS", damping=0.25, chunk_rounds=32, history=False),
    dict(scheduler="rbp", scheduler_kwargs={"p": 0.01}, backend="maxprod",
         admission="deadline", admission_kwargs={"slack": 2.0}),
]


@pytest.mark.parametrize("kw", CONFIGS)
def test_config_to_dict_identical(kw):
    jd, td = JConfig(**kw).to_dict(), TConfig(**kw).to_dict()
    assert json.dumps(jd) == json.dumps(td)
    assert TConfig.from_dict(jd) == TConfig(**kw)
    assert JConfig.from_dict(td) == JConfig(**kw)


def test_config_scheduler_instance_serializes_identically():
    jd = JConfig(scheduler=JRnBP(low_p=0.2)).to_dict()
    td = TConfig(scheduler=TRnBP(low_p=0.2)).to_dict()
    assert json.dumps(jd) == json.dumps(td)


def test_config_validation_matches_reference():
    for bad in (dict(eps=0), dict(max_rounds=0), dict(damping=1.0),
                dict(chunk_rounds=0)):
        with pytest.raises(ValueError) as je:
            JConfig(**bad)
        with pytest.raises(ValueError) as te:
            TConfig(**bad)
        assert str(je.value) == str(te.value)
    assert [f.name for f in dataclasses.fields(TConfig)] == \
        [f.name for f in dataclasses.fields(JConfig)]


def test_unported_paths_raise():
    tpgm = bridge(JD.ising_grid(3, 2.0))
    with pytest.raises(NotImplementedError, match="queue 1, item 6"):
        TEngine(TConfig(scheduler="srbp"), device="cpu")
    with pytest.raises(NotImplementedError, match="queue 1, item 8"):
        TEngine(TConfig(batch_backend="triton"), device="cpu")
    eng = TEngine(TConfig(), device="cpu")
    with pytest.raises(NotImplementedError, match="BatchedPGM"):
        eng.init([tpgm, tpgm], gen())
    with pytest.raises(ValueError, match="rng"):
        eng.run(tpgm)
    with pytest.raises(TypeError, match="torch.Generator"):
        eng.run(tpgm, 0)
    with pytest.raises(KeyError, match="unknown update backend 'pallas'"):
        TEngine(TConfig(backend="pallas"), device="cpu")
