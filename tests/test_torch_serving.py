"""The serving pipeline: the port's ``repro_torch.core.serving`` and
``BPEngine.serve`` against the reference's, and against its own
``run_many``.

Across the two packages (identical graphs through ``PGM.from_numpy``; the
reference on the CPU, the port on its plain path):

- LBP is deterministic, so serving a stream gives the reference's rounds
  per request, beliefs within 1e-4, and the same ``AsyncServeStats`` field
  by field -- chunks, sweeps, evacuations, backfills, compactions and
  their logs;
- the deadline policy under a ``SweepClock`` gives the reference's
  timeline (rid, status, enqueue/admit/done times, rounds) bitwise,
  including the eviction at ``t_done == 64.0`` with 32 rounds and the
  staged eviction's prior beliefs (within 1e-6);
- admission scores are the reference's bitwise; registry and validation
  errors carry the reference's texts.

Within the port, where the draws are its own: ``serve_async``,
``engine.serve`` and ``run_many`` are bitwise equal per request on
same-shape groups (RnBP, rlx), whatever the admission policy, slot count
or compaction; compaction keeps trajectories; threaded ingestion serves
bitwise and shuts its threads down.
"""

import dataclasses
import threading
import time

import jax
import numpy as np
import pytest
import torch
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

from repro.core import BPConfig as JConfig
from repro.core import BPEngine as JEngine
from repro.core import serving as JS
from repro.core.graph import pad_pgm_arrays as j_pad_arrays
from repro.pgm import datasets as JD
from repro_torch.core import BatchedPGM, BPConfig, BPEngine, slot_generator
from repro_torch.core import serving as TS
from repro_torch.core.graph import PGM, pad_pgm, pad_pgm_arrays
from repro_torch.pgm import datasets as TD

CPU = "cpu"
STATS = ("chunks", "device_sweeps", "useful_sweeps", "evacuated",
         "backfilled", "compactions", "buckets_opened", "staged",
         "admission_widths", "evacuation_log", "compaction_log",
         "evictions", "evicted_sweeps", "eviction_log", "policy")


def bridge(jpgm):
    return PGM.from_numpy(vars(jpgm), jpgm.n_real_vertices, jpgm.n_real_edges,
                          device=CPU,
                          edge_count=int(jpgm.traced_edge_count()),
                          vertex_count=int(jpgm.traced_vertex_count()))


def straggler_stream():
    """Eight fast Ising graphs and one that stalls to max_rounds, one
    shape family (the reference's ``_straggler_stream``)."""
    fast = [JD.ising_grid(8, 1.5, seed=s) for s in range(8)]
    return fast[:4] + [JD.ising_grid(8, 3.5, seed=0)] + fast[4:]


def mixed_stream():
    """The mixed-shape stream of the reference's parity test."""
    return [JD.ising_grid(6, 2.0, seed=1), JD.chain_graph(40, seed=2),
            JD.ising_grid(7, 2.0, seed=3), JD.chain_graph(50, seed=4),
            JD.chain_graph(45, seed=5), JD.ising_grid(6, 2.2, seed=6),
            JD.chain_graph(60, seed=7)]


def engines(**cfg):
    return JEngine(JConfig(**cfg)), BPEngine(BPConfig(**cfg), device=CPU)


def timeline(rep):
    return [(r.rid, r.status, r.t_enqueue, r.t_admit, r.t_done,
             int(r.result.rounds)) for r in rep.records]


def assert_same_stats(jstats, tstats):
    for f in STATS:
        assert getattr(jstats, f) == getattr(tstats, f), f


def assert_beliefs_close(jres, tres, atol=1e-4):
    for a, b in zip(jres, tres):
        assert int(a.rounds) == int(b.rounds)
        assert bool(a.converged) == bool(b.converged)
        np.testing.assert_allclose(np.exp(np.asarray(a.beliefs)),
                                   np.exp(b.beliefs.numpy()), atol=atol)


def assert_bitwise(got, want):
    """Every field bitwise; beliefs over ``want``'s vertices (the online
    path pads the vertex axis to its pow2 ceiling)."""
    for f in ("logm", "rounds", "updates", "converged", "max_residual",
              "unconverged_history"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert torch.equal(got.beliefs[:want.beliefs.shape[0]], want.beliefs)


# ------------------------------------------------- across the two packages --

@pytest.fixture(scope="module")
def straggler():
    jpgms = straggler_stream()
    return jpgms, [bridge(p) for p in jpgms]


@pytest.mark.parametrize("how", ["async_slots1", "async_slots2", "serve",
                                 "online"])
def test_lbp_straggler_stream_matches_reference(straggler, how):
    """LBP at eps=1e-4: equal rounds per request, beliefs within 1e-4 and
    identical stats, through every entry point. (At eps=1e-5 one of these
    graphs ends a round apart between the packages in a plain solo run --
    float32 rounding near eps, witnessed in float64 by
    ``test_straggler_eps_1e5_round_difference_is_float32_rounding`` -- so
    serving is held at 1e-4.)"""
    jpgms, tpgms = straggler
    je, te = engines(scheduler="lbp", eps=1e-4, max_rounds=320,
                     history=False)
    if how == "serve":
        kw = dict(max_batch=3, chunk_rounds=48)
        jr, tr = je.serve(jpgms, jax.random.key(0), **kw), \
            te.serve(tpgms, 0, **kw)
        assert isinstance(tr.stats, TS.AsyncServeStats)
    else:
        kw = dict(max_batch=3, chunk_rounds=64, compact=True,
                  slots=2 if how == "async_slots2" else 1)
        if how == "online":
            kw.update(prefetch=4, slots=2)
            jpgms, tpgms = iter(jpgms), iter(tpgms)
        jr = JS.serve_async(je, jpgms, jax.random.key(0), **kw)
        tr = TS.serve_async(te, tpgms, 0, **kw)
        assert [r.rid for r in jr.records] == [r.rid for r in tr.records]
    assert_beliefs_close(jr.results, tr.results)
    assert_same_stats(jr.stats, tr.stats)
    if how != "serve":
        assert tr.stats.compactions >= 1


def lbp_float64(jpgm, eps, max_rounds):
    """LBP with the reference's semantics in float64 numpy: every edge
    commits each round, and the run stops at the first round in which no
    real edge's residual reaches ``eps``. Returns the committed rounds and
    each round's largest residual."""
    a = {k: np.asarray(v) for k, v in vars(jpgm).items()}
    src, dst, rev, em = (a[k] for k in ("edge_src", "edge_dst", "edge_rev",
                                        "edge_mask"))
    lpe, lpv = a["log_psi_e"].astype(np.float64), \
        a["log_psi_v"].astype(np.float64)
    sm, neg = a["state_mask"], -1e30
    dmask = sm[dst]

    def lse(x, mask, axis):
        x = np.where(mask, x, neg)
        m = np.maximum(x.max(axis=axis, keepdims=True), neg)
        t = np.where(mask, np.exp(x - m), 0.0).sum(axis=axis)
        return np.squeeze(m, axis) + np.log(np.maximum(t, 1e-38))
    logm = np.where(dmask, -np.log(a["n_states"][dst].astype(np.float64))
                    [:, None], neg)
    hist = []
    for rnd in range(max_rounds):
        vsum = np.zeros(lpv.shape)
        np.add.at(vsum, dst, np.where(em[:, None], logm, 0.0))
        pre = np.where(sm[src], lpv[src] + vsum[src] - logm[rev], neg)
        cand = lse(lpe + pre[:, :, None], np.ones(lpe.shape, bool), 1)
        cand = np.where(dmask, cand - lse(cand, dmask, 1)[:, None], neg)
        r = np.where(em, np.where(dmask, np.abs(cand - logm), 0).max(1), 0)
        hist.append(float(r.max()))
        if not ((r >= eps) & em).any():
            return rnd, hist
        logm = cand
    return max_rounds, hist


def test_straggler_eps_1e5_round_difference_is_float32_rounding():
    """The one straggler-stream graph whose LBP at eps=1e-5 ends a round
    apart: the reference stops after 17 rounds, the port after 16. The
    same semantics in float64 stop after 17, with a largest residual just
    above eps at round 16; each package's float32 residual there lies
    within 4 % of it (a few float32 ulps of messages near log(1/2)), on
    either side of eps. So the reference's count is the exact one and the
    port's is float32 rounding near eps, which is why the stream tests
    above run at eps=1e-4."""
    eps = 1e-5
    jg = JD.ising_grid(8, 1.5, seed=1)
    rounds64, hist = lbp_float64(jg, eps, 60)
    assert rounds64 == 17 and eps < hist[16] < 1.04 * eps
    je, te = engines(scheduler="lbp", eps=eps, max_rounds=60)
    tg = bridge(jg)
    assert int(je.run(jg, jax.random.key(0)).rounds) == 17
    assert int(te.run(tg, torch.Generator().manual_seed(0))
               .rounds) == 16
    # The residual of round 16: the last of a 17-round chunk.
    r_ref = float(je.step(je.init(jg, jax.random.key(0)),
                          chunk_rounds=17).max_residual)
    r_port = float(te.step(te.init(tg, torch.Generator().manual_seed(0)),
                           chunk_rounds=17).max_residual)
    assert r_port < eps <= r_ref
    for r in (r_ref, r_port):
        assert abs(r - hist[16]) < 0.04 * hist[16]


def residual_trail(engine, state, rounds):
    """Each round's largest residual, one ``step`` per round, for at most
    ``rounds`` rounds or until the run converges."""
    trail = []
    for _ in range(rounds):
        state = engine.step(state, chunk_rounds=1)
        if bool(state.done):
            break
        trail.append(float(state.max_residual))
    return trail


def test_eps_1e5_rounds_and_residuals_are_float32_noise():
    """Does the port's prelude -- a fold over each vertex's in-edge table
    -- drift further from exact arithmetic than the reference's
    ``segment_sum``? LBP at eps=1e-5 on the straggler stream's Ising grids
    and the zoo: each round's largest residual in both packages against the
    same run in float64 (``lbp_float64``), and each run's round count. The
    port is no further from float64 than the reference: it misses the
    float64 round count on fewer graphs (the reference misses it on two of
    the zoo's, the port on the 17-vs-16 graph), its median relative
    residual error per round is within a factor of the reference's, and it
    is the farther of the two on fewer than half the rounds. So the
    difference is float32 noise on both sides, and the fold order stays."""
    eps = 1e-5
    graphs = [JD.ising_grid(8, 1.5, seed=s) for s in range(6)]
    graphs += [g for _, g in JD.zoo_stream(24, seed=0)]
    miss = {"ref": 0, "port": 0}
    err_ref, err_port = [], []
    for jg in graphs:
        rounds64, hist = lbp_float64(jg, eps, 400)
        je, te = engines(scheduler="lbp", eps=eps, max_rounds=400)
        tg = bridge(jg)
        j_rounds = int(je.run(jg, jax.random.key(0)).rounds)
        t_rounds = int(te.run(tg, torch.Generator().manual_seed(0)).rounds)
        miss["ref"] += j_rounds != rounds64
        miss["port"] += t_rounds != rounds64
        n = min(j_rounds, t_rounds)
        jt = residual_trail(je, je.init(jg, jax.random.key(0)), n)
        tt = residual_trail(te, te.init(tg, torch.Generator().manual_seed(0)),
                            n)
        h = np.asarray(hist[:n])
        err_ref.append(np.abs(np.asarray(jt) - h) / h)
        err_port.append(np.abs(np.asarray(tt) - h) / h)
    err_ref, err_port = np.concatenate(err_ref), np.concatenate(err_port)
    assert err_ref.size > 700
    assert miss["port"] <= miss["ref"] and miss == {"ref": 2, "port": 1}
    assert np.median(err_port) <= 2 * np.median(err_ref)
    assert float(np.mean(err_port > err_ref)) < 0.5


@pytest.mark.parametrize("slots", [1, 2])
def test_lbp_mixed_shape_stream_matches_reference(slots):
    jpgms = mixed_stream()
    tpgms = [bridge(p) for p in jpgms]
    je, te = engines(scheduler="lbp", eps=1e-4, max_rounds=400,
                     history=False)
    kw = dict(max_batch=2, chunk_rounds=32, slots=slots)
    jr = JS.serve_async(je, jpgms, jax.random.key(0), **kw)
    tr = TS.serve_async(te, tpgms, 0, **kw)
    assert_beliefs_close(jr.results, tr.results)
    assert_same_stats(jr.stats, tr.stats)
    if slots == 1:          # the legacy cadence: engine.serve, chunk for chunk
        ts = te.serve(tpgms, 0, max_batch=2, chunk_rounds=32)
        for got, want in zip(ts.results, tr.results):
            assert_bitwise(got, want)
        assert ts.stats.chunks == tr.stats.chunks


# --- deadline admission under a SweepClock (the reference's SLA pins) -----

SLA = dict(scheduler="lbp", eps=1e-5, max_rounds=160, history=False)
SLA_KW = dict(slots=1, max_batch=2, chunk_rounds=16, prefetch=None)


def impossible():
    return JD.ising_grid(6, 3.5, seed=0)     # never converges in 160 rounds


def fast(seed=0):
    return JD.ising_grid(6, 1.5, seed=seed)  # ~15-25 rounds


@pytest.fixture(scope="module")
def sla_engines():
    return engines(**SLA)


def serve_both(sla_engines, items, seed=0, **kw):
    """The same (rid, graph, slo) stream through both packages, each with
    a fresh SweepClock."""
    je, te = sla_engines
    kw = {**SLA_KW, **kw}
    jr = JS.serve_async(je, iter(items), jax.random.key(seed),
                        clock=JS.SweepClock(), **kw)
    tr = TS.serve_async(te, iter([(r, bridge(p), s) for r, p, s in items]),
                        seed, clock=TS.SweepClock(), **kw)
    return jr, tr


def test_deadline_midflight_eviction_pin(sla_engines):
    jr, tr = serve_both(sla_engines, [(0, impossible(), 40.0),
                                      (1, fast(0), None)],
                        admission="deadline")
    assert timeline(tr) == timeline(jr)
    assert_same_stats(jr.stats, tr.stats)
    ev = {r.rid: r for r in tr.records}[0]
    assert ev.status == "evicted" and ev.t_done == 64.0
    assert int(ev.result.rounds) == 32 == tr.stats.evicted_sweeps
    b = ev.result.beliefs.numpy()
    real = (b > -1e29).any(axis=-1)
    np.testing.assert_allclose(np.exp(b[real]).sum(axis=-1), 1.0, rtol=1e-5)
    assert_beliefs_close([r.result for r in jr.records],
                         [r.result for r in tr.records])


def test_deadline_survivors_match_reference(sla_engines):
    items = [(0, impossible(), 30.0), (1, fast(0), None), (2, fast(1), 400.0),
             (3, JD.chain_graph(30, seed=2), None), (4, fast(2), None)]
    jr, tr = serve_both(sla_engines, items, seed=7, admission="deadline")
    assert timeline(tr) == timeline(jr)
    assert_same_stats(jr.stats, tr.stats)
    assert {r.rid for r in tr.records if not r.evicted} == {1, 2, 3, 4}
    # survivors are bitwise a FIFO run of the port
    fifo = TS.serve_async(sla_engines[1], iter([(r, bridge(p))
                                                for r, p, _ in items]),
                          7, admission="fifo", **SLA_KW)
    want = {r.rid: r.result for r in fifo.records}
    for rec in tr.records:
        if not rec.evicted:
            assert_bitwise(rec.result, want[rec.rid])


def test_deadline_staged_eviction_prior_beliefs(sla_engines):
    jr, tr = serve_both(sla_engines, [(0, impossible(), None),
                                      (1, fast(0), 10.0)],
                        admission="deadline", max_batch=1, prefetch=1)
    assert timeline(tr) == timeline(jr)
    assert_same_stats(jr.stats, tr.stats)
    jev = {r.rid: r for r in jr.records}[1].result
    tev = {r.rid: r for r in tr.records}[1].result
    assert int(tev.rounds) == 0 and not bool(tev.converged)
    assert tev.beliefs.dtype == torch.float32 and tev.updates.dtype == \
        torch.int64
    for f in ("beliefs", "logm"):
        np.testing.assert_allclose(getattr(tev, f).numpy(),
                                   np.asarray(getattr(jev, f)), atol=1e-6)
    assert float(tev.max_residual) == float(jev.max_residual)


def test_deadline_evict_false_matches_reference(sla_engines):
    jr, tr = serve_both(sla_engines, [(0, impossible(), 40.0),
                                      (1, fast(0), None)],
                        admission="deadline",
                        admission_kwargs={"evict": False})
    assert timeline(tr) == timeline(jr)
    assert tr.stats.evictions == 0
    assert not {r.rid: r for r in tr.records}[0].within_slo


# --- admission scores, registry and error texts ----------------------------

@pytest.mark.parametrize("make", [
    lambda: JD.ising_grid(6, 2.0, seed=1), lambda: JD.chain_graph(40, seed=2),
    lambda: JD.protein_like_graph(12, seed=3),
    lambda: JD.ldpc_graph(0, n=24, dv=3, dc=6),
    lambda: JD.stereo_graph(0, height=6, width=8, n_disp=4)],
    ids=["ising", "chain", "protein", "ldpc", "stereo"])
def test_admission_scores_bitwise(make):
    jpgm = make()
    tpgm = bridge(jpgm)
    from repro.core.batch import bucket_shape as j_shape
    e, v, s, _, _ = j_shape(jpgm)
    ja = j_pad_arrays(jpgm, n_edges=e, n_vertices=v, n_states=s)
    ta = pad_pgm_arrays(tpgm, n_edges=e, n_vertices=v, n_states=s)
    assert TS._residual_at_admit(ta) == JS._residual_at_admit(ja)
    assert TS._coupling_stats(ta) == JS._coupling_stats(ja)
    group = TS._Group((e, v, s, e, v))
    assert TS.ResidualAdmission().score(tpgm, ta, group) == \
        JS.ResidualAdmission().score(jpgm, ja, JS._Group((e, v, s, e, v)))
    assert TS.DeadlineAdmission().features(tpgm, ta, group) == \
        JS.DeadlineAdmission().features(jpgm, ja, group)


def error_text(fn):
    try:
        fn()
    except (KeyError, ValueError) as e:
        return type(e).__name__, str(e)
    raise AssertionError("no error raised")


@pytest.mark.parametrize("call", [
    lambda M: M.get_admission_policy("nope"),
    lambda M: M.get_admission_policy(M.FIFOAdmission(), aging=2),
    lambda M: M.ResidualAdmission(aging=0),
    lambda M: M.WindowedAdmission(window_s=-1.0),
    lambda M: M.WindowedAdmission(target=0),
    lambda M: M.DeadlineAdmission(default_slo=-1.0),
    lambda M: M.DeadlineAdmission(grace=0),
    lambda M: M.DeadlineAdmission(aging=0),
    lambda M: M.SweepClock(tau=0.0),
    lambda M: M.AsyncServeResult([], M.AsyncServeStats())
    .latency_percentiles(field="nope"),
    lambda M: M.AsyncServeResult([], M.AsyncServeStats())
    .latency_percentiles(status="nope"),
    lambda M: M.register_admission_policy("fifo")(M.FIFOAdmission),
], ids=["unknown", "kwargs_on_instance", "residual_aging", "window_s",
        "target", "default_slo", "grace", "deadline_aging", "tau", "field",
        "status", "duplicate"])
def test_error_texts_match_reference(call):
    assert error_text(lambda: call(TS)) == error_text(lambda: call(JS))


def test_registry_surface_matches_reference():
    assert TS.list_admission_policies() == JS.list_admission_policies()
    for name in TS.list_admission_policies():
        assert TS.get_admission_policy(name).name == name
    cfg = BPConfig(admission="deadline", admission_kwargs={"grace": 3})
    assert cfg.to_dict() == JConfig(admission="deadline",
                                    admission_kwargs={"grace": 3}).to_dict()


def test_policy_instance_bound_once():
    te = BPEngine(BPConfig(), device=CPU)
    policy = TS.ResidualAdmission()
    TS.ServingPipeline(te, 0, admission=policy)
    with pytest.raises(ValueError, match="already bound"):
        TS.ServingPipeline(te, 0, admission=policy)


# ---------------------------------------------------------- within the port --

def same_shape_stream():
    fast = [TD.ising_grid(8, 1.5, seed=s, device=CPU) for s in range(6)]
    return fast[:3] + [TD.ising_grid(8, 3.5, seed=0, device=CPU)] + fast[3:]


@pytest.mark.parametrize("sched,kw", [
    ("rnbp", {"low_p": 0.4}), ("rlx", {"p": 1 / 32}),
    ("rlxtree", {"p": 1 / 32, "queues": 4})])
def test_serve_async_serve_and_run_many_bitwise(sched, kw):
    stream = same_shape_stream()
    te = BPEngine(BPConfig(scheduler=sched, scheduler_kwargs=kw, eps=1e-4,
                           max_rounds=300, history=False), device=CPU)
    ref = te.run_many(stream, 3, max_batch=3)
    runs = [te.serve(stream, 3, max_batch=2, chunk_rounds=40).results,
            TS.serve_async(te, stream, 3, max_batch=3, chunk_rounds=48,
                           compact=True, slots=2).results,
            TS.serve_async(te, iter(stream), torch.Generator().manual_seed(3),
                           max_batch=4, chunk_rounds=32, slots=1,
                           prefetch=2).results]
    for results in runs:
        for got, want in zip(results, ref):
            assert_bitwise(got, want)


@pytest.mark.parametrize("admission,kwargs", [
    ("residual", {}), ("windowed", {"window_s": 0.0}), ("deadline", {})])
def test_policies_never_change_a_result_bit(admission, kwargs):
    stream = [TD.ising_grid(6, 2.0, seed=1, device=CPU),
              TD.chain_graph(40, seed=2, device=CPU),
              TD.ising_grid(7, 2.0, seed=3, device=CPU),
              TD.chain_graph(50, seed=4, device=CPU),
              TD.ising_grid(6, 2.2, seed=5, device=CPU)]
    te = BPEngine(BPConfig(scheduler="rnbp", scheduler_kwargs={"low_p": 0.4},
                           eps=1e-4, max_rounds=400, history=False),
                  device=CPU)
    kw = dict(max_batch=2, chunk_rounds=32, slots=2, prefetch=None)
    fifo = TS.serve_async(te, stream, 0, admission="fifo", **kw)
    other = TS.serve_async(te, stream, 0, admission=admission,
                           admission_kwargs=kwargs, **kw)
    assert other.stats.policy == admission
    for got, want in zip(other.results, fifo.results):
        assert_bitwise(got, want)


def test_narrow_state_keeps_trajectories():
    te = BPEngine(BPConfig(scheduler="rnbp", scheduler_kwargs={"low_p": 0.4},
                           eps=1e-5, max_rounds=200), device=CPU)
    batch = BatchedPGM.from_pgms(same_shape_stream()[:4])
    state = te.step(te.init(batch, 5), chunk_rounds=8)
    narrow = TS._narrow_state(state, [1, 3])
    full = te.run(batch, state=state)
    part = te.run(narrow.graph, state=narrow)
    for j, i in enumerate((1, 3)):
        for f in ("logm", "rounds", "updates", "max_residual",
                  "unconverged_history"):
            assert torch.equal(getattr(part, f)[j], getattr(full, f)[i]), f


def test_stack_is_from_pgms_and_backfill_is_bitwise_padding():
    """``from_pgms`` of elements padded to one shape stacks them on the
    device, bitwise its host-padding path over the raw graphs with those
    ceilings (and over a mix of the two), and ``with_graph`` writes a
    bucket-shaped graph as the host-padding path would."""
    pgms = [TD.ising_grid(5, 2.0, seed=1, device=CPU),
            TD.chain_graph(20, seed=2, device=CPU),
            TD.loop_graph(12, seed=3, device=CPU)]
    e, v, s = 256, 32, 2
    ceil = dict(n_edges=e, n_vertices=v, n_states=s, n_real_edges=e,
                n_real_vertices=v)
    elems = [pad_pgm(p, **ceil) for p in pgms]
    stacked = BatchedPGM.from_pgms(elems)
    want = BatchedPGM.from_pgms(pgms, **ceil)
    mixed = BatchedPGM.from_pgms([elems[0], pgms[1], elems[2]], **ceil)
    for got in (stacked, mixed):
        for f in dataclasses.fields(PGM):
            a, b = getattr(got.pgm, f.name), getattr(want.pgm, f.name)
            assert torch.equal(a, b) if isinstance(a, torch.Tensor) \
                else a == b
    assert stacked.pgm.edge_src.data_ptr() != elems[0].edge_src.data_ptr()
    slow = want.with_graph(1, pgms[0])
    quick = want.with_graph(1, elems[0])
    for f in dataclasses.fields(PGM):
        a, b = getattr(slow.pgm, f.name), getattr(quick.pgm, f.name)
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
    assert torch.equal(want.pgm.edge_src[1], elems[1].edge_src)  # untouched


def test_blocking_iterator_through_feeder_is_bitwise():
    stream = same_shape_stream()
    te = BPEngine(BPConfig(scheduler="rnbp", scheduler_kwargs={"low_p": 0.4},
                           eps=1e-4, max_rounds=300, history=False),
                  device=CPU)

    def slow():
        for p in stream:
            time.sleep(0.01)
            yield p
    want = TS.serve_async(te, iter(stream), 0, max_batch=3, chunk_rounds=32)
    got = TS.serve_async(te, slow(), 0, max_batch=3, chunk_rounds=32,
                         ingest_threads=2)
    for a, b in zip(got.results, want.results):
        assert_bitwise(a, b)
    assert got.stats.staged == len(stream)


def test_duplicate_rids_and_source_errors():
    te = BPEngine(BPConfig(eps=1e-4, max_rounds=100), device=CPU)
    g = TD.ising_grid(5, 1.5, seed=0, device=CPU)
    with pytest.raises(ValueError, match="duplicate request id 3"):
        TS.serve_async(te, iter([(3, g), (3, g)]), 0)

    def broken():
        yield g
        raise RuntimeError("source failed")
    for threads in (0, 2):
        with pytest.raises(RuntimeError, match="source failed"):
            TS.serve_async(te, broken(), 0, ingest_threads=threads)
    rep = TS.serve_async(te, iter([(5, g)]), 0)
    assert rep.results[5] is not None and rep.results[:5] == [None] * 5
    empty = TS.serve_async(te, iter([]), 0)
    assert empty.records == [] and np.isnan(
        empty.latency_percentiles()["p50"])


def feeder_threads():
    return [t for t in threading.enumerate()
            if getattr(t, "_target", None) is not None
            and getattr(t._target, "__name__", "") == "_worker"]


def test_close_and_context_manager_join_feeder_threads():
    te = BPEngine(BPConfig(eps=1e-4, max_rounds=100), device=CPU)
    before = len(feeder_threads())

    def endless():
        while True:
            yield TD.ising_grid(5, 1.5, seed=0, device=CPU)
    with TS.ServingPipeline(te, 0, max_batch=2, chunk_rounds=16,
                            ingest_threads=2, prefetch=2) as pipe:
        gen = pipe.serve(endless())
        next(gen)
        assert len(feeder_threads()) == before + 2
    assert len(feeder_threads()) == before
    with pytest.raises(ValueError, match="closed"):
        next(pipe.serve(iter([])))
    pipe2 = TS.ServingPipeline(te, 0, ingest_threads=1)
    gen = pipe2.serve(endless())
    next(gen)
    pipe2.close()
    assert len(feeder_threads()) == before
    gen.close()


def test_latency_timeline_and_sweep_clock():
    stream = same_shape_stream()
    te = BPEngine(BPConfig(eps=1e-4, max_rounds=128, history=False),
                  device=CPU)
    rep = TS.serve_async(te, iter(stream), 0, max_batch=4, chunk_rounds=32)
    for rec in rep.records:
        assert rec.t_done >= rec.t_admit >= rec.t_enqueue
        assert rec.latency_s == pytest.approx(rec.queue_s + rec.service_s)
    pct = rep.latency_percentiles((50, 99), status="completed")
    assert pct["p50"] <= pct["p99"]
    clock = TS.SweepClock(tau=0.25)
    clock.on_chunk(16)
    clock.advance(1.5)
    assert clock() == 5.5


def test_serial_scheduler_rejected():
    with pytest.raises(NotImplementedError):
        TS.ServingPipeline(BPEngine(BPConfig(scheduler="srbp"), device=CPU),
                           0)


def test_serving_draws_per_request_generators():
    """Request ``rid`` draws from ``slot_generator(base, rid)``: its
    result is its solo run on the padded element with that generator."""
    stream = same_shape_stream()
    te = BPEngine(BPConfig(scheduler="rnbp", scheduler_kwargs={"low_p": 0.4},
                           eps=1e-4, max_rounds=300, history=False),
                  device=CPU)
    rep = TS.serve_async(te, iter(stream), 11, max_batch=4, chunk_rounds=32)
    from repro_torch.core.batch import bucket_shape
    for rec in rep.records[:3]:
        e, v, s, re_, rv = bucket_shape(stream[rec.rid])
        solo = te.run(pad_pgm(stream[rec.rid], n_edges=e, n_vertices=v,
                              n_states=s, n_real_edges=re_,
                              n_real_vertices=rv),
                      slot_generator(11, rec.rid, CPU))
        assert_bitwise(rec.result, solo)


def test_feeder_threads_under_contention_deliver_every_request_once():
    """More feeder threads than cores, a short switch interval: every
    request is pulled once, its rid is its arrival index, and the results
    are the unthreaded run's."""
    import sys
    stream = [TD.chain_graph(12 + i % 3, seed=i, device=CPU)
              for i in range(40)]
    te = BPEngine(BPConfig(eps=1e-3, max_rounds=200, history=False),
                  device=CPU)
    want = TS.serve_async(te, iter(stream), 0, max_batch=4, chunk_rounds=16)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got = TS.serve_async(te, iter(stream), 0, max_batch=4,
                             chunk_rounds=16, ingest_threads=16,
                             ingest_queue=3)
    finally:
        sys.setswitchinterval(interval)
    assert sorted(r.rid for r in got.records) == list(range(40))
    for a, b in zip(got.results, want.results):
        assert_bitwise(a, b)
