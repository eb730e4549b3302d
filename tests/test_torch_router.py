"""The router tier: the port's ``repro_torch.serve`` against the
reference's ``repro.serve``, and against its own ``serve_async``.

Across the two packages (identical graphs through ``PGM.from_numpy``; the
reference on the CPU, the port on its plain path):

- the routing policies are pure host code: fed the same ``ReplicaLoad``
  sequence, every pick is the reference's;
- the registry, its errors and the router's argument validation carry the
  reference's texts;
- LBP through ``serve_routed`` (round robin, no stealing) gives the
  reference's rounds per request, beliefs within 1e-4 and the same routed
  counts; under a ``SweepClock`` with deadline admission, the reference's
  statuses and replica attribution.

Within the port, where the draws are its own (RnBP): round robin without
stealing is bitwise each share's solo ``serve_async``; load-aware routing
and stealing change no result bit. The inbox steals from its tail; the
tier leaves no thread behind, closes when abandoned and is one-shot.

Every call that could block runs under ``within`` (a thread joined with a
timeout), so a hang fails its test instead of the suite.
"""

import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

from repro.core import BPConfig as JConfig
from repro.core import BPEngine as JEngine
from repro.core import SweepClock as JClock
from repro.pgm import datasets as JD
from repro.serve import Router as JRouter
from repro.serve import routing as JR
from repro.serve import serve_routed as j_serve_routed
from repro.serve.replica import ReplicaLoad as JLoad
from repro_torch.core import (BPConfig, BPEngine, RoundsHistory, SweepClock,
                              bucket_shape, serve_async)
from repro_torch.core.graph import PGM
from repro_torch.pgm import datasets as TD
from repro_torch.serve import (KindAffinityRouting, ROUTING_POLICIES,
                               ReplicaLoad, RoundRobinRouting, Router,
                               RoutingPolicy, get_routing_policy,
                               list_routing_policies,
                               register_routing_policy, serve_routed)
from repro_torch.serve import routing as TR
from repro_torch.serve.replica import _Inbox, _Request

CPU = "cpu"
LBP = dict(scheduler="lbp", eps=1e-5, max_rounds=160, history=False)
RNBP = dict(scheduler="rnbp", scheduler_kwargs={"low_p": 0.4, "high_p": 0.9},
            eps=1e-3, max_rounds=160, history=False)
KW = dict(max_batch=2, chunk_rounds=16)
TIMEOUT = 120.0


def within(fn, timeout=TIMEOUT):
    """``fn()`` on a daemon thread joined with ``timeout``: a hang fails
    the calling test; an exception re-raises here."""
    out = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as e:      # re-raised on the test's thread
            out["error"] = e
    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), f"still running after {timeout} s"
    if "error" in out:
        raise out["error"]
    return out["value"]


def wait_threads(baseline, timeout=10.0):
    deadline = time.time() + timeout
    while threading.active_count() > baseline and time.time() < deadline:
        time.sleep(0.02)
    return threading.active_count()


def bridge(jpgm):
    return PGM.from_numpy(vars(jpgm), jpgm.n_real_vertices, jpgm.n_real_edges,
                          device=CPU,
                          edge_count=int(jpgm.traced_edge_count()),
                          vertex_count=int(jpgm.traced_vertex_count()))


def mixed_stream():
    """The reference's ``_mixed_stream``: two shape families."""
    return [JD.ising_grid(6, 1.5, seed=1), JD.chain_graph(30, seed=2),
            JD.ising_grid(6, 2.0, seed=3), JD.chain_graph(34, seed=4),
            JD.ising_grid(6, 3.0, seed=5), JD.chain_graph(30, seed=6),
            JD.ising_grid(6, 1.8, seed=7)]


@pytest.fixture(scope="module")
def mixed():
    jpgms = mixed_stream()
    return jpgms, [bridge(p) for p in jpgms]


@pytest.fixture(scope="module")
def rnbp_engines():
    return [BPEngine(BPConfig(**RNBP), device=CPU) for _ in range(2)]


def assert_bitwise(got, want):
    for f in ("logm", "beliefs", "rounds", "updates", "converged",
              "max_residual", "unconverged_history"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


# ------------------------------------------------ routing policies, registry --

POLICIES = {
    "round_robin": {}, "least_loaded": {}, "kind_affinity": {},
    "kind_affinity_spread1": {"spread": 1}, "deadline": {},
    "deadline_urgency0.5": {"urgency_weight": 0.5},
}


@pytest.mark.parametrize("label", sorted(POLICIES))
def test_policy_picks_match_reference(label):
    """One seeded load sequence (ties included: weights on a coarse grid)
    through the reference's policy and the port's: the same picks."""
    name, kwargs = label.split("_spread")[0].split("_urgency")[0], \
        POLICIES[label]
    jpol = JR.get_routing_policy(name, **kwargs)
    tpol = get_routing_policy(name, **kwargs)
    assert type(tpol).__name__ == type(jpol).__name__
    rng = np.random.default_rng(7)
    kinds = [(128, 16, 2, 128, 16), (256, 32, 4, 256, 32), (512, 64, 2),
             ("a",)]
    jpicks, tpicks = [], []
    for rid in range(200):
        n = int(rng.integers(1, 5))
        rows = [dict(replica=i, inbox=int(rng.integers(0, 4)),
                     staged=int(rng.integers(0, 3)),
                     in_flight=int(rng.integers(0, 3)),
                     effort=float(rng.integers(0, 6)) / 2,
                     urgent=int(rng.integers(0, 3))) for i in range(n)]
        kind = kinds[int(rng.integers(len(kinds)))]
        slo = None if rng.random() < 0.4 else float(rng.random())
        jl, tl = [JLoad(**r) for r in rows], [ReplicaLoad(**r) for r in rows]
        if name == "deadline":
            jpicks.append(jpol.pick(rid, kind, jl, slo=slo))
            tpicks.append(tpol.pick(rid, kind, tl, slo=slo))
        else:
            jpicks.append(jpol.pick(rid, kind, jl))
            tpicks.append(tpol.pick(rid, kind, tl))
    assert tpicks == jpicks
    assert len(set(tpicks)) > 1


def test_load_snapshot_properties_match_reference():
    row = dict(replica=1, inbox=3, staged=2, in_flight=1, effort=4.5,
               urgent=2)
    j, t = JLoad(**row), ReplicaLoad(**row)
    assert (t.depth, t.weight) == (j.depth, j.weight) == (6, 4.5)


def error_text(fn):
    try:
        fn()
    except Exception as e:              # compared across the packages
        return type(e).__name__, str(e)
    raise AssertionError("no error")


@pytest.mark.parametrize("case", [
    lambda S, R: S.get_routing_policy("nope"),
    lambda S, R: S.register_routing_policy("round_robin")(
        S.RoundRobinRouting),
    lambda S, R: S.get_routing_policy(S.RoundRobinRouting(), spread=2),
    lambda S, R: S.KindAffinityRouting(spread=-1),
    lambda S, R: S.DeadlineRouting(urgency_weight=-0.1),
    lambda S, R: S.RoundRobinRouting().bind(1).bind(2),
    lambda S, R: S.RoutingPolicy().pick(0, (), []),
], ids=["unknown", "duplicate", "instance_kwargs", "spread", "urgency",
        "rebind", "base_pick"])
def test_registry_and_policy_errors_match_reference(case):
    want = error_text(lambda: case(JR, None))
    assert error_text(lambda: case(TR, None)) == want


def test_registry_surface():
    assert list_routing_policies() == JR.list_routing_policies() == [
        "deadline", "kind_affinity", "least_loaded", "round_robin"]
    assert ROUTING_POLICIES.kind == JR.ROUTING_POLICIES.kind
    cls = ROUTING_POLICIES["round_robin"]
    assert register_routing_policy("round_robin", overwrite=True)(cls) is cls


# ----------------------------------------------- LBP across the two packages --

def test_lbp_routed_stream_matches_reference(mixed):
    """Round robin without stealing: the reference's rounds per request,
    beliefs within 1e-4, the same routed counts."""
    jpgms, tpgms = mixed
    jres = within(lambda: j_serve_routed(
        JConfig(**LBP), iter(jpgms), jax.random.key(0), replicas=2,
        routing="round_robin", steal=False, **KW))
    tres = within(lambda: serve_routed(
        BPConfig(**LBP), iter(tpgms), 0, replicas=2, routing="round_robin",
        steal=False, device=CPU, **KW))
    assert tres.stats.routed == jres.stats.routed == [4, 3]
    assert (tres.stats.policy, tres.stats.steal) == ("round_robin", False)
    jby = {r.rid: r for r in jres.records}
    assert sorted(r.rid for r in tres.records) == sorted(jby)
    for rec in tres.records:
        want = jby[rec.rid]
        assert rec.replica == want.replica == rec.rid % 2
        assert int(rec.result.rounds) == int(want.result.rounds)
        assert bool(rec.result.converged) == bool(want.result.converged)
        n = np.asarray(want.result.beliefs).shape[0]
        np.testing.assert_allclose(np.exp(rec.result.beliefs[:n].numpy()),
                                   np.exp(np.asarray(want.result.beliefs)),
                                   atol=1e-4)


def sla_stream(D, make):
    return [(0, make(D.ising_grid(6, 3.5, seed=0)), 80.0),
            (1, make(D.ising_grid(6, 3.5, seed=2)), 80.0)] + [
        (k + 2, make(D.ising_grid(6, 1.5, seed=k)), None) for k in range(4)]


def test_sla_routed_statuses_match_reference():
    """``tests/test_sla.py``'s routed eviction scenario: deadline admission
    under a ``SweepClock``, two replicas -- the reference's statuses and
    attribution; completed requests within their budgets."""
    sla = dict(replicas=2, routing="round_robin", steal=False,
               admission="deadline", slots=1, max_batch=2, chunk_rounds=16,
               prefetch=4)
    jres = within(lambda: j_serve_routed(
        JConfig(**LBP), iter(sla_stream(JD, lambda p: p)),
        jax.random.key(0), clock=JClock(), **sla))
    tres = within(lambda: serve_routed(
        BPConfig(**LBP), iter(sla_stream(JD, bridge)), 0, clock=SweepClock(),
        device=CPU, **sla))

    def summary(res):
        return sorted((r.rid, r.status, r.replica, r.within_slo)
                      for r in res.records)
    assert summary(tres) == summary(jres)
    assert {r.rid for r in tres.records if r.evicted} == {0, 1}
    assert sum(s.evictions for s in tres.replica_stats) == 2


# ------------------------------------------------------- within the port --

def tport(n_fast=3, n_chain=3, n_slow=1):
    """RnBP stream of the port: two shape families, a few slow grids."""
    out = []
    for k in range(max(n_fast, n_chain, n_slow)):
        if k < n_fast:
            out.append(TD.ising_grid(6, 1.5, seed=k, device=CPU))
        if k < n_chain:
            out.append(TD.chain_graph(30 + 2 * k, seed=k, device=CPU))
        if k < n_slow:
            out.append(TD.ising_grid(6, 3.0, seed=100 + k, device=CPU))
    return out


def test_round_robin_no_steal_is_bitwise_solo_shares(rnbp_engines):
    stream = tport()
    res = within(lambda: serve_routed(rnbp_engines, iter(stream), 0,
                                      routing="round_robin", steal=False,
                                      **KW))
    by_rid = {r.rid: r.result for r in res.records}
    assert sorted(by_rid) == list(range(len(stream)))
    for k in range(2):
        share = [(i, p) for i, p in enumerate(stream) if i % 2 == k]
        solo = within(lambda: serve_async(rnbp_engines[0], iter(share), 0,
                                          **KW))
        assert solo.records
        for rec in solo.records:
            assert_bitwise(by_rid[rec.rid], rec.result)


@pytest.mark.parametrize("routing,steal", [("least_loaded", True),
                                           ("kind_affinity", False),
                                           ("deadline", True)])
def test_load_aware_routing_and_stealing_change_no_bit(rnbp_engines, routing,
                                                       steal):
    stream = tport()
    want = {r.rid: r.result for r in within(lambda: serve_async(
        rnbp_engines[0], iter(stream), 0, **KW)).records}
    res = within(lambda: serve_routed(rnbp_engines, iter(stream), 0,
                                      routing=routing, steal=steal,
                                      low_watermark=2, prefetch=2, **KW))
    assert len(res.records) == len(stream)
    for rec in res.records:
        assert_bitwise(rec.result, want[rec.rid])
    if routing == "kind_affinity":
        homes = {}
        for rec in res.records:
            homes.setdefault(rec.kind, set()).add(rec.replica)
        assert all(len(v) == 1 for v in homes.values()), homes


def test_hotspot_steal_triggers_and_changes_no_bit(rnbp_engines):
    """Replica 0 gets two requests, replica 1 the rest: replica 0 drains,
    steals, and every result is bitwise the solo run's."""
    @register_routing_policy("test_torch_hotspot", overwrite=True)
    class Hotspot(RoutingPolicy):
        name = "test_torch_hotspot"

        def __init__(self):
            super().__init__()
            self._n = 0

        def pick(self, rid, kind, loads):
            i = 0 if self._n < 2 else 1
            self._n += 1
            return i

    stream = ([TD.ising_grid(6, 1.5, seed=s, device=CPU) for s in range(2)]
              + [TD.ising_grid(6, 3.0, seed=100 + s, device=CPU)
                 for s in range(10)])
    want = {r.rid: r.result for r in within(lambda: serve_async(
        rnbp_engines[0], iter(stream), 0, **KW)).records}
    try:
        res = within(lambda: serve_routed(
            rnbp_engines, iter(stream), 0, routing="test_torch_hotspot",
            steal=True, steal_batch=2, low_watermark=2, prefetch=2,
            ingest_queue=1, **KW))
    finally:
        del ROUTING_POLICIES["test_torch_hotspot"]
    assert res.stats.policy == "test_torch_hotspot"
    assert res.stats.stolen > 0 and res.stats.steals > 0
    flagged = [rec for rec in res.records if rec.stolen]
    assert len(flagged) == res.stats.stolen
    assert any(rec.replica == 0 for rec in flagged)
    for rec in res.records:
        assert_bitwise(rec.result, want[rec.rid])


def test_stealing_under_thread_stress():
    """Four replicas (more threads than this test needs cores), stealing
    on, the interpreter switching threads every 10 us: every rid is
    released once and bitwise its solo run."""
    engines = [BPEngine(BPConfig(**RNBP), device=CPU) for _ in range(4)]
    stream = tport(n_fast=6, n_chain=4, n_slow=3)
    want = {r.rid: r.result for r in within(lambda: serve_async(
        engines[0], iter(stream), 0, **KW)).records}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        res = within(lambda: serve_routed(
            engines, iter(stream), 0, routing="least_loaded", steal=True,
            steal_batch=1, low_watermark=1, prefetch=1, ingest_queue=1,
            **KW))
    finally:
        sys.setswitchinterval(old)
    assert sorted(r.rid for r in res.records) == sorted(want)
    for rec in res.records:
        assert_bitwise(rec.result, want[rec.rid])


def test_inbox_steal_mechanics():
    inbox = _Inbox(capacity=8)
    reqs = [_Request(rid=i, pgm=None, kind=("k",), t_route=0.0)
            for i in range(5)]
    for r in reqs:
        inbox.put(r)
    got = inbox.steal(10, leave=2)      # tail, oldest first, keep `leave`
    assert [r.rid for r in got] == [2, 3, 4]
    assert len(inbox) == 2 and inbox.kinds() == [("k",), ("k",)]
    assert inbox.pop(timeout=0.01).rid == 0
    inbox.finish()
    with pytest.raises(ValueError, match="closed"):
        inbox.put(reqs[0])
    inbox.put(reqs[2], force=True)      # a steal transplant still lands
    assert inbox.pop(timeout=0.01).rid == 1
    assert inbox.pop(timeout=0.01).rid == 2
    assert inbox.pop(timeout=0.01) is not None      # the closed sentinel
    inbox.close()
    assert len(inbox) == 0 and inbox.dead
    with pytest.raises(ValueError, match="capacity"):
        _Inbox(0)


def test_no_thread_leak_and_abandoned_router_closes(rnbp_engines):
    baseline = threading.active_count()
    stream = [TD.ising_grid(6, 1.5, seed=s, device=CPU) for s in range(4)]
    res = within(lambda: serve_routed(rnbp_engines, iter(stream), 0, **KW))
    assert len(res.records) == len(stream)
    assert wait_threads(baseline) <= baseline
    router = Router(rnbp_engines, 1, routing="round_robin", **KW)
    gen = router.serve(TD.ising_grid(6, 3.0, seed=s, device=CPU)
                       for s in range(12))
    within(lambda: next(gen))           # at least one record served
    within(router.close)                # abandon mid-stream
    gen.close()
    assert wait_threads(baseline) <= baseline
    with pytest.raises(ValueError, match="one-shot|closed"):
        next(router.serve(iter([])))


def test_one_shot_and_duplicate_rids(rnbp_engines):
    router = Router(rnbp_engines, 0, **KW)
    within(lambda: list(router.serve([TD.ising_grid(6, 1.5, seed=0,
                                                    device=CPU)])))
    with pytest.raises(ValueError, match="one-shot"):
        next(router.serve([TD.ising_grid(6, 1.5, seed=1, device=CPU)]))
    dup = [(0, TD.ising_grid(6, 1.5, seed=0, device=CPU)),
           (0, TD.ising_grid(6, 1.5, seed=1, device=CPU))]
    with pytest.raises(ValueError, match="duplicate request id 0"):
        within(lambda: list(Router(rnbp_engines, 0, **KW).serve(iter(dup))))


@pytest.mark.parametrize("case", [
    lambda R, cfg, eng: R([eng], 0, replicas=3),
    lambda R, cfg, eng: R(object(), 0),
    lambda R, cfg, eng: R(cfg, 0, replicas=1, prefetch=None),
    lambda R, cfg, eng: R(cfg, 0, replicas=0),
    lambda R, cfg, eng: R([], 0),
    lambda R, cfg, eng: R([eng], 0, steal_batch=0),
    lambda R, cfg, eng: R([eng], 0, inbox_capacity=0),
    lambda R, cfg, eng: R([eng], 0, routing="nope"),
], ids=["replicas_vs_list", "engine_type", "prefetch", "replicas0",
        "no_engines", "steal_batch", "inbox_capacity", "routing"])
def test_router_argument_validation_matches_reference(case):
    jcfg, jeng = JConfig(**LBP), JEngine(JConfig(**LBP))
    tcfg, teng = BPConfig(**LBP), BPEngine(BPConfig(**LBP), device=CPU)
    want = error_text(lambda: case(JRouter, jcfg, jeng))
    got = error_text(lambda: case(
        lambda e, r, **kw: Router(e, r, device=CPU, **kw), tcfg, teng))
    assert got == want


def test_router_builds_engines_on_the_device_it_is_given():
    eng = BPEngine(BPConfig(**LBP), device=CPU)
    r = Router(eng, 0, replicas=3)      # a BPEngine: its device, no GPU
    assert r.replicas[0].pipeline.engine is eng
    assert all(x.pipeline.engine.device.type == "cpu" and x.stream is None
               for x in r.replicas)
    r.close()
    r = Router(BPConfig(**LBP), 0, replicas=2, device=CPU)
    assert [x.pipeline.engine.config for x in r.replicas] == [
        BPConfig(**LBP)] * 2
    r.close()


def test_attribution_percentiles_shared_history(mixed):
    _, tpgms = mixed
    hist = RoundsHistory()
    res = within(lambda: serve_routed(BPConfig(**LBP), iter(tpgms), 0,
                                      replicas=2, routing="least_loaded",
                                      history=hist, device=CPU, **KW))
    assert {rec.replica for rec in res.records} <= {0, 1}
    assert sum(len(v) for v in res.by_replica().values()) == len(tpgms)
    assert sum(res.stats.routed) == len(tpgms)
    pct = res.latency_percentiles()
    assert set(pct) == {"p50", "p90", "p99"}
    assert all(np.isfinite(v) for v in pct.values())
    assert res.latency_percentiles(field="service")["p99"] <= \
        pct["p99"] + 1e-6
    assert hist.mean(("routed", bucket_shape(tpgms[0], 2.0))) is not None
    assert res.device_sweeps >= res.useful_sweeps > 0
    assert all(r is not None for r in res.results)
    assert np.isnan(res.latency_percentiles(status="evicted")["p50"])
    with pytest.raises(KeyError, match="field"):
        res.latency_percentiles(field="nope")
    with pytest.raises(ValueError, match="status"):
        res.latency_percentiles(status="nope")


def test_replica_load_hooks_read_the_pipeline(rnbp_engines):
    """``Replica.pending``/``load`` read the pipeline's staged count and
    its feeder's queue depth (zero before serving)."""
    router = Router(rnbp_engines, 0, **KW)
    try:
        rep = router.replicas[0]
        assert rep.pipeline._staged_count() == 0 and rep.pending() == 0
        load = rep.load()
        assert (load.inbox, load.staged, load.in_flight, load.effort) == \
            (0, 0, 0, 0.0)
        assert isinstance(router._policy, RoundRobinRouting)
        assert isinstance(get_routing_policy("kind_affinity"),
                          KindAffinityRouting)
    finally:
        router.close()
