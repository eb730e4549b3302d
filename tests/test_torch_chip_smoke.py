"""``chip_smoke.py`` rehearsed on the CPU at tiny sizes.

The script's phases take their device and sizes as arguments, so their
control flow, checks and report fields run here with the kernel's plain
version. A counting shim stands in for the kernel launch count (CPU tensors
launch nothing). Without a GPU, ``main`` exits non-zero and prints no
result.
"""

import json
import math
import pathlib
import sys

import pytest
import torch
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

from repro_torch.kernels import message_update as MU
from repro_torch.kernels import ops
from repro_torch.kernels import triton_update as TT
from repro_torch.pgm import protein_like_graph

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402  (the script lives at the repo root)

CPU = torch.device("cpu")


@pytest.fixture
def counted(monkeypatch):
    """Count calls of the kernel wrappers on the engine's paths as
    launches."""
    real, real_t = ops.fused_update_e, ops.fused_update_t

    def counting(*args, semiring="sum"):
        TT.LAUNCHES[semiring] += 1
        return real(*args, semiring=semiring)

    def counting_t(*args):
        MU.LAUNCHES["sum"] += 1
        return real_t(*args)

    monkeypatch.setattr(ops, "fused_update_e", counting)
    monkeypatch.setattr(ops, "fused_update_t", counting_t)
    monkeypatch.setattr(cs, "time_ms", lambda fn, iters, warmup=3:
                        (fn(), 0.0)[1])


def test_main_refuses_without_gpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cs.main() == 2
    assert '"ok"' not in capsys.readouterr().out


def test_bound_is_the_byte_contract():
    ms, by = cs.bound(3_996_032, 2, "sum", 3.35e12, 67e12)
    assert by == "bytes"
    assert round(3_996_032 * 46 / 1e6, 1) == 183.8
    assert ms == pytest.approx(3_996_032 * 46 / 3.35e12 * 1e3)
    assert cs.card_peaks("NVIDIA H100 80GB HBM3") == (3.35e12, 67e12)
    with pytest.raises(RuntimeError):
        cs.card_peaks("some other card")


def test_kernel_phase_on_cpu():
    worst = cs.phase_kernels(CPU, states=(2, 9, 33), edges=(1, 50),
                             table_bytes=1 << 20, sub=7)
    assert worst == {"sum": 0.0, "max": 0.0}


@pytest.mark.parametrize("edges_last", [False, True])
def test_sub_launch_check_rejects_a_position_dependent_kernel(edges_last):
    """A kernel whose output depends on where an edge sits in the launch
    fails the sub-launch check."""
    ops_ = cs.random_operands(20, 3, torch.Generator().manual_seed(0), CPU)
    fn = TT.fused_update_e
    if edges_last:
        ops_ = (ops_[0].permute(1, 2, 0).contiguous(),
                *(t.t().contiguous() for t in ops_[1:]))
        fn = MU.fused_update_t
    axis = -1 if edges_last else 0

    def per_edge(*o):
        # edge by edge: no output can depend on the edge's place
        n = o[1].shape[axis]
        outs = [fn(*(cs.first_edges(t.narrow(t.dim() - 1 if edges_last
                                              and t.dim() > 1 else 0, i, 1),
                                     1, edges_last) for t in o))
                for i in range(n)]
        return (torch.cat([x[0] for x in outs], dim=axis),
                torch.cat([x[1] for x in outs]))
    cs.check_sub_launch("good", per_edge, ops_, per_edge(*ops_), 5,
                        edges_last=edges_last)

    def shifted(*o):
        new, resid = per_edge(*o)
        return new, resid + 1e-7 * o[1].shape[axis]
    with pytest.raises(AssertionError, match="alone"):
        cs.check_sub_launch("bad", shifted, ops_, shifted(*ops_), 5,
                            edges_last=edges_last)


def test_compare_rejects_a_wrong_kernel():
    ops_ = cs.random_operands(20, 3, torch.Generator().manual_seed(0), CPU)
    good = TT.fused_update_e(*ops_)
    bad = (good[0] + 1e-3 * (good[0] != cs.NEG_INF), good[1])
    with pytest.raises(AssertionError):
        cs.compare("sum", bad, good)
    with pytest.raises(AssertionError):
        cs.compare("max", bad, good)


def test_path_phases_on_cpu(counted):
    pgm, res, main = cs.phase_main(CPU, n=12)
    assert main["launches"]["sum"] >= main["rounds"] > 0
    assert main["n_edges"] == pgm.n_edges and main["converged"]
    rows, mapd = cs.phase_paper(CPU, n=8, protein_vertices=16)
    assert len(rows) == 8 and mapd["launches"] >= mapd["rounds"]
    cpu = cs.phase_card_vs_cpu(CPU, n=6)
    assert cpu["max_prob_diff"] == 0.0
    timing = cs.phase_timing(pgm, CPU, 3.35e12, 67e12,
                             protein_like_graph(16, device="cpu"))
    assert set(timing) >= {"main/sum", "main/max", "protein/sum",
                           "protein/max", "main/t", "round_parts_ms"}
    assert timing["main/t"]["max_abs_err"] == 0.0
    trace = cs.phase_trace(pgm, CPU, warm=4, rounds=4)
    assert trace["kernels_per_round"] == 0 and trace["wall_ms_per_round"] > 0


def test_batched_phases_on_cpu(counted):
    assert cs.phase_kernels_t(CPU, states=(2, 9, 33), edges=(1, 50),
                              table_bytes=1 << 20, sub=7) == 0.0
    batch, out = cs.phase_batched(CPU, frames=2, scene={
        "height": 6, "width": 8, "n_disp": 4}, max_rounds=300)
    assert out["launches"] >= out["iterations"] >= \
        max(f["rounds"] for f in out["frames"]) > 0
    assert out["slot0_bitwise_solo"] and out["batch"] == batch.size == 2
    assert out["other_launches"] == {"sum": 0, "max": 0}
    assert all(f["converged"] and 0 <= f["within_1_of_truth"] <= 1
               for f in out["frames"])
    zoo = cs.phase_zoo(CPU, n=9)
    for label in ("fold/pallas", "batch/triton"):
        # the TPU-layout plain version sums in another order than "ref"
        assert zoo[label]["max_prob_diff"] <= 1e-6
        assert sum(b["size"] for b in zoo[label]["buckets"]) == 9
        assert all(b["launches"] >= b["rounds"] > 0
                   for b in zoo[label]["buckets"])
    widest = cs.widest_bucket(CPU, n=9)
    assert widest.n_states_max == max(
        p.n_states_max for _, p in cs_zoo(9))
    from repro_torch.core import BatchedPGM
    protein = BatchedPGM.from_pgms([protein_like_graph(16, device="cpu")])
    timing = cs.phase_timing_batched(batch, {"zoo": widest,
                                             "protein": protein}, CPU,
                                     3.35e12, 67e12)
    assert set(timing) == {"stereo", "zoo", "protein", "round_parts_ms"}
    assert timing["stereo"]["bound_by"] == "bytes"
    assert timing["stereo"]["max_abs_err"] == timing["zoo"]["max_abs_err"] \
        == 0.0
    assert all(timing[k]["e"][sr]["max_abs_err"] == 0.0
               for k in ("stereo", "zoo", "protein") for sr in ("sum", "max"))
    one = cs.phase_timing(batch.graph(0), CPU, 3.35e12, 67e12,
                          protein_like_graph(16, device="cpu"))
    by_path = {k: dict(one_graph=1, batched=2, serving=3) for k in (
        "fused_update_e/sum", "fused_update_e/max", "fused_update_t/sum")}
    kernels = cs.kernels_line(one, timing, {"sum": 0.0, "max": 0.0}, 0.0,
                              {"sum": 5, "max": 6}, 7, by_path)
    assert [k["name"] for k in kernels] == [
        "fused_update_e/sum", "fused_update_e/max", "fused_update_t/sum"]
    assert [k["launches"] for k in kernels] == [5, 6, 7]
    assert all(k["launches_by_path"] == by_path[k["name"]] for k in kernels)
    for k in kernels:
        assert [x["shape"] for x in k["shapes"]] == [
            "main", "protein", "stereo", "zoo"]
        assert all(set(x) == {"shape", "E", "S", "ms", "device_ms",
                              "bound_ms", "plain_ms"} for x in k["shapes"])
    prot = cs.phase_protein_pallas(CPU, protein_vertices=16)
    assert prot["launches"] >= prot["rounds"] > 0
    trace = cs.phase_trace(batch, CPU, warm=4, rounds=4,
                           config=cs.batched_config(), rng=0)
    assert trace["kernels_per_round"] == 0


def cs_zoo(n):
    from repro_torch.pgm import zoo_stream
    return zoo_stream(n, seed=0, device="cpu")


def test_serving_phase_on_cpu(counted):
    """Phase 14 at a tiny size: the online stream (stereo frames and the
    zoo) through serve_async, the bitwise checks, engine.serve against
    run_many, the backfill timing and the deadline run on both devices."""
    scene = {"height": 6, "width": 8, "n_disp": 4}
    out = cs.phase_serving(CPU, frames=2, scene=scene, zoo_n=9,
                           max_rounds=300,
                           slos={"ising": 30.0, "chain": 60.0})
    assert out["requests"] == 11 and out["requests_per_s"] > 0
    assert [f["rid"] for f in out["frames"]] == cs.stereo_rids(2, 9) == [0, 5]
    assert all(f["converged"] for f in out["frames"])
    assert set(out["bitwise_solo"].values()) <= {"admitted", "backfilled"}
    st = out["stats"]
    assert st["useful_sweeps"] <= st["device_sweeps"]
    assert st["evacuated"] == 11
    assert out["launches"]["fused_update_t/sum"] >= st["chunks"] > 0
    assert out["launches"]["fused_update_e/sum"] > 0
    assert out["launches"]["fused_update_e/max"] == 0
    assert set(out["host_seconds"]) == {"stage", "admit", "backfill", "step"}
    assert out["backfill_ms"]["load_slot"] >= 0
    assert (out["backfill_ms"]["E"], out["backfill_ms"]["S"]) in {
        (r["E"], r["S"]) for r in out["kernel_check"]["fused_update_t/sum"]}
    tr = out["traced"]
    assert tr["requests"] == 11 and tr["host_seconds"]["stage"] > 0
    assert tr["busy_s"] == 0.0 and tr["device_events"] == 0     # no card
    for name in ("fused_update_t/sum", "fused_update_e/sum"):
        rows = out["kernel_check"][name]
        assert rows and all(r["max_abs_err"] == 0.0 for r in rows)
    d = out["deadline"]
    assert d["timeline_equal"] and d["stats_equal"] and d["midflight"]
    assert d["max_prob_diff"] <= 1e-6
    assert set(out["latency_ms"]) == {"latency", "admission", "service"}
    cs.log_serving(out)
    by_path = cs.launches_by_path(
        {"launches": {"sum": 1, "t": 0}}, {"launches": 2},
        {"launches": 3, "other_launches": {"sum": 0, "max": 0}}, out,
        {"launches": {"fused_update_t/sum": 4}},
        {"launches": {"sum": 5, "max": 0}},
        {"sharded": {"launches": 6}, "banded": {"launches": 7}},
        {"launches": {"fused_update_e/sum": 8, "fused_update_e/max": 9,
                      "fused_update_t/sum": 10}},
        {"launches": {"fused_update_e/sum": 11, "fused_update_e/max": 12,
                      "fused_update_t/sum": 13}},
        {"launches": {"fused_update_e/sum": 14, "fused_update_e/max": 15,
                      "fused_update_t/sum": 16}},
        {"launches": {"fused_update_e/sum": 17, "fused_update_e/max": 18,
                      "fused_update_t/sum": 19}},
        {"launches": {"fused_update_e/sum": 20, "fused_update_e/max": 21,
                      "fused_update_t/sum": 22}},
        {"launches": {"fused_update_e/sum": 23}},
        {"launches": {"fused_update_e/sum": 24, "fused_update_e/max": 25,
                      "fused_update_t/sum": 26}})
    assert [by_path[k]["round_cost"] for k in (
        "fused_update_e/sum", "fused_update_e/max",
        "fused_update_t/sum")] == [24, 25, 26]
    assert [by_path[k]["sub_meshes"] for k in (
        "fused_update_e/sum", "fused_update_e/max",
        "fused_update_t/sum")] == [23, 0, 0]
    assert [by_path[k]["lm_blocks"] for k in (
        "fused_update_e/sum", "fused_update_e/max",
        "fused_update_t/sum")] == [20, 21, 22]
    assert [by_path[k]["lm_sharded"] for k in ("fused_update_e/sum",
                                               "fused_update_e/max",
                                               "fused_update_t/sum")] == [
        14, 15, 16]
    assert [by_path[k]["lm_sharded_train"] for k in (
        "fused_update_e/sum", "fused_update_e/max",
        "fused_update_t/sum")] == [17, 18, 19]
    assert all(len(by_path[k]) == 14 for k in by_path)
    assert [by_path[k]["lm"] for k in ("fused_update_e/sum",
                                       "fused_update_e/max",
                                       "fused_update_t/sum")] == [8, 9, 10]
    assert [by_path[k]["lm_train"] for k in ("fused_update_e/sum",
                                             "fused_update_e/max",
                                             "fused_update_t/sum")] == [
        11, 12, 13]
    assert by_path["fused_update_t/sum"]["serving"] == \
        out["launches"]["fused_update_t/sum"]
    assert by_path["fused_update_t/sum"]["routed"] == 4
    assert by_path["fused_update_e/sum"]["routed"] == 0
    assert by_path["fused_update_e/sum"]["resilient"] == 5
    assert (by_path["fused_update_e/sum"]["sharded"],
            by_path["fused_update_e/sum"]["banded"]) == (6, 7)


def test_interval_helpers():
    u = cs.merged([(5, 6), (0, 2), (1, 3), (3, 4)])
    assert u == [[0, 4], [5, 6]]
    assert cs.overlap(u, cs.merged([(3.5, 5.5)])) == 1.0
    assert cs.overlap(u, []) == 0.0


def test_kernel_streams_groups_kernels_by_stream(tmp_path):
    """The trace's kernels by CUDA stream, written where no directory
    exists yet (a fresh checkout has no ``chiprun_out/``)."""
    class Trace:
        def export_chrome_trace(self, path):
            events = [
                {"ph": "X", "cat": "kernel", "ts": 0, "dur": 4,
                 "args": {"stream": 7}},
                {"ph": "X", "cat": "kernel", "ts": 2, "dur": 4,
                 "args": {"stream": 7}},
                {"ph": "X", "cat": "kernel", "ts": 3, "dur": 5,
                 "args": {"stream": 13}},
                {"ph": "X", "cat": "gpu_memcpy", "ts": 0, "dur": 9,
                 "args": {"stream": 21}}]
            with open(path, "w") as f:
                json.dump({"traceEvents": events}, f)
    path = tmp_path / "fresh" / "trace.json"
    streams = cs.kernel_streams(Trace(), path)
    assert streams == {7: [[0.0, 6.0]], 13: [[3.0, 8.0]]}
    assert cs.overlap(streams[7], streams[13]) == 3.0
    assert not path.exists()


def test_router_phase_on_cpu(counted):
    """Phase 15 at a tiny size: the routed stream (traced, round robin
    against each share's solo run, least-loaded with stealing against
    round robin), the routed deadline run on both devices and the skewed
    stealing scenario."""
    scene = {"height": 6, "width": 8, "n_disp": 4}
    out = cs.phase_router(CPU, frames=2, scene=scene, zoo_n=9,
                          max_rounds=300)
    assert out["requests"] == 11 and out["replicas"] == 2
    for key in ("round_robin", "least_loaded_steal"):
        r = out[key]
        assert r["requests"] == 11 and r["requests_per_s"] > 0
        assert sum(r["routed"]) == 11
        assert set(r["latency_ms"]) == {"latency", "admission", "service"}
        assert 0 <= r["wasted_sweeps"] <= r["device_sweeps"]
    assert out["round_robin"]["routed"] == [6, 5]
    assert out["round_robin"]["steals"] == 0
    assert all(out["bitwise"].values())
    assert out["round_robin"]["inbox_wait_ms"]["p99"] >= 0.0
    tr = out["traced"]
    assert tr["requests"] == 11 and tr["kernel_streams"] == 0   # no card
    assert tr["routing_s"] > 0.0
    for name in ("fused_update_t/sum", "fused_update_e/sum"):
        rows = out["kernel_check"][name]
        assert rows and all(r["max_abs_err"] == 0.0 for r in rows)
    d = out["deadline"]
    assert d["statuses_equal"] and d["evicted"] == [0, 5]
    assert d["requests"] == 11 and d["max_prob_diff"] == 0.0
    sk = out["stealing"]
    assert sk["bitwise_on_vs_off"] and sk["on"]["stolen"] > 0
    assert sk["on"]["wasted_sweeps"] < sk["off"]["wasted_sweeps"]
    assert out["launches"]["fused_update_t/sum"] > 0
    assert out["launches"]["fused_update_e/sum"] > 0
    assert out["launches"].get("fused_update_e/max", 0) == 0
    serving = {"requests": 11, "wall_s": 1.0, "requests_per_s": 11.0,
               "latency_ms": out["round_robin"]["latency_ms"],
               "stats": {"wasted_sweeps": 0, "device_sweeps": 1},
               "peak_memory_bytes": 0, "traced": {"busy_s": 0.0}}
    cs.log_router(out, serving)


def test_resilient_phase_on_cpu(counted, tmp_path):
    """Phase 16 at a tiny size: the resilient run and its resumption
    against the main path's engine run, SRBP beside RnBP, and the chain
    against variable elimination."""
    pgm, res, _ = cs.phase_main(CPU, n=12)
    paper = [dict(graph="ising8", scheduler="rnbp", rounds=40,
                  converged=True, run_s=0.5)]      # phase 5's row
    out = cs.phase_resilient(CPU, pgm, res, paper, tmp_path / "ckpt",
                             chunk=7, srbp_n=8, srbp_limit=5.0)
    r = out["resilient"]
    assert r["bitwise"] and r["rounds"] == int(res.rounds) > 7
    assert r["checkpoints"] >= 2 and 0 < r["resumed_from"] < r["rounds"]
    assert r["launches"]["sum"] >= r["rounds"] and r["max_abs_err"] == 0.0
    assert 0.0 < r["save_s"] < r["loop_s"]
    assert not (tmp_path / "ckpt").exists()
    s = out["srbp"]
    assert s["updates"] > 0 and s["converged"]
    assert s["rnbp_card"]["rounds"] > 0
    assert out["kl"]["max_kl"] <= cs.KL_BOUND
    cs.log_resilient(out)


@pytest.fixture
def counted_slices(monkeypatch):
    """Count the multi-device paths' per-slice updates as launches (on the
    CPU they run the plain version and launch nothing)."""
    from repro_torch import dist as D
    real = D.slice_update

    def counting(*args):
        TT.LAUNCHES["sum"] += 1
        return real(*args)
    monkeypatch.setattr(D, "slice_update", counting)


def test_dist_phase_on_cpu(counted_slices, tmp_path):
    """Phase 17 at a tiny size over gloo: (a) the world of one, sharded
    RnBP bitwise the one-device run and banded LBP at n = 1 bitwise its
    one-device run at the cap; (b) two spawned gloo ranks bitwise
    one-device runs, their messages bitwise equal; (c) a bucket of two
    small stereo frames through ``run_many`` over the ranks, bitwise the
    one-device ``run_many``, each rank holding about half the bytes."""
    from repro_torch.pgm import ising_grid_fast
    pgm = ising_grid_fast(12, 2.5, seed=0, device="cpu")
    res, _ = cs.run_engine(pgm, CPU, scheduler="rnbp",
                           scheduler_kwargs=cs.MAIN_KW,
                           backend=cs.one_device_backend(CPU))
    one = cs.phase_dist_one(CPU, pgm, res, tmp_path / "store",
                            backend="gloo", banded_rounds=30)
    assert one["transport"] == "gloo"
    s, b = one["sharded"], one["banded"]
    assert s["bitwise"] and s["launches"] >= s["rounds"] == int(res.rounds)
    # per round the residuals' gather (a world of one has no chain pass
    # and no broadcast); the result's gather
    assert s["collectives"] == s["launches"] + 1
    assert s["staged_bytes"] == 0
    assert s["kernel_check"]["E"] == pgm.n_edges
    assert b["bitwise"] and b["launches"] >= b["rounds"] == 30
    assert s["kernel_check"]["max_abs_err"] == 0.0 == \
        b["kernel_check"]["max_abs_err"]
    gloo = cs.phase_dist_gloo(
        CPU, tmp_path / "gloo", n=12, size=2, bucket=dict(
            frames=2, scene=dict(height=12, width=16, n_disp=4),
            max_rounds=200))
    assert gloo["transport"] == "gloo" and gloo["ranks_bitwise_equal"]
    assert gloo["banded"]["bitwise"]
    for name in ("lbp", "rnbp"):
        g = gloo[name]
        assert g["bitwise"] and g["rounds"] == g["one_rounds"] > 1
        assert g["staged_bytes"] == 0 and g["collectives"] > 2 * g["rounds"]
    c = gloo["bucket"]
    assert c["bitwise"] and len(c["ranks"]) == 2
    assert c["one"]["rounds_each"][0] > 1
    for r in c["ranks"]:
        assert 0.45 < r["share"]["tensor"] <= cs.DIST_SHARE
        assert r["iterations"] >= max(c["one"]["rounds_each"])
        assert r["n_edges"] == 2 * 768
    assert not (tmp_path / "gloo").exists()
    cs.log_dist(dict(one=one, gloo=gloo, main_ms_per_round=1.0))
    by_path = cs.launches_by_path(
        {"launches": {"sum": 1, "t": 0}}, {"launches": 0},
        {"other_launches": {"sum": 0, "max": 0}, "launches": 0},
        {"launches": {"fused_update_e/sum": 0, "fused_update_e/max": 0,
                      "fused_update_t/sum": 0}}, {"launches": {}},
        {"launches": {"sum": 0, "max": 0}}, one,
        {"launches": {"fused_update_e/sum": 0, "fused_update_e/max": 0,
                      "fused_update_t/sum": 0}},
        {"launches": {"fused_update_e/sum": 0, "fused_update_e/max": 0,
                      "fused_update_t/sum": 0}},
        {"launches": {"fused_update_e/sum": 0, "fused_update_e/max": 0,
                      "fused_update_t/sum": 0}},
        {"launches": {"fused_update_e/sum": 0, "fused_update_e/max": 0,
                      "fused_update_t/sum": 0}},
        {"launches": {"fused_update_e/sum": 0, "fused_update_e/max": 0,
                      "fused_update_t/sum": 0}},
        {"launches": {"fused_update_e/sum": 0}},
        {"launches": {"fused_update_e/sum": 0, "fused_update_e/max": 0,
                      "fused_update_t/sum": 0}})
    assert by_path["fused_update_e/sum"]["sharded"] == s["launches"]
    assert by_path["fused_update_e/sum"]["banded"] == b["launches"]


def test_submesh_phase_on_cpu(tmp_path):
    """Phase 23 at a tiny size over gloo: four spawned ranks in two
    sub-meshes of two; (a) ``serve_async`` on one sub-mesh under wall-clock
    ``windowed`` admission with two ingest threads, both ranks' records
    bitwise the one-device yardstick's; (b) ``serve_routed`` round robin
    bitwise the yardstick with each share bitwise its solo sharded run,
    and ``least_loaded`` with stealing on the skewed stream, at least one
    steal, bitwise a one-device run; the slices against the plain update
    (both plain here, so the spawned ranks launch nothing)."""
    out = cs.phase_submesh(
        CPU, tmp_path / "submesh", frames=2,
        scene=dict(height=12, width=16, n_disp=4), zoo_n=4, max_rounds=200,
        skew_fast=cs.SUB_SKEW_FAST, skew_hold=0.2)
    assert out["requests"] == 6 and out["transport"] == "gloo"
    for i, r in out["a"].items():
        assert r["decisions"] == 2 * r["cycles"] + 1 > 2
        assert r["requests_per_s"] > 0 and r["staged_bytes"] == 0
        assert r["collectives"] > 3 * r["cycles"] and r["decision_bytes"]
    assert out["rr"][0]["routed"] == [3, 3]
    # the remote leader (rank 2) sent its replica's records to the front
    assert [r["sent_to_front"]["records"] for r in out["rr"].values()] == \
        [0, 0, 3, 0]
    assert out["rr"][2]["sent_to_front"]["tensor_bytes"] > 0
    assert out["ll"][0]["steals"] >= 1
    assert out["launches"] == {"fused_update_e/sum": 0}
    assert all(r["peak_memory_bytes"] == 0 for r in out["rr"].values())
    assert out["kernel_check"] and out["max_abs_err"] == 0.0
    assert not (tmp_path / "submesh").exists()
    cs.log_submesh(out)


def test_lm_phase_on_cpu():
    """Phase 18's control flow and checks at tiny sizes: every family at
    reduced(), the wide check at two q-blocks of a reduced Qwen3, and the
    served run on a two-layer reduced Qwen3 in bf16."""
    import dataclasses
    from repro_torch import configs as TC
    qwen = TC.get("qwen3_4b").reduced()
    out = cs.phase_lm(
        CPU, wide_cfg=dataclasses.replace(qwen, n_layers=1),
        serve_cfg=dataclasses.replace(qwen, dtype="bfloat16"),
        family=dict(b=1, s=4, steps=2), wide=dict(b=1, s=1024),
        serve=dict(b=2, prefill_len=16, prompt_len=8, gen=4, trace_steps=2))
    assert [f["arch"] for f in out["families"]] == [
        TC.get(a).reduced().name for a in TC.ARCH_IDS]
    for f in out["families"]:
        assert f["prefill_err"] == f["cache_err"] == f["decode_err"] == 0.0
        assert f["syncs_per_step"] is None          # counted on the card only
        assert f["traced_syncs_per_step"] is None
        assert (f["moe_routings"] > 0) == (f["family"] == "moe")
    assert out["wide"]["s"] == 1024 and out["wide"]["prefill_err"] == 0.0
    sv = out["served"]
    assert sv["serve"]["tokens_shape"] == [2, 4]
    assert sv["serve"]["decode_vs_prefill_rel"] <= cs.LM_DECODE_REL
    assert sv["bound"]["decode_ms"] > 0 and sv["bound"]["kv_bytes"] > 0
    assert sv["trace"]["device_ops_per_step"] == 0
    assert out["launches"] == {"fused_update_t/sum": 0,
                               "fused_update_e/sum": 0,
                               "fused_update_e/max": 0}
    cs.log_lm(out)


def test_lm_card_check_rejects_a_wrong_card_result():
    """``lm_err`` raises beyond the tolerance or on another shape, and the
    route recorder sees each MoE layer's choice and then steps aside."""
    import torch
    from repro_torch import configs as TC
    from repro_torch.models import build_model
    from repro_torch.models.layers import moe as M
    a = torch.zeros(3)
    assert cs.lm_err("x", a, a) == 0.0
    with pytest.raises(AssertionError, match="beyond"):
        cs.lm_err("x", a + 2e-4, a)
    with pytest.raises(AssertionError, match="shape"):
        cs.lm_err("x", torch.zeros(2), a)
    cfg = TC.get("granite_moe_3b_a800m").reduced()
    model = build_model(cfg, device="cpu").init_params(torch.Generator())
    real = M._route
    with cs.routes_recorded() as seen:
        model.prefill(cs.lm_inputs(cfg, 2, 5))
    assert M._route is real
    assert [tuple(t.shape) for t in seen] == [(10, 2)] * cfg.n_layers


def test_lm_train_phase_on_cpu(tmp_path):
    """Phase 19's control flow and checks at tiny sizes: every family at
    reduced() (card vs CPU, remat, microbatches, checkpoint and resume),
    the wide check on a one-layer reduced Qwen3, and the trained run on a
    reduced Qwen3 in bf16 whose loss over three batches must fall by
    ``LM_TRAIN_DROP`` in 10 steps."""
    import dataclasses
    from repro_torch import configs as TC
    qwen = TC.get("qwen3_4b").reduced()
    out = cs.phase_lm_train(
        CPU, wide_cfg=dataclasses.replace(qwen, n_layers=1),
        train_cfg=dataclasses.replace(qwen, dtype="bfloat16"),
        family=dict(b=2, s=12, steps=4, ckpt_at=2), wide=dict(b=1, s=64),
        train=dict(b=8, s=64, steps=10, base_lr=3e-2, warmup=1, synced=6,
                   traced=(7, 8)),
        ckpt_dir=tmp_path / "ckpt", peak_bf16=989e12)
    assert [f["arch"] for f in out["families"]] == [
        TC.get(a).reduced().name for a in TC.ARCH_IDS]
    for f in out["families"]:
        assert f["metric_err"] == f["grad_err"] == f["adamw_err"] == 0.0
        assert f["micro_param_diff"] < 5e-3 and f["micro_xent_rel"] <= 1e-4
        assert f["resumed_bitwise"]
        assert f["syncs_per_step"] is None          # counted on the card only
        assert f["traced_syncs_per_step"] is None
    assert not (tmp_path / "ckpt").exists()
    assert out["wide"]["loss_rel"] == out["wide"]["grad_err"] == 0.0
    t = out["trained"]
    assert len(t["losses"]) == len(t["lrs"]) == 10
    assert t["eval_drop"] > cs.LM_TRAIN_DROP and t["tokens_per_s"] > 0
    assert len(t["eval_before"]) == len(t["eval_after"]) == 3
    assert t["step_kinds"] == ["plain"] * 6 + ["synced"] + ["plain"] * 3
    assert t["model_flops_per_step"] == 6.0 * t["params"] * 8 * 64
    assert "trace" not in t and t["peak_memory_bytes"] is None
    assert out["launches"] == {"fused_update_t/sum": 0,
                               "fused_update_e/sum": 0,
                               "fused_update_e/max": 0}
    cs.log_lm_train(out)


def test_lm_train_checks_reject_a_wrong_card_result(monkeypatch):
    """A gradient off by more than the tolerance, a train state one leaf
    of which differs, and a loss that does not fall by the predicted
    margin each raise."""
    import dataclasses
    from repro_torch import configs as TC
    g = torch.linspace(-1, 1, 9)
    assert cs.rel_err("g", g, g, 1e-4) == 0.0
    with pytest.raises(AssertionError, match="beyond"):
        cs.rel_err("g", g + 2e-4 * torch.eye(9)[3], g, 1e-4)
    with pytest.raises(AssertionError, match="shape"):
        cs.rel_err("g", g[:4], g, 1e-4)
    cfg = TC.get("mamba2_130m").reduced()
    (_, a), (_, b) = (cs.train_state_on(cfg, CPU) for _ in range(2))
    cs.same_state("fresh", a, b)
    with torch.no_grad():
        b.opt.nu["blocks.1.ssm.D"][0] += 1e-12
    with pytest.raises(AssertionError, match="1 leaves differ"):
        cs.same_state("corrupted", a, b)
    monkeypatch.setattr(cs, "LM_TRAIN_DROP", 10.0)
    with pytest.raises(AssertionError, match="not 10.0 lower"):
        cs.lm_trained(dataclasses.replace(cfg, n_layers=1), CPU, b=2, s=16,
                      steps=3, base_lr=1e-3, warmup=1, synced=1,
                      traced=(1, 2), peak_bf16=989e12)


def test_lm_shard_phase_constants():
    """Phase 20 serves every family sharded over "model" (none is refused
    any more), Granite as published at B = 4 with phase 18's serving
    sizes, then over two ranks at 256 tokens."""
    from repro_torch import configs as TC
    assert [a for a, _ in cs.LM_SHARD_FAMILIES] == [
        "qwen3_4b", "gemma_7b", "mistral_large_123b", "starcoder2_3b",
        "pixtral_12b"] + ["granite_moe_3b_a800m"] * 3 + [
        "mamba2_130m", "hymba_1_5b", "deepseek_v3_671b", "whisper_medium"]
    assert [d for _, d in cs.LM_SHARD_FAMILIES][5:8] == [
        "ragged", "dense", "sharded"]
    assert {a for a, _ in cs.LM_SHARD_FAMILIES} == set(TC.ARCH_IDS)
    assert cs.LM_SHARD_FAMILY == dict(b=2, s=8, steps=8)
    assert cs.LM_SHARD_RANKS == 2
    assert cs.LM_MOE_SERVE == dict(b=4, prefill_len=1024, prompt_len=64,
                                   gen=32, trace_steps=8)
    assert cs.LM_MOE_SHARDED == dict(s=256, steps=16)
    g = TC.get("granite_moe_3b_a800m")
    assert (g.n_layers, g.d_model, g.n_heads, g.n_kv_heads, g.head_dim,
            g.n_experts, g.d_ff, g.experts_per_token, g.padded_vocab,
            g.tie_embeddings, g.dtype) == (32, 1536, 24, 8, 64, 40, 512, 8,
                                           49408, True, "bfloat16")


def test_lm_shard_phase_on_cpu(tmp_path):
    """Phase 20's control flow and checks at tiny sizes: a world of one
    over gloo, two gloo ranks on the CPU (a block family among the cases),
    a two-layer reduced Granite served whole in bf16, decode against
    prefill in both dtypes, and over the ranks in float32 (held to one
    device) and bf16."""
    import dataclasses
    from repro_torch import configs as TC
    families = cs.shard_families((("qwen3_4b", None),
                                  ("granite_moe_3b_a800m", "sharded"),
                                  ("whisper_medium", None)))
    granite = TC.get("granite_moe_3b_a800m").reduced()
    out = cs.phase_lm_shard(
        CPU, tmp_path / "shard", families=families,
        moe_cfg=dataclasses.replace(granite, dtype="bfloat16"),
        backend="gloo", family=dict(b=2, s=4, steps=2),
        serve=dict(b=2, prefill_len=16, prompt_len=8, gen=4, trace_steps=2),
        sharded=dict(s=8, steps=2), size=2)
    assert set(out["one"]) == {cs.shard_key(c) for c in families}
    assert set(out["families"]) == {
        f"{cs.shard_key(c)} {m}" for c in families for m in ("1x2", "2x1")}
    for f in out["families"].values():
        assert f["err"] <= cs.LM_TOL and f["cache_err"] <= cs.LM_TOL
    sv = out["served"]
    assert sv["world_of_one_bitwise"] and sv["moe_layers"] == 2
    assert sv["syncs_per_step"] is None          # counted on the card only
    d = sv["decode_vs_prefill"]
    assert d["float32"]["rel"] <= cs.LM_TOL
    assert d["float32"]["decisions_per_layer"] == 2 * 8
    assert len(d["bfloat16"]["flips_per_layer"]) == 2
    c = out["sharded"]
    assert set(c) == {"float32/pinned", "bfloat16/pinned", "bfloat16/own"}
    f32 = c["float32/pinned"]
    assert f32["prefill_rel"] <= cs.LM_TOL >= f32["step_rel"]
    assert f32["routes_pinned"] and f32["route_flips"] == 0
    assert f32["route_decisions"] == 2 * (2 * 8 + 2 * 2)
    assert c["bfloat16/pinned"]["routes_pinned"]
    b16 = c["bfloat16/own"]
    assert not b16["routes_pinned"]
    assert b16["transport"] == "gloo" and b16["steps"] == 2
    assert b16["collectives_per_step"] > 0
    assert b16["staged_bytes_per_step"] == 0     # CPU tensors: no staging
    assert max(b16["rank_param_bytes"]) < 0.6 * sv["param_bytes"]
    assert out["launches"] == {"fused_update_t/sum": 0,
                               "fused_update_e/sum": 0,
                               "fused_update_e/max": 0}
    assert not (tmp_path / "shard").exists()
    cs.log_lm_shard(out)


def test_lm_shard_checks_reject_a_wrong_result():
    """``same_run`` raises on one differing bit, ``rel_logit_err`` beyond
    its limit."""
    a = dict(logits=torch.ones(2, 3), steps=[torch.zeros(2, 3)],
             cache={"main": {"k": torch.zeros(1, 2)}})
    b = {k: v for k, v in a.items()}
    cs.same_run("x", a, b)
    b["cache"] = {"main": {"k": torch.tensor([[0.0, 1e-30]])}}
    with pytest.raises(AssertionError, match="cache main/k"):
        cs.same_run("x", a, b)
    b = dict(a, steps=[torch.full((2, 3), 1e-7)])
    with pytest.raises(AssertionError, match="step 0"):
        cs.same_run("x", a, b)
    assert cs.rel_logit_err("x", torch.ones(3), torch.ones(3), 0.03) == 0.0
    with pytest.raises(AssertionError, match="beyond"):
        cs.rel_logit_err("x", torch.ones(3) * 1.05, torch.ones(3), 0.03)


def test_routes_pinned_replays_a_recorded_routing():
    """Pinned to its own recorded routes a model computes what it computed;
    pinned to other experts it computes something else and counts every
    row as a flip."""
    from repro_torch import configs as TC
    from repro_torch.models import build_model
    cfg = TC.get("granite_moe_3b_a800m").reduced()
    model = build_model(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    batch = cs.lm_inputs(cfg, 2, 5)
    with cs.routes_recorded() as seen:
        want, _ = model.prefill(batch)
    with cs.routes_pinned(seen) as flips:
        got, _ = model.prefill(batch)
    assert torch.equal(got, want) and flips == [0] * cfg.n_layers
    other = [(t + 1) % cfg.n_experts for t in seen]
    with cs.routes_pinned(other) as flips:
        got, _ = model.prefill(batch)
    assert not torch.allclose(got, want) and flips == [10] * cfg.n_layers


def test_lm_strain_phase_constants():
    """Phase 21 runs the CPU tests' cases (the ten families tensor-parallel
    at ``reduced()``, every family under "fsdp" widened), Granite's widths
    at two layers, and Granite as published over two ranks at B = 2, S =
    1,024 for 5 steps at base_lr 3e-5, warmup 2."""
    from repro_torch import configs as TC
    assert [a for a, _ in cs.LM_STRAIN_TP] == [
        "qwen3_4b", "gemma_7b", "mistral_large_123b", "starcoder2_3b",
        "pixtral_12b"] + ["granite_moe_3b_a800m"] * 2 + [
        "mamba2_130m", "hymba_1_5b", "deepseek_v3_671b", "whisper_medium"]
    assert [d for _, d in cs.LM_STRAIN_TP][5:7] == ["ragged", "sharded"]
    assert {a for a, _ in cs.LM_STRAIN_TP} == set(TC.ARCH_IDS)
    cases = cs.strain_cases()
    assert len(cases) == 11 + len(TC.ARCH_IDS)
    fsdp = [cfg for _, mode, cfg in cases if mode == "fsdp"]
    assert {c.vocab for c in fsdp} == {16384}
    assert all(c.d_ff == (2048 if c.n_experts else 16384) for c in fsdp)
    # S = 16: pixtral's 8 patches leave 8 text tokens (at S = 8, none)
    assert cs.LM_STRAIN_FAMILY == dict(b=4, s=16, steps=3, base_lr=1e-4,
                                       warmup=1)
    assert cs.LM_STRAIN_WIDE == dict(layers=2, b=2, s=512, steps=3,
                                     base_lr=1e-4, warmup=1)
    assert cs.LM_STRAIN == dict(b=2, s=1024, steps=5, base_lr=3e-5,
                                warmup=2)
    assert cs.LM_STRAIN_RANKS == 2 and cs.LM_STRAIN_SHARE == 0.6


def test_lm_strain_phase_on_cpu(tmp_path):
    """Phase 21's control flow and checks at tiny sizes: a world of one
    over gloo bitwise one device in both modes, two gloo ranks on the CPU
    within LM_TOL of one device and bitwise among themselves, a two-layer
    reduced Granite in float32 (b) and bf16 (c) over the ranks."""
    import dataclasses
    from repro_torch import configs as TC
    keep = ("tp qwen3-4b-reduced", "tp granite-moe-3b-a800m-reduced/sharded",
            "tp hymba-1.5b-reduced", "fsdp mamba2-130m-reduced",
            "fsdp granite-moe-3b-a800m-reduced")
    cases = [c for c in cs.strain_cases() if c[0] in keep]
    granite = dataclasses.replace(TC.get("granite_moe_3b_a800m").reduced(),
                                  moe_dispatch="sharded")
    out = cs.phase_lm_strain(
        CPU, tmp_path / "strain", cases=cases, wide_cfg=granite,
        full_cfg=dataclasses.replace(granite, dtype="bfloat16"),
        backend="gloo", wide=dict(layers=2, b=2, s=16, steps=3,
                                  base_lr=1e-4, warmup=1),
        full=dict(b=2, s=16, steps=3, base_lr=1e-3, warmup=1))
    assert out["one"] == {k: True for k in keep}
    assert set(out["families"]) == {f"{k} 1x2" for k in keep} | {
        f"{k} 2x1" for k in keep if k.startswith("tp")}
    for f in out["families"].values():
        assert f["metric_err"] <= cs.LM_TOL and f["leaf_err"] <= cs.LM_TOL
        assert f["replicated_masters"] > 0 and f["collectives_per_step"] > 0
    assert set(out["wide"]) == {"tp", "fsdp"}
    for w in out["wide"].values():
        assert w["leaf_err"] <= cs.LM_TOL and w["layers"] == 2
        assert w["collectives_per_step"] > 0 and w["step_ms_p50"] > 0
    c = out["full"]
    assert c["mesh"] == (1, 2) and c["transport"] == "gloo"
    assert c["staged_bytes_per_step"] == 0       # CPU tensors: no staging
    assert c["collectives_per_step"] > 0 and len(c["losses"]) == 3
    assert 0.5 <= c["state_share"] <= cs.LM_STRAIN_SHARE
    assert c["rank_state_bytes"][0] == c["rank_state_bytes"][1]
    assert c["eval_drop"] > 0 and c["replicated_masters"] > 0
    assert out["launches"] == {"fused_update_t/sum": 0,
                               "fused_update_e/sum": 0,
                               "fused_update_e/max": 0}
    assert not (tmp_path / "strain").exists()
    cs.log_lm_strain(out)


def test_lm_strain_checks_reject_a_wrong_result():
    """``strain_err`` raises beyond its limit on a metric or a leaf;
    ``strain_same`` on one differing bit."""
    whole = {"params/w": torch.ones(3)}
    m = [{"loss": 1.0, "grad_norm": 10.0}]
    got = cs.strain_err("x", m, whole, m, whole)
    assert got == dict(metric_err=0.0, leaf_err=0.0)
    cs.strain_err("x", [{"loss": 1.0, "grad_norm": 10.0005}], whole, m,
                  whole)                       # grad_norm: relative
    with pytest.raises(AssertionError, match="loss"):
        cs.strain_err("x", [{"loss": 1.001, "grad_norm": 10.0}], whole, m,
                      whole)
    with pytest.raises(AssertionError, match="params/w"):
        cs.strain_err("x", m, {"params/w": torch.tensor([1.0, 1.0, 1.01])},
                      m, whole)

    class State:
        params = {"w": torch.ones(2)}
        opt = type("O", (), dict(mu={"w": torch.zeros(2)},
                                 nu={"w": torch.zeros(2)},
                                 count=torch.tensor(1)))
        step = torch.tensor(1)

    run = dict(metrics=m, g0={"w": torch.ones(2)})
    cs.strain_same("x", (State, run), (State, run))
    with pytest.raises(AssertionError, match="gradients"):
        cs.strain_same("x", (State, dict(run, g0={"w": torch.tensor(
            [1.0, 1.0 + 2 ** -20])})), (State, run))


def test_lm_blocks_phase_constants():
    """Phase 22: Mamba2-130M as published (float32 prefill over 1,024
    tokens and 32 decode steps, 3 train steps; bf16 served at B = 4 and
    trained at B = 2, S = 1,024 for 5 steps), the wide configs at their
    published widths and two layers, over two ranks."""
    from repro_torch import configs as TC
    from repro_torch.models import param_specs
    m = TC.get("mamba2_130m")
    assert (m.n_layers, m.d_model, m.d_inner, m.d_inner // m.ssm_head_p,
            m.ssm_head_p, m.ssm_state, m.padded_vocab, m.tie_embeddings,
            m.dtype) == (24, 768, 1536, 24, 64, 128, 50432, False,
                         "bfloat16")
    assert sum(math.prod(sp.shape) for sp in param_specs(m).values()) == \
        167_788_992
    assert cs.LM_BLOCKS_F32 == dict(b=2, s=1024, steps=32)
    assert cs.LM_BLOCKS_F32_GRADS == dict(b=2, s=256)
    assert cs.LM_BLOCKS_F32_TRAIN == dict(layers=2, b=2, s=1024, steps=3,
                                          base_lr=1e-4, warmup=1)
    assert cs.LM_BLOCKS_SERVE == dict(b=4, s=1024, steps=32)
    assert cs.LM_BLOCKS_TRAIN == dict(b=2, s=1024, steps=5, base_lr=1e-3,
                                      warmup=2)
    assert cs.LM_BLOCKS_WIDE == dict(layers=2, b=2, s=256, steps=16)
    assert cs.LM_BLOCKS_RANKS == 2 and cs.LM_METRIC_TOL == 1e-5
    hymba, deepseek, whisper = cs.blocks_wide_cfgs(2)
    for cfg, arch in ((hymba, "hymba_1_5b"), (deepseek, "deepseek_v3_671b"),
                      (whisper, "whisper_medium")):
        pub = TC.get(arch)
        assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                cfg.vocab) == (pub.d_model, pub.n_heads, pub.n_kv_heads,
                               pub.head_dim, pub.vocab)
        assert cfg.n_layers == 2 and cfg.dtype == "float32"
    assert whisper.n_enc_layers == 2
    assert (deepseek.mla, deepseek.mtp, deepseek.n_experts,
            deepseek.kv_lora_rank, deepseek.q_lora_rank) == (True, True, 0,
                                                             512, 1536)
    bound = cs.blocks_decode_bound(m, 4, 3.35e12)
    assert bound["state_bytes"] == 24 * 4 * (24 * 64 * 128 * 4
                                             + 3 * 1792 * 2)
    assert bound["bytes"] == bound["weight_bytes"] + 2 * bound["state_bytes"]


def test_lm_blocks_phase_on_cpu(tmp_path):
    """Phase 22's control flow and checks at tiny sizes: a two-layer
    reduced Mamba2 on one device, a world of one over gloo bitwise, two
    gloo ranks on the CPU within LM_TOL, bitwise among themselves, served
    and trained in float32 and bf16, and the reduced wide configs."""
    import dataclasses
    from repro_torch import configs as TC
    mamba = dataclasses.replace(TC.get("mamba2_130m").reduced(),
                                dtype="bfloat16")
    wide = [TC.get(a).reduced() for a in ("hymba_1_5b", "deepseek_v3_671b",
                                          "whisper_medium")]
    out = cs.phase_lm_blocks(
        CPU, tmp_path / "blocks", mamba_cfg=mamba, wide_cfgs=wide,
        backend="gloo", f32=dict(b=2, s=16, steps=4),
        f32_grads=dict(b=2, s=16),
        f32_train=dict(layers=1, b=2, s=16, steps=3, base_lr=1e-4, warmup=1),
        serve=dict(b=2, s=16, steps=4),
        train=dict(b=2, s=16, steps=3, base_lr=1e-3, warmup=1),
        wide=dict(layers=2, b=2, s=8, steps=4))
    assert out["world_of_one_bitwise"]
    f = out["f32"]
    assert f["err"] <= cs.LM_TOL and f["cache_err"] <= cs.LM_TOL
    assert f["collectives_per_step"] > 0 and f["staged_bytes_per_step"] == 0
    g = out["grads"]
    assert g["grad_err"] <= cs.LM_TOL and g["metric_err"] <= cs.LM_METRIC_TOL
    assert g["floor"]["grad_err"] == 0.0 and g["replicated_leaves"] > 0
    t = out["train"]
    assert t["metric_err"] <= cs.LM_TOL and t["leaf_err"] <= cs.LM_TOL
    assert t["replicated_masters"] > 0 and t["layers"] == 1
    b = out["bf16"]
    assert b["transport"] == "gloo" and b["steps"] == 4
    assert b["decode_step_ms_p50"] > 0 and b["prefill_tokens_per_s"] > 0
    assert b["collectives_per_step"] > 0 and b["bound"]["decode_ms"] > 0
    assert max(b["rank_param_bytes"]) < 0.6 * sum(b["rank_param_bytes"])
    c = out["full"]
    assert c["mesh"] == (1, 2) and c["state_share"] <= cs.LM_STRAIN_SHARE
    assert c["eval_drop"] > 0 and len(c["losses"]) == 3
    assert set(out["wide"]) == {w.name for w in wide}
    for w in out["wide"].values():
        assert w["err"] <= cs.LM_TOL and w["cache_err"] <= cs.LM_TOL
        assert w["grad_err"] <= cs.LM_TOL
        assert w["metric_err"] <= cs.LM_METRIC_TOL
        assert w["replicated_leaves"] > 0
    assert out["launches"] == {"fused_update_t/sum": 0,
                               "fused_update_e/sum": 0,
                               "fused_update_e/max": 0}
    assert not (tmp_path / "blocks").exists()
    cs.log_lm_blocks(out)


def test_round_cost_phase_on_cpu(counted, tmp_path):
    """Phase 24 at a tiny size: the three counted rounds of a stereo
    bucket through the dispatcher ops, the train step's count on fake
    tensors (Qwen3-4B's reduced config) against a given peak, and the dry
    run on Mamba2-130M alone, both in subprocesses started first."""
    from repro_torch.core import BatchedPGM
    from repro_torch.pgm import stereo_mrf
    batch = BatchedPGM.from_pgms([stereo_mrf(6, 8, 4, seed=i,
                                             device="cpu").pgm
                                  for i in range(2)])
    counts = cs.start_counts(tmp_path / "dry", archs=("mamba2_130m",),
                             train=dict(b=2, s=16), reduced=True)
    first = cs.phase_round_cost(CPU, batch, 2.0, None, counts)
    assert first["launches"] == {"fused_update_e/sum": 1,
                                 "fused_update_e/max": 1,
                                 "fused_update_t/sum": 1}
    for label, r in first["rounds"].items():
        assert r["max_abs_err"] == 0.0, label
        assert 0 < r["kernel_bytes"] < r["bytes"] and r["memory_share"] > 0
    assert first["rounds"]["pallas"]["kernel"] == "fused_update_t"
    t = first["train"]
    assert 0 < t["useful_ratio"] < 1 and t["peak_ratio"] is None
    assert t["predicted_peak_bytes"] >= t["argument_bytes"] > 0
    assert first["dryrun"]["cells"]["mamba2_130m"]["bottleneck"]
    assert first["call_us"]["op"] > 0 and first["call_us"]["direct"] > 0
    cs.log_round_cost(first)
    # the peak check: within 2x either way passes, beyond fails
    peak = t["predicted_peak_bytes"]
    assert cs.check_peak(peak, 1.5 * peak) == pytest.approx(1 / 1.5)
    assert cs.check_peak(peak, peak / 1.9) == pytest.approx(1.9)
    for measured in (2.5 * peak, peak / 2.5):
        with pytest.raises(AssertionError, match="predicted peak"):
            cs.check_peak(peak, measured)
    assert cs.round_parts_ms({"edge_prelude": 1.0, "  gather": 0.5,
                              "fused_update_t": 2.0}) == 3.0
