#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from this checkout with ``nvcc``, holds each
kernel against its plain torch version on the card, drives the port's two
main paths at full size and measures them:

- one graph: one RnBP inference on a 1000 x 1000 Ising grid (3,996,032
  directed edges) through ``BPEngine(backend="triton")``, then the
  paper-size runs, the max-product (MAP) path, a card-vs-CPU agreement
  check, kernel timings (CUDA events) and a ``torch.profiler`` trace of
  main-path rounds (device time by kernel, busy share);
- many graphs: ``BPEngine.run_many`` over four 384 x 288 stereo frames at
  16 disparities (the Middlebury "Tsukuba" pair's size; one bucket of
  1,764,352 directed edges) through the ``"pallas"`` backends, whose
  kernel is ``fused_update_t``; slot 0 against its solo run; the zoo
  stream through both bucket paths against the CPU's plain path; then the
  same timings and trace for a batched round.

Both kernels are held against their plain versions at every state count
on a boundary of their launch plans (phases 3 and 9, with the first edges
launched alone against the full launch, bitwise) and on the buckets' own
operands (phase 12); both are timed at every measured shape (the one-graph
S = 2 path, the protein MRF, the stereo bucket, the zoo's widest bucket;
phases 7 and 12).

Every phase raises on failure; nothing is caught. Output:

- progress lines per phase, the kernels' ``-Xptxas -v`` lines first;
- the card's name and power limit (``nvidia-smi``);
- one JSON line ``{"kernels": [...]}``: per kernel its launches on its path,
  its largest difference from the plain version, its time, the plain
  version's time and the least time the card could take (``bound_ms``) at
  the main path's shape, and ``shapes``, the same per measured shape;
- last, ``{"ok": true, "device": {"platform": "gpu", ...}}``.

A fuller report goes to ``chiprun_out/chip_smoke_report.json``. The script
needs one GPU, imports nothing of JAX or of the JAX package ``repro``, and
exits non-zero without a GPU or outside a checkout of the repository.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
SRC = REPO / "src"

NEG_INF = -1.0e30
SUM_TOL = 1e-4                       # sum-product: kernel vs plain, absolute
MAIN_N, MAIN_C = 1000, 2.5           # the main path's Ising grid
MAIN_KW = {"low_p": 0.4, "high_p": 0.9}   # the main path's RnBP
PAPER_N = 200                        # the paper's Ising benchmark size
CPU_N, CPU_C = 100, 2.0              # card-vs-CPU agreement graph
# S on both sides of every boundary of the kernels' launch plans
CHECK_STATES = (1, 2, 3, 8, 9, 15, 16, 17, 31, 32, 33, 51, 64, 81, 127, 128)
CHECK_EDGES = (1, 127, 4096, 3_996_032)
SUB_EDGES = 37                       # the sub-launch check's first edges
CHECK_TABLE_BYTES = 1 << 30          # cap E so one (E, S, S) table <= 1 GiB

# Published peaks (NVIDIA data sheets): device memory bytes/s and float32
# (non-tensor-core) FLOP/s, by a substring of torch.cuda.get_device_name().
CARD_PEAKS = (("H100 PCIe", 2.0e12, 51e12), ("H100 NVL", 3.9e12, 60e12),
              ("H200", 4.8e12, 67e12), ("H100", 3.35e12, 67e12))

# Per-edge flops of the fused update, (S^2, S, 1) coefficients -- the hand
# count of the reference's roofline kernel model.
FLOPS_PER_EDGE = {"sum": (5.0, 24.0, 6.0), "max": (2.0, 14.0, 1.0)}
REPLACES = {"sum": "src/repro/kernels/triton_update.py:103",
            "max": "src/repro/kernels/triton_update.py:125"}
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/fused_update_e.cu"

# The batched main path: four stereo frames at the Middlebury "Tsukuba"
# pair's size (384 x 288, 16 disparity levels) in one bucket, RnBP.
STEREO = {"height": 288, "width": 384, "n_disp": 16}
STEREO_FRAMES, STEREO_ROUNDS = 4, 1000
ZOO_N, ZOO_EPS, ZOO_ROUNDS = 36, 1e-4, 2000    # the zoo stream, LBP
CHECK_T_STATES = CHECK_STATES + (200, 300)   # 300: the walk variant
CHECK_T_EDGES = (1, 127, 4096, 1_764_352)
T_SOURCE = "src/repro_torch/kernels/csrc/fused_update_t.cu"
T_REPLACES = "src/repro/kernels/message_update.py:59"
RESULT_FIELDS = ("logm", "beliefs", "rounds", "updates", "converged",
                 "max_residual", "unconverged_history", "sched_state")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_peaks(name: str):
    for key, bw, f32 in CARD_PEAKS:
        if key in name:
            return bw, f32
    raise RuntimeError(f"no published peaks for {name!r}; add it to "
                       "CARD_PEAKS")


def bound(e: int, s: int, semiring: str, bw: float, f32: float):
    """(bound_ms, bound_by) of one fused update over e edges of s states:
    each input read once, each output written once, (S^2+3S+1)*4 + S bytes
    per edge, against the card's memory rate and float32 peak."""
    nbytes = e * ((s * s + 3 * s + 1) * 4 + s)
    a, b, c = FLOPS_PER_EDGE[semiring]
    flops = e * (a * s * s + b * s + c)
    t_bytes, t_ops = nbytes / bw * 1e3, flops / f32 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean ms per call on the card, CUDA events around ``iters`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20) -> float:
    """Mean device time per call of the CUDA kernels ``fn`` launches, from
    a ``torch.profiler`` trace of ``iters`` warm calls: the kernel's own
    time, without the host's launch overhead that CUDA events around
    back-to-back calls include when a call is short. 0.0 off the card."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        return 0.0
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(ev.time_range.elapsed_us() for ev in prof.events()
                if ev.device_type == DeviceType.CUDA)
    return total / iters / 1e3


def random_operands(e: int, s: int, gen, device):
    """Kernel inputs with NEG_INF invalid states, all-masked rows (every
    7th edge) and source rows with no valid state (every 11th edge)."""
    import torch
    kw = dict(generator=gen, device=device)
    logpsi = torch.randn((e, s, s), **kw)
    valid_dst = torch.rand((e, s), **kw) < 0.8
    valid_dst[::7] = False
    valid_src = torch.rand((e, s), **kw) < 0.8
    valid_src[::11] = False
    pre = torch.where(valid_src, 3.0 * torch.randn((e, s), **kw), NEG_INF)
    logm = torch.where(valid_dst, 2.0 * torch.randn((e, s), **kw) - 3.0,
                       NEG_INF)
    return logpsi, pre, logm, valid_dst.to(torch.int8)


def compare(semiring: str, kern, plain) -> float:
    """Largest |kernel - plain| over finite entries; raises when NEG_INF
    entries differ, when max-product is not bitwise equal, or when
    sum-product differs by more than SUM_TOL."""
    import torch
    (nk, rk), (np_, rp) = kern, plain
    if not torch.equal(nk == NEG_INF, np_ == NEG_INF):
        raise AssertionError(f"{semiring}: NEG_INF entries differ")
    if semiring == "max":
        if not (torch.equal(nk, np_) and torch.equal(rk, rp)):
            raise AssertionError("max-product kernel is not bitwise equal "
                                 "to its plain version")
        return 0.0
    finite = nk != NEG_INF
    err = max(float((nk - np_).abs()[finite].max()) if bool(finite.any())
              else 0.0, float((rk - rp).abs().max()) if rk.numel() else 0.0)
    if not err <= SUM_TOL:
        raise AssertionError(f"sum-product kernel differs from its plain "
                             f"version by {err} > {SUM_TOL}")
    return err


def first_edges(t, k: int, edges_last: bool):
    """The first ``k`` edges of an operand or output, as a new contiguous
    tensor: rows of an edge-major tensor, columns (the last axis) of a
    transposed one; a 1-D tensor is always per edge."""
    if edges_last and t.dim() > 1:
        return t[..., :k].contiguous()
    return t[:k].contiguous()


def check_sub_launch(name, fn, ops, kern, k, edges_last=False) -> None:
    """The first ``k`` edges launched alone give bitwise the output they
    have inside the full launch ``kern = fn(*ops)``; raises otherwise. An
    edge's arithmetic must not depend on E or on its place in the launch.
    The phases run it on the card only: the plain versions on the CPU are
    vectorized over edges and may round an edge's last bit by its place."""
    import torch
    k = min(k, int(ops[1].shape[-1 if edges_last else 0]))
    part = fn(*(first_edges(t, k, edges_last) for t in ops))
    if not all(torch.equal(p, first_edges(f, k, edges_last))
               for p, f in zip(part, kern)):
        raise AssertionError(f"{name}: the first {k} edges launched alone "
                             "differ from the same edges in the full launch")


def phase_kernels(device, states=CHECK_STATES, edges=CHECK_EDGES,
                  table_bytes=CHECK_TABLE_BYTES, sub=SUB_EDGES):
    """Kernel vs plain version for both semirings over S x E, and the first
    ``sub`` edges alone against the full launch, bitwise."""
    import torch
    from repro_torch.kernels.ref import fused_update_e_ref
    from repro_torch.kernels.triton_update import fused_update_e
    gen = torch.Generator(device=device).manual_seed(0)
    worst = {"sum": 0.0, "max": 0.0}
    for s in states:
        for e_want in edges:
            e = min(e_want, max(1, table_bytes // (4 * s * s)))
            ops = random_operands(e, s, gen, device)
            for semiring in ("sum", "max"):
                def fn(*o, semiring=semiring):
                    return fused_update_e(*o, semiring=semiring)
                kern = fn(*ops)
                plain = fused_update_e_ref(*ops, semiring=semiring)
                sync(device)
                err = compare(semiring, kern, plain)
                if device.type == "cuda":
                    check_sub_launch(f"fused_update_e/{semiring} S={s} "
                                     f"E={e}", fn, ops, kern, sub)
                worst[semiring] = max(worst[semiring], err)
                log(f"  S={s:3d} E={e:9d} {semiring}: max_abs_err={err:.3g}, "
                    f"first {min(sub, e)} edges alone: bitwise"
                    + ("" if e == e_want else f" (E cut from {e_want})"))
            del ops, kern, plain
    return worst


def run_engine(pgm, device, *, scheduler="lbp", scheduler_kwargs=(),
               eps=1e-3, max_rounds=2000, backend="triton", seed=0):
    """One ``BPEngine.run``; returns (result, seconds) with the card
    synchronized before the clock stops."""
    import torch
    from repro_torch.core import BPConfig, BPEngine
    engine = BPEngine(BPConfig(scheduler=scheduler,
                               scheduler_kwargs=scheduler_kwargs, eps=eps,
                               max_rounds=max_rounds, backend=backend),
                      device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = engine.run(pgm, gen)
    if device.type == "cuda":
        torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def check_beliefs(pgm, res) -> None:
    """Finite log-marginals of shape (V, S) that normalize over the valid
    states of every real vertex."""
    import torch
    b = res.beliefs
    if tuple(b.shape) != (pgm.n_vertices, pgm.n_states_max):
        raise AssertionError(f"beliefs shape {tuple(b.shape)}")
    if not bool(torch.isfinite(b).all()):
        raise AssertionError("non-finite beliefs")
    n = pgm.n_real_vertices
    p = torch.where(pgm.state_mask[:n], b[:n].exp(), 0.0).sum(dim=1)
    if not bool(((p - 1.0).abs() < 1e-4).all()):
        raise AssertionError("beliefs do not normalize")


def phase_main(device, n=MAIN_N, c=MAIN_C):
    """The port's main path: RnBP on an n x n Ising grid through the
    kernel backend, launch counts reset just before and read just after."""
    from repro_torch.kernels import triton_update as K
    from repro_torch.pgm import ising_grid_fast
    t0 = time.perf_counter()
    pgm = ising_grid_fast(n, c, seed=0, device=device)
    build_s = time.perf_counter() - t0
    K.reset_launch_counts()
    res, secs = run_engine(pgm, device, scheduler="rnbp",
                           scheduler_kwargs=MAIN_KW, eps=1e-3,
                           max_rounds=2000, backend="triton")
    launches = dict(K.LAUNCHES)
    rounds = int(res.rounds)
    check_beliefs(pgm, res)
    if launches["sum"] < max(rounds, 1):
        raise AssertionError(f"kernel launches {launches['sum']} < rounds "
                             f"{rounds}: the main path bypassed the kernel")
    out = dict(graph=f"ising_grid_fast({n}, {c}, seed=0)", n_edges=pgm.n_edges,
               n_vertices=pgm.n_vertices, graph_build_s=build_s,
               rounds=rounds, converged=bool(res.converged),
               max_residual=float(res.max_residual),
               updates=int(res.updates), run_s=secs,
               ms_per_round=secs * 1e3 / max(rounds, 1), launches=launches)
    return pgm, res, out


def phase_paper(device, n=PAPER_N, protein_vertices=120):
    """LBP/RBP/RS/RnBP on Ising n x n (C=2.5) and on the protein-like MRF,
    then max-product LBP through the kernel (its own launch count) against
    the plain max-product backend."""
    import torch
    from repro_torch.core.messages import map_assignment
    from repro_torch.kernels import triton_update as K
    from repro_torch.kernels.ops import make_triton_update
    from repro_torch.pgm import ising_grid_fast, protein_like_graph
    graphs = {f"ising{n}": ising_grid_fast(n, 2.5, seed=0, device=device),
              "protein": protein_like_graph(protein_vertices, seed=0,
                                            device=device)}
    scheds = (("lbp", {}), ("rbp", {}), ("rs", {}), ("rnbp", MAIN_KW))
    rows = []
    for gname, pgm in graphs.items():
        for sname, kw in scheds:
            res, secs = run_engine(pgm, device, scheduler=sname,
                                   scheduler_kwargs=kw)
            check_beliefs(pgm, res)
            row = dict(graph=gname, scheduler=sname, rounds=int(res.rounds),
                       converged=bool(res.converged), run_s=secs,
                       edges=pgm.n_edges, states=pgm.n_states_max)
            rows.append(row)
            log(f"  {gname:8s} {sname:5s} rounds={row['rounds']:5d} "
                f"converged={row['converged']} {secs * 1e3:.1f} ms")
    pgm = graphs[f"ising{n}"]
    K.reset_launch_counts()
    res_k, secs = run_engine(pgm, device, scheduler="lbp", max_rounds=500,
                             backend=make_triton_update(semiring="max"))
    max_launches = K.LAUNCHES["max"]
    res_p, _ = run_engine(pgm, device, scheduler="lbp", max_rounds=500,
                          backend="maxprod")
    if max_launches < max(int(res_k.rounds), 1):
        raise AssertionError("max-product path bypassed the kernel")
    map_k = map_assignment(pgm, res_k.logm)
    map_p = map_assignment(pgm, res_p.logm)
    if int(res_k.rounds) != int(res_p.rounds) or not torch.equal(map_k, map_p) \
            or not torch.equal(res_k.logm, res_p.logm):
        raise AssertionError("max-product kernel path differs from the plain "
                             "max-product backend")
    mapd = dict(graph=f"ising{n}", rounds=int(res_k.rounds),
                converged=bool(res_k.converged), run_s=secs,
                launches=max_launches,
                ones=int(map_k[:pgm.n_real_vertices].sum()))
    log(f"  MAP ising{n}: rounds={mapd['rounds']} converged="
        f"{mapd['converged']} launches={max_launches} bitwise == maxprod")
    return rows, mapd


def phase_card_vs_cpu(device, n=CPU_N, c=CPU_C):
    """LBP through the kernel on the card and its plain version on the CPU:
    equal rounds, beliefs within 1e-4."""
    import torch
    from repro_torch.pgm import ising_grid_fast
    cpu = torch.device("cpu")
    res_d, _ = run_engine(ising_grid_fast(n, c, seed=0, device=device), device)
    res_c, _ = run_engine(ising_grid_fast(n, c, seed=0, device=cpu), cpu)
    diff = float((res_d.beliefs.cpu().exp() - res_c.beliefs.exp()).abs().max())
    if int(res_d.rounds) != int(res_c.rounds) or not diff <= 1e-4:
        raise AssertionError(f"card vs CPU: rounds {int(res_d.rounds)} vs "
                             f"{int(res_c.rounds)}, belief diff {diff}")
    return dict(graph=f"ising_grid_fast({n}, {c})", rounds=int(res_d.rounds),
                max_prob_diff=diff)


def phase_timing(pgm, device, bw, f32, protein):
    """CUDA-event times of the kernel and its plain version at the main
    path's shape and at the protein-like MRF's shape, plus the other parts
    of one main-path round."""
    import torch
    from repro_torch.core import messages as M
    from repro_torch.core.schedulers import RnBP
    from repro_torch.kernels.ref import fused_update_e_ref
    from repro_torch.kernels.triton_update import fused_update_e
    from repro_torch.kernels.message_update import fused_update_t
    from repro_torch.kernels.ref import fused_update_t_ref
    out = {}
    for name, g in (("main", pgm), ("protein", protein)):
        logm = M.init_messages(g)
        pre = M.edge_prelude(g, logm)
        ops = (g.log_psi_e, pre, logm, g.dst_mask)
        e, s = g.n_edges, g.n_states_max
        for semiring in ("sum", "max"):
            def kern(semiring=semiring):
                return fused_update_e(*ops, semiring=semiring)
            k_ms = time_ms(kern, 50)
            p_ms = time_ms(lambda: fused_update_e_ref(*ops, semiring=semiring),
                           10)
            b_ms, b_by = bound(e, s, semiring, bw, f32)
            out[f"{name}/{semiring}"] = dict(E=e, S=s, ms=k_ms, plain_ms=p_ms,
                                             device_ms=device_ms(kern),
                                             bound_ms=b_ms, bound_by=b_by)
            log(f"  {name:7s} {semiring}: E={e} S={s} kernel {k_ms:.4f} ms "
                f"(device {out[f'{name}/{semiring}']['device_ms']:.4f}), "
                f"plain {p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    # fused_update_t at the one-graph shape (the protein shape is phase 12's)
    logm = M.init_messages(pgm)
    logpsi_t, dmask_t = pgm.operands_t
    ops_t = (logpsi_t, M.edge_prelude(pgm, logm).t().contiguous(),
             logm.t().contiguous(), dmask_t)
    err = compare("sum", fused_update_t(*ops_t), fused_update_t_ref(*ops_t))
    e, s = pgm.n_edges, pgm.n_states_max
    b_ms, b_by = bound(e, s, "sum", bw, f32)
    out["main/t"] = dict(E=e, S=s, max_abs_err=err, bound_ms=b_ms,
                         bound_by=b_by,
                         ms=time_ms(lambda: fused_update_t(*ops_t), 50),
                         device_ms=device_ms(lambda: fused_update_t(*ops_t)),
                         plain_ms=time_ms(lambda: fused_update_t_ref(*ops_t),
                                          10))
    log(f"  main    fused_update_t: E={e} S={s} kernel "
        f"{out['main/t']['ms']:.4f} ms (device "
        f"{out['main/t']['device_ms']:.4f}), plain "
        f"{out['main/t']['plain_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
        f"max_abs_err={err:.3g}")
    del ops_t, logpsi_t, dmask_t
    # One main-path round, part by part.
    logm = M.init_messages(pgm)
    cand, r = fused_update_e(pgm.log_psi_e, M.edge_prelude(pgm, logm), logm,
                             pgm.dst_mask)
    sched = RnBP(**MAIN_KW)
    st = sched.init(pgm)
    gen = torch.Generator(device=device).manual_seed(1)
    unc = ((r >= 1e-3) & pgm.edge_mask).sum().to(torch.int32)
    frontier, _ = sched.select(pgm, r, 1e-3, gen, st, unc)
    parts = {
        "vertex_logprod": lambda: M.vertex_logprod(pgm, logm),
        "edge_prelude": lambda: M.edge_prelude(pgm, logm),
        "unconverged_count": lambda: ((r >= 1e-3) & pgm.edge_mask).sum(),
        "rnbp_select": lambda: sched.select(pgm, r, 1e-3, gen, st, unc),
        "apply_frontier": lambda: M.apply_frontier(logm, cand, frontier),
    }
    out["round_parts_ms"] = {k: time_ms(f, 20) for k, f in parts.items()}
    for k, v in out["round_parts_ms"].items():
        log(f"  round part {k}: {v:.4f} ms")
    return out


def phase_trace(graph, device, warm=64, rounds=32, config=None, rng=None):
    """Device time by kernel over ``rounds`` rounds of ``graph`` (one graph
    or a bucket) after ``warm`` rounds, from a ``torch.profiler`` trace,
    and the device's busy share against the same window timed without the
    profiler. ``config`` defaults to the one-graph main path's."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import BPConfig, BPEngine
    eng = BPEngine(config or BPConfig(
        scheduler="rnbp", scheduler_kwargs=MAIN_KW, eps=1e-3,
        max_rounds=2000, backend="triton"), device=device)
    if rng is None:
        rng = torch.Generator(device=device).manual_seed(0)
    state = eng.step(eng.init(graph, rng), chunk_rounds=warm)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    eng.step(state, chunk_rounds=rounds)
    sync()
    wall_ms = (time.perf_counter() - t0) * 1e3
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        eng.step(state, chunk_rounds=rounds)
        sync()
    by_name, n_kernels = {}, 0
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            by_name[ev.name] = (by_name.get(ev.name, 0.0)
                                + ev.time_range.elapsed_us() / 1e3)
            n_kernels += 1
    device_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return dict(rounds=rounds, wall_ms_per_round=wall_ms / rounds,
                device_ms_per_round=device_ms / rounds,
                busy_share=device_ms / wall_ms,
                kernels_per_round=n_kernels / rounds,
                top_ms_per_round={k: v / rounds for k, v in top})


def phase_kernels_t(device, states=CHECK_T_STATES, edges=CHECK_T_EDGES,
                    table_bytes=CHECK_TABLE_BYTES, sub=SUB_EDGES):
    """The TPU-layout kernel ``fused_update_t`` vs its plain version over
    S x E, operands transposed from ``random_operands``, and the first
    ``sub`` edges alone against the full launch, bitwise."""
    import torch
    from repro_torch.kernels.message_update import fused_update_t
    from repro_torch.kernels.ref import fused_update_t_ref
    gen = torch.Generator(device=device).manual_seed(1)
    worst = 0.0
    for s in states:
        for e_want in edges:
            e = min(e_want, max(1, table_bytes // (4 * s * s)))
            logpsi, pre, logm, dmask = random_operands(e, s, gen, device)
            ops = (logpsi.permute(1, 2, 0).contiguous(), pre.t().contiguous(),
                   logm.t().contiguous(), dmask.t().contiguous())
            del logpsi, pre, logm, dmask
            kern = fused_update_t(*ops)
            plain = fused_update_t_ref(*ops)
            sync(device)
            err = compare("sum", kern, plain)
            if device.type == "cuda":
                check_sub_launch(f"fused_update_t S={s} E={e}",
                                 fused_update_t, ops, kern, sub,
                                 edges_last=True)
            worst = max(worst, err)
            log(f"  S={s:3d} E={e:9d} sum: max_abs_err={err:.3g}, first "
                f"{min(sub, e)} edges alone: bitwise"
                + ("" if e == e_want else f" (E cut from {e_want})"))
            del ops, kern, plain
    return worst


def batched_config(max_rounds=STEREO_ROUNDS):
    """The batched main path's config: RnBP through both ``"pallas"``
    backends."""
    from repro_torch.core import BPConfig
    return BPConfig(scheduler="rnbp", scheduler_kwargs=MAIN_KW, eps=1e-3,
                    max_rounds=max_rounds, backend="pallas",
                    batch_backend="pallas")


def sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize()


def instrument(engine, counts):
    """Shadow ``engine.run`` and ``engine.step`` so that every ``run`` --
    one per bucket under ``run_many`` -- appends a record to the returned
    list: the bucket's shape, its loop iterations (rounds in which some
    graph was active), its largest round count, the kernel launches it
    added to ``counts["sum"]`` and its seconds on the host clock, the card
    synchronized at both ends. ``del engine.run, engine.step`` undoes it."""
    records, iters = [], []
    run, step = engine.run, engine.step

    def counted_step(state, **kw):
        out = step(state, **kw)
        iters.append(int(out.chunk_iters))
        return out

    def counted_run(graph, rng=None, **kw):
        sync(graph.device)
        iters.clear()
        before, t0 = counts["sum"], time.perf_counter()
        res = run(graph, rng, **kw)
        sync(graph.device)
        records.append(dict(
            size=graph.size, edges=graph.n_edges, states=graph.n_states_max,
            seconds=time.perf_counter() - t0, iterations=sum(iters),
            rounds=int(res.rounds.max()), launches=counts["sum"] - before))
        return res

    engine.run, engine.step = counted_run, counted_step
    return records


def check_bucket_launches(label, records) -> None:
    """Each bucket's kernel launches cover its loop iterations, which
    cover its rounds."""
    for b in records:
        if b["launches"] < max(b["iterations"], 1) or \
                b["iterations"] < b["rounds"]:
            raise AssertionError(f"{label}: bucket {b} bypassed the kernel")


def same_result(a, b, i=None) -> bool:
    """Every field of result ``b`` bitwise equal to ``a`` (row ``i`` of a
    bucket's result when given)."""
    import torch
    for f in RESULT_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        if not isinstance(x, torch.Tensor):
            continue
        if not torch.equal(x if i is None else x[i], y):
            return False
    return True


def phase_batched(device, frames=STEREO_FRAMES, scene=STEREO,
                  max_rounds=STEREO_ROUNDS):
    """The batched main path: ``run_many`` over ``frames`` stereo scenes
    (one bucket) through the ``"pallas"`` backends, launch counts reset
    just before and read just after; then slot 0 against a solo run of
    ``batch.graph(0)`` with its own generator, bitwise."""
    import torch
    from repro_torch.core import BPEngine, bucket_pgms, slot_generator
    from repro_torch.kernels import message_update as MU
    from repro_torch.kernels import triton_update as TT
    from repro_torch.pgm import stereo_mrf
    cuda = device.type == "cuda"
    t0 = time.perf_counter()
    scenes = [stereo_mrf(scene["height"], scene["width"], scene["n_disp"],
                         seed=s, device=device) for s in range(frames)]
    pgms = [sc.pgm for sc in scenes]
    build_s = time.perf_counter() - t0
    eng = BPEngine(batched_config(max_rounds), device=device)
    records = instrument(eng, MU.LAUNCHES)
    sync(device)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    MU.reset_launch_counts()
    TT.reset_launch_counts()
    t0 = time.perf_counter()
    results = eng.run_many(pgms, 0)
    sync(device)
    run_s = time.perf_counter() - t0
    launches, other = MU.LAUNCHES["sum"], dict(TT.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    del eng.run, eng.step
    if len(records) != 1:
        raise AssertionError(f"{len(records)} buckets, expected one")
    check_bucket_launches("stereo", records)
    loop = records[0]
    frames_out = []
    for sc, pgm, res in zip(scenes, pgms, results):
        check_beliefs(pgm, res)
        n = pgm.n_real_vertices
        labels = res.beliefs[:n, :sc.n_disp].argmax(dim=1).cpu().numpy()
        frames_out.append(dict(rounds=int(res.rounds),
                               converged=bool(res.converged),
                               max_residual=float(res.max_residual),
                               within_1_of_truth=sc.accuracy(labels)))
    bucket, = bucket_pgms(pgms)
    gi = bucket.indices[0]
    solo = eng.run(bucket.batch.graph(0), slot_generator(0, gi, device))
    if not same_result(solo, results[gi]):
        raise AssertionError("slot 0 of the stereo bucket differs from its "
                             "solo run")
    out = dict(graph=f"{frames} x stereo_mrf({scene['height']}, "
               f"{scene['width']}, {scene['n_disp']}, seed=0..{frames - 1})",
               batch=bucket.batch.size, n_edges=bucket.batch.n_edges,
               n_vertices=bucket.batch.n_vertices,
               n_states=bucket.batch.n_states_max, graph_build_s=build_s,
               run_many_s=run_s, loop_s=loop["seconds"],
               bucketing_s=run_s - loop["seconds"],
               iterations=loop["iterations"],
               ms_per_iteration=loop["seconds"] * 1e3
               / max(loop["iterations"], 1),
               launches=launches, other_launches=other,
               peak_memory_bytes=peak, frames=frames_out,
               slot0_bitwise_solo=True, solo_rounds=int(solo.rounds))
    return bucket.batch, out


def phase_zoo(device, n=ZOO_N, eps=ZOO_EPS, max_rounds=ZOO_ROUNDS):
    """``run_many`` over ``zoo_stream(n)`` with LBP on the card, through the
    fold path (``backend="pallas"``) and through ``batch_backend="triton"``,
    against the CPU's plain path: a request that converges on the CPU
    converges on the card in as many rounds with beliefs within 1e-4; one
    that does not, does not. Each bucket's kernel launches cover its loop
    iterations."""
    import torch
    from repro_torch.core import BPConfig, BPEngine
    from repro_torch.kernels import message_update as MU
    from repro_torch.kernels import triton_update as TT
    from repro_torch.pgm import zoo_stream
    cpu = torch.device("cpu")
    cfg = BPConfig(scheduler="lbp", eps=eps, max_rounds=max_rounds)
    kinds = [k for k, _ in zoo_stream(n, seed=0, device=cpu)]
    ref = BPEngine(cfg, device=cpu).run_many(
        [p for _, p in zoo_stream(n, seed=0, device=cpu)], 0)
    pgms = [p for _, p in zoo_stream(n, seed=0, device=device)]
    out = {}
    for label, over, counts in (
            ("fold/pallas", dict(backend="pallas"), MU.LAUNCHES),
            ("batch/triton", dict(batch_backend="triton"), TT.LAUNCHES)):
        eng = BPEngine(dataclasses.replace(cfg, **over), device=device)
        per_bucket = instrument(eng, counts)
        MU.reset_launch_counts()
        TT.reset_launch_counts()
        res = eng.run_many(pgms, 0)
        del eng.run, eng.step
        check_bucket_launches(label, per_bucket)
        worst, unconverged = 0.0, []
        for i, (r_card, r_cpu) in enumerate(zip(res, ref)):
            if not bool(r_cpu.converged):
                unconverged.append(i)
                if bool(r_card.converged):
                    raise AssertionError(f"{label}: request {i} converged on "
                                         "the card, not on the CPU")
                continue
            diff = float((r_card.beliefs.cpu().exp()
                          - r_cpu.beliefs.exp()).abs().max())
            if not bool(r_card.converged) or not diff <= 1e-4 or \
                    int(r_card.rounds) != int(r_cpu.rounds):
                raise AssertionError(
                    f"{label}: request {i} ({kinds[i]}) rounds "
                    f"{int(r_card.rounds)} vs {int(r_cpu.rounds)} on the CPU, "
                    f"converged {bool(r_card.converged)}, belief diff {diff}")
            worst = max(worst, diff)
        out[label] = dict(buckets=per_bucket, max_prob_diff=worst,
                          not_converged_on_cpu=unconverged,
                          rounds=[int(r.rounds) for r in res])
        log(f"  {label}: {len(pgms)} requests in {len(per_bucket)} buckets, "
            f"rounds equal to the CPU's, max belief diff {worst:.3g}, "
            f"not converged on the CPU: {unconverged or 'none'}")
        for rec in per_bucket:
            log(f"    bucket B={rec['size']} E={rec['edges']} "
                f"S={rec['states']}: {rec['iterations']} iterations, "
                f"{rec['launches']} launches")
    out["kinds"] = kinds
    return out


def phase_protein_pallas(device, protein_vertices=120):
    """RnBP on the protein-like MRF (S = 81) through the ``"pallas"``
    backend: ``fused_update_t``'s launches at that shape, counts reset just
    before and read just after."""
    from repro_torch.kernels import message_update as MU
    from repro_torch.pgm import protein_like_graph
    pgm = protein_like_graph(protein_vertices, seed=0, device=device)
    MU.reset_launch_counts()
    res, secs = run_engine(pgm, device, scheduler="rnbp",
                           scheduler_kwargs=MAIN_KW, backend="pallas")
    launches = MU.LAUNCHES["sum"]
    check_beliefs(pgm, res)
    if launches < max(int(res.rounds), 1):
        raise AssertionError("the protein run bypassed fused_update_t")
    return dict(graph=f"protein_like_graph({protein_vertices}, seed=0)",
                rounds=int(res.rounds), converged=bool(res.converged),
                launches=launches, run_s=secs)


def widest_bucket(device, n=ZOO_N):
    """The zoo stream's bucket with the most states."""
    from repro_torch.core import bucket_pgms
    from repro_torch.pgm import zoo_stream
    buckets = bucket_pgms([p for _, p in zoo_stream(n, seed=0,
                                                    device=device)])
    return max(buckets, key=lambda b: b.batch.n_states_max).batch


def phase_timing_batched(batch, others, device, bw, f32):
    """Both kernels held against their plain versions on a bucket's union
    -- the operands the batched main path gives them -- and CUDA-event
    times of each kernel and plain version (``fused_update_e`` in both
    semirings), at the stereo bucket's shape and at each of ``others``
    (name -> bucket); then the parts of one batched round of the stereo
    bucket."""
    import torch
    from repro_torch.core import messages as M
    from repro_torch.core.batch import batch_generators
    from repro_torch.core.schedulers import RnBP
    from repro_torch.kernels.message_update import fused_update_t
    from repro_torch.kernels.ref import fused_update_e_ref, fused_update_t_ref
    from repro_torch.kernels.triton_update import fused_update_e
    out = {}
    for name, b in (("stereo", batch), *others.items()):
        union = b.folded()
        logm = M.init_messages(union)
        pre = M.edge_prelude(union, logm)
        logpsi_t, dmask_t = union.operands_t
        ops_t = (logpsi_t, pre.t().contiguous(), logm.t().contiguous(),
                 dmask_t)
        ops_e = (union.log_psi_e, pre, logm, union.dst_mask)
        e, s = union.n_edges, union.n_states_max
        err = compare("sum", fused_update_t(*ops_t), fused_update_t_ref(*ops_t))
        b_ms, b_by = bound(e, s, "sum", bw, f32)
        row = dict(B=b.size, E=e, S=s, max_abs_err=err, bound_ms=b_ms,
                   bound_by=b_by,
                   ms=time_ms(lambda: fused_update_t(*ops_t), 50),
                   device_ms=device_ms(lambda: fused_update_t(*ops_t)),
                   plain_ms=time_ms(lambda: fused_update_t_ref(*ops_t), 10),
                   e={})
        log(f"  {name:7s} B={b.size} E={e} S={s}: fused_update_t "
            f"{row['ms']:.4f} ms (device {row['device_ms']:.4f}), plain "
            f"{row['plain_ms']:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}), max_abs_err={err:.3g}")
        for semiring in ("sum", "max"):
            def kern(semiring=semiring):
                return fused_update_e(*ops_e, semiring=semiring)

            def plain(semiring=semiring):
                return fused_update_e_ref(*ops_e, semiring=semiring)
            e_err = compare(semiring, kern(), plain())
            eb_ms, eb_by = bound(e, s, semiring, bw, f32)
            row["e"][semiring] = dict(
                max_abs_err=e_err, bound_ms=eb_ms, bound_by=eb_by,
                ms=time_ms(kern, 50), device_ms=device_ms(kern),
                plain_ms=time_ms(plain, 10))
            log(f"  {name:7s} fused_update_e/{semiring}: "
                f"{row['e'][semiring]['ms']:.4f} ms (device "
                f"{row['e'][semiring]['device_ms']:.4f}), plain "
                f"{row['e'][semiring]['plain_ms']:.4f} ms, bound "
                f"{eb_ms:.4f} ms ({eb_by}), max_abs_err={e_err:.3g}")
        out[name] = row
        del ops_t, ops_e, pre, logm
    # One batched round of the stereo bucket, part by part.
    union = batch.folded()
    bsz, e_b, s = batch.size, batch.n_edges, batch.n_states_max
    logm = M.init_messages(union)
    pre = M.edge_prelude(union, logm)
    logpsi_t, dmask_t = union.operands_t
    pre_t, logm_t = pre.t().contiguous(), logm.t().contiguous()
    new_t, resid = fused_update_t(logpsi_t, pre_t, logm_t, dmask_t)
    cand = new_t.t().contiguous().reshape(bsz, e_b, s)
    r = resid.reshape(bsz, e_b)
    sched = RnBP(**MAIN_KW)
    st = sched.init_batch(batch)
    gens = batch_generators(1, bsz, device)
    unc = ((r >= 1e-3) & batch.pgm.edge_mask).sum(dim=1).to(torch.int32)
    frontier, _ = sched.select_batch(batch, r, 1e-3, gens, st, unc)
    lm = logm.reshape(bsz, e_b, s)
    vsum = M.vertex_logprod(union, logm)
    src, rev = union.edge_src, union.edge_rev
    parts = {
        "edge_prelude": lambda: M.edge_prelude(union, logm),
        "  vertex_logprod": lambda: M.vertex_logprod(union, logm),
        "  gather logm[in_edges]": lambda: logm[union.in_edges],
        "  gather vsum[edge_src]": lambda: vsum[src],
        "  gather logm[edge_rev]": lambda: logm[rev],
        "  gather log_psi_v[edge_src]": lambda: union.log_psi_v[src],
        "  gather state_mask[edge_src]": lambda: union.state_mask[src],
        "transposes (pre, logm in; new out)": lambda: (
            pre.t().contiguous(), logm.t().contiguous(),
            new_t.t().contiguous()),
        "fused_update_t": lambda: fused_update_t(logpsi_t, pre_t, logm_t,
                                                 dmask_t),
        "unconverged_count": lambda: ((r >= 1e-3) & batch.pgm.edge_mask).sum(
            dim=1),
        "rnbp_select_batch (B draws)": lambda: sched.select_batch(
            batch, r, 1e-3, gens, st, unc),
        "apply_frontier": lambda: M.apply_frontier(lm, cand, frontier),
    }
    out["round_parts_ms"] = {k: time_ms(f, 20) for k, f in parts.items()}
    for k, v in out["round_parts_ms"].items():
        log(f"  round part {k}: {v:.4f} ms")
    return out


def kernels_line(timing, btiming, worst, worst_t, launches, launches_t):
    """The ``{"kernels": [...]}`` entries: per kernel its main path's
    launches, its largest difference from the plain version over phases 3,
    7, 9 and 12, the main path's shape's times and bound, and ``shapes``,
    one ``{E, S, ms, device_ms, bound_ms, plain_ms}`` per timed shape
    (``ms`` from CUDA events around back-to-back calls, ``device_ms`` the
    kernel's own time from the profiler; the one-graph
    S = 2 path, the protein MRF, the stereo bucket, the zoo's widest
    bucket)."""
    def shape(name, row):
        return dict(shape=name, E=row["E"], S=row["S"], ms=row["ms"],
                    device_ms=row["device_ms"], bound_ms=row["bound_ms"],
                    plain_ms=row["plain_ms"])

    kernels = []
    for semiring in ("sum", "max"):
        t = timing[f"main/{semiring}"]
        shapes = [shape("main", t),
                  shape("protein", timing[f"protein/{semiring}"])]
        for name in ("stereo", "zoo"):
            row = btiming[name]
            shapes.append(shape(name, dict(row["e"][semiring], E=row["E"],
                                           S=row["S"])))
        err = max([worst[semiring]] + [r["e"][semiring]["max_abs_err"]
                                       for r in btiming.values()
                                       if "e" in r])
        kernels.append(dict(
            name=f"fused_update_e/{semiring}", route="cuda",
            source=KERNEL_SOURCE, replaces=REPLACES[semiring],
            launches=launches[semiring], max_abs_err=err,
            ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=None, shapes=shapes))
    t = btiming["stereo"]
    err = max([worst_t, timing["main/t"]["max_abs_err"]]
              + [r["max_abs_err"] for r in btiming.values()
                 if "max_abs_err" in r])
    shapes = [shape("main", timing["main/t"]),
              shape("protein", btiming["protein"]), shape("stereo", t),
              shape("zoo", btiming["zoo"])]
    kernels.append(dict(
        name="fused_update_t/sum", route="cuda", source=T_SOURCE,
        replaces=T_REPLACES, launches=launches_t, max_abs_err=err,
        ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
        bound_by=t["bound_by"], library_ms=None, shapes=shapes))
    return kernels


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one NVIDIA GPU", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it from "
              "a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    device = torch.device("cuda")
    t_start = time.perf_counter()

    log("== 1. card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    smi = smi.splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    bw, f32 = card_peaks(kind)
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]} device {kind} x{torch.cuda.device_count()}")

    log("== 2. build")
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    reports = _build.build()
    build_s = time.perf_counter() - t0
    for name, text in reports.items():
        for line in text.splitlines():
            if any(w in line for w in ("entry function", "registers",
                                       "spill", "smem")):
                log(f"  {name}: {line.strip()}")
    log(f"  built {sorted(reports) or 'nothing (cached)'} in {build_s:.2f} s")

    log("== 3. kernel vs plain version on the card")
    worst = phase_kernels(device)

    log("== 4. main path at full size")
    pgm, res, main = phase_main(device)
    log(f"  {main['graph']}: E={main['n_edges']} V={main['n_vertices']} "
        f"rounds={main['rounds']} converged={main['converged']} "
        f"max_residual={main['max_residual']:.3g} "
        f"{main['ms_per_round']:.3f} ms/round "
        f"launches={main['launches']['sum']}")

    log("== 5. paper-size runs")
    paper, mapd = phase_paper(device)

    log("== 6. card vs CPU")
    cpu = phase_card_vs_cpu(device)
    log(f"  {cpu['graph']} LBP: rounds={cpu['rounds']} on both, max belief "
        f"diff {cpu['max_prob_diff']:.3g}")

    log("== 7. timing (CUDA events, warm)")
    from repro_torch.pgm import protein_like_graph
    timing = phase_timing(pgm, device, bw, f32,
                          protein_like_graph(seed=0, device=device))
    log("  library_ms: null -- no single PyTorch call computes the fused "
        "update")

    log("== 8. device trace of the main path (torch.profiler)")
    trace = phase_trace(pgm, device)
    log(f"  {trace['rounds']} rounds: {trace['wall_ms_per_round']:.3f} ms/round "
        f"wall (no profiler), device busy {trace['device_ms_per_round']:.3f} "
        f"ms/round = share {trace['busy_share']:.3f}, "
        f"{trace['kernels_per_round']:.1f} kernels/round")
    for name, ms in trace["top_ms_per_round"].items():
        log(f"  {ms:.4f} ms/round  {name[:110]}")

    del pgm, res

    log("== 9. TPU-layout kernel vs plain version on the card")
    worst_t = phase_kernels_t(device)

    log("== 10. batched main path at full size (run_many, stereo bucket)")
    batch, bmain = phase_batched(device)
    log(f"  {bmain['graph']}: B={bmain['batch']} E={bmain['n_edges']} per "
        f"graph S={bmain['n_states']}: run_many {bmain['run_many_s']:.3f} s "
        f"= bucketing {bmain['bucketing_s']:.3f} s + loop "
        f"{bmain['loop_s']:.3f} s; {bmain['iterations']} iterations, "
        f"{bmain['ms_per_iteration']:.3f} ms/iteration, "
        f"launches={bmain['launches']}, peak memory "
        f"{bmain['peak_memory_bytes'] / 2**30:.2f} GiB")
    for i, f in enumerate(bmain["frames"]):
        log(f"  frame {i}: rounds={f['rounds']} converged={f['converged']} "
            f"max_residual={f['max_residual']:.3g} argmax within 1 of truth "
            f"{f['within_1_of_truth']:.4f}")
    log(f"  slot 0 bitwise equal to its solo run ({bmain['solo_rounds']} "
        "rounds)")

    log("== 11. zoo stream: both bucket paths vs the CPU's plain path")
    zoo = phase_zoo(device)

    log("== 12. TPU-layout kernel vs plain version at the buckets' shapes; "
        "batched timing (CUDA events, warm)")
    from repro_torch.core import BatchedPGM
    btiming = phase_timing_batched(batch, {
        "zoo": widest_bucket(device),
        "protein": BatchedPGM.from_pgms([protein_like_graph(
            seed=0, device=device)])}, device, bw, f32)

    protein_t = phase_protein_pallas(device)
    log(f"  {protein_t['graph']} RnBP through \"pallas\": rounds="
        f"{protein_t['rounds']} converged={protein_t['converged']} "
        f"fused_update_t launches={protein_t['launches']}")

    log("== 13. device trace of the batched path (torch.profiler)")
    btrace = phase_trace(batch, device, warm=16, config=batched_config(),
                         rng=0)
    log(f"  {btrace['rounds']} rounds: {btrace['wall_ms_per_round']:.3f} "
        f"ms/round wall (no profiler), device busy "
        f"{btrace['device_ms_per_round']:.3f} ms/round = share "
        f"{btrace['busy_share']:.3f}, {btrace['kernels_per_round']:.1f} "
        "kernels/round")
    for name, ms in btrace["top_ms_per_round"].items():
        log(f"  {ms:.4f} ms/round  {name[:110]}")

    kernels = kernels_line(
        timing, btiming, worst, worst_t,
        {"sum": main["launches"]["sum"], "max": mapd["launches"]},
        bmain["launches"])
    report = dict(card=smi, device=kind, torch=torch.__version__,
                  cuda=torch.version.cuda, build_s=build_s,
                  kernel_check=worst, main=main, paper=paper, map=mapd,
                  card_vs_cpu=cpu, timing=timing, trace=trace,
                  kernel_check_t=worst_t, batched=bmain, zoo=zoo,
                  batched_timing=btiming, protein_pallas=protein_t,
                  batched_trace=btrace,
                  peak_memory_bytes=torch.cuda.max_memory_allocated(),
                  total_s=time.perf_counter() - t_start, kernels=kernels)
    out_dir = REPO / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_report.json").write_text(
        json.dumps(report, indent=1))
    log(f"== done in {report['total_s']:.1f} s (total_s)")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
