#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from this checkout with ``nvcc``, holds each
kernel against its plain torch version on the card, drives the port's main
path at full size -- one RnBP inference on a 1000 x 1000 Ising grid
(3,996,032 directed edges) through ``BPEngine(backend="triton")`` -- and
then the paper-size runs, the max-product (MAP) path, a card-vs-CPU
agreement check, kernel timings (CUDA events) and a ``torch.profiler``
trace of main-path rounds (device time by kernel, busy share). Every phase
raises on failure; nothing is caught. Output:

- progress lines per phase;
- the card's name and power limit (``nvidia-smi``);
- one JSON line ``{"kernels": [...]}``: per kernel its launches on its path,
  its largest difference from the plain version, its time, the plain
  version's time and the least time the card could take (``bound_ms``);
- last, ``{"ok": true, "device": {"platform": "gpu", ...}}``.

A fuller report goes to ``chiprun_out/chip_smoke_report.json``. The script
needs one GPU, imports nothing of JAX or of the JAX package ``repro``, and
exits non-zero without a GPU or outside a checkout of the repository.
"""

from __future__ import annotations

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
CHECK_STATES = (2, 3, 8, 32, 81)
CHECK_EDGES = (1, 127, 4096, 3_996_032)
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


def phase_kernels(device, states=CHECK_STATES, edges=CHECK_EDGES,
                  table_bytes=CHECK_TABLE_BYTES):
    """Kernel vs plain version for both semirings over S x E."""
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
                kern = fused_update_e(*ops, semiring=semiring)
                plain = fused_update_e_ref(*ops, semiring=semiring)
                if device.type == "cuda":
                    torch.cuda.synchronize()
                err = compare(semiring, kern, plain)
                worst[semiring] = max(worst[semiring], err)
                log(f"  S={s:3d} E={e:9d} {semiring}: max_abs_err={err:.3g}"
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
    out = {}
    for name, g in (("main", pgm), ("protein", protein)):
        logm = M.init_messages(g)
        pre = M.edge_prelude(g, logm)
        ops = (g.log_psi_e, pre, logm, g.dst_mask)
        e, s = g.n_edges, g.n_states_max
        for semiring in ("sum", "max"):
            k_ms = time_ms(lambda: fused_update_e(*ops, semiring=semiring), 50)
            p_ms = time_ms(lambda: fused_update_e_ref(*ops, semiring=semiring),
                           10)
            b_ms, b_by = bound(e, s, semiring, bw, f32)
            out[f"{name}/{semiring}"] = dict(E=e, S=s, ms=k_ms, plain_ms=p_ms,
                                             bound_ms=b_ms, bound_by=b_by)
            log(f"  {name:7s} {semiring}: E={e} S={s} kernel {k_ms:.4f} ms, "
                f"plain {p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
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


def phase_trace(pgm, device, warm=64, rounds=32):
    """Device time by kernel over ``rounds`` main-path rounds (after
    ``warm`` rounds), from a ``torch.profiler`` trace, and the device's
    busy share against the same window timed without the profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import BPConfig, BPEngine
    eng = BPEngine(BPConfig(scheduler="rnbp", scheduler_kwargs=MAIN_KW,
                            eps=1e-3, max_rounds=2000, backend="triton"),
                   device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    state = eng.step(eng.init(pgm, gen), chunk_rounds=warm)
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
            if "registers" in line or "spill" in line:
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

    launches = {"sum": main["launches"]["sum"], "max": mapd["launches"]}
    kernels = []
    for semiring in ("sum", "max"):
        t = timing[f"main/{semiring}"]
        kernels.append(dict(
            name=f"fused_update_e/{semiring}", route="cuda",
            source=KERNEL_SOURCE, replaces=REPLACES[semiring],
            launches=launches[semiring], max_abs_err=worst[semiring],
            ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=None))
    report = dict(card=smi, device=kind, torch=torch.__version__,
                  cuda=torch.version.cuda, build_s=build_s,
                  kernel_check=worst, main=main, paper=paper, map=mapd,
                  card_vs_cpu=cpu, timing=timing, trace=trace,
                  peak_memory_bytes=torch.cuda.max_memory_allocated(),
                  total_s=time.perf_counter() - t_start, kernels=kernels)
    out_dir = REPO / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_report.json").write_text(
        json.dumps(report, indent=1))
    log(f"== done in {report['total_s']:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
