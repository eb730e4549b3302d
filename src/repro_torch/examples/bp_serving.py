"""End-to-end driver: batched BP inference service (the paper's workload).

The paper's algorithm is an *inference* engine, so the end-to-end driver is
a serving loop: a stream of PGM inference requests (mixed Ising / chain /
protein-like graphs) runs through the serving pipeline
(``repro_torch.core.serving``) -- requests are grouped into
shape-homogeneous buckets, each bucket runs folded into one graph, and
between chunks the engine *evacuates* converged graphs (their results are
released immediately) and backfills the freed slots from the pending
queue, so one straggler no longer holds a whole bucket's worth of
finished work hostage.

Default mode reproduces the legacy synchronous ``BPEngine.serve`` cadence
(one resident bucket, stream staged up front). ``--async`` switches to the
full pipeline: the request stream is consumed as an *online iterator*,
padding and staging copies overlap device chunks across double-buffered
bucket slots, and once the queue drains the survivors are *compacted*
into narrower buckets so dead slots stop costing sweeps.

Knobs:
  --async          online iterator + double-buffered slots + compaction
  --growth         bucketing policy: 2.0 bounds padding waste for steady
                   traffic over few shape families, ``inf`` collapses a
                   shape-diverse cold stream into a single bucket
                   (sync mode only; online needs per-request shapes)
  --max-batch      resident bucket width (slots that evacuation recycles)
  --chunk-rounds   rounds per device chunk between evacuation sweeps
  --no-evacuate    baseline: run every bucket to completion
  --policy         admission policy: fifo (default) | residual (co-batch
                   by expected effort) | windowed (delay for fullness) |
                   deadline (SLA tier: slack-ordered admission, slot
                   packing, mid-flight eviction of hopeless requests)
  --window-ms      windowed policy's admission window
  --slo-ms         per-request latency budget attached to the stream
                   (enables SLO-attainment reporting; the deadline
                   policy evicts what will miss it)
  --ingest-threads feeder threads pulling the stream behind a bounded
                   queue (0 = pull on the serving thread)
  --replicas       N > 1 serves through the router tier
                   (repro_torch.serve): N pipelines on their own threads
                   (and, on the card, their own CUDA streams) behind one
                   front-end
  --routing        routing policy for the router tier: round_robin |
                   least_loaded | kind_affinity | deadline
  --steal          cross-replica work stealing: a drained replica pulls
                   a batch from the deepest peer's inbox
  --workload       request mix: legacy (historic 3-kind stream), mixed
                   (the full heterogeneous zoo_stream -- ising/chain/
                   protein/ldpc/stereo at mixed sizes), or any one
                   registered zoo generator (repro_torch.pgm.WORKLOADS)
  --scheduler      message scheduler (rnbp default); --backend picks the
                   update backend -- these flags (and --policy/--routing)
                   take their choices from the live registries via
                   list_schedulers / list_backends /
                   list_admission_policies / list_routing_policies, so
                   --help always shows exactly what is registered
  --device         cuda (default; raises without a GPU) or cpu. Without
                   --backend the card runs "triton" (the fused kernel
                   fused_update_e) and the CPU "ref"; an explicit
                   --backend is taken as given ("pallas" reaches
                   fused_update_t)

Run:  PYTHONPATH=src python -m repro_torch.examples.bp_serving [--async]
          [--requests 12]
      PYTHONPATH=src python -m repro_torch.examples.bp_serving --async \\
          --policy residual --ingest-threads 2
      PYTHONPATH=src python -m repro_torch.examples.bp_serving \\
          --replicas 2 --routing least_loaded --steal
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.core import (BPConfig, BPEngine, list_admission_policies,
                              list_backends, list_schedulers, serve_async)
from repro_torch.core.graph import resolve_device
from repro_torch.examples import sum_backend
from repro_torch.pgm import (chain_graph, get_workload, ising_grid,
                             list_workloads, protein_like_graph, zoo_stream)
from repro_torch.serve import list_routing_policies, serve_routed


def request_stream(n, workload="legacy", device="cuda"):
    """(rid, kind, pgm) triples: the historic 3-kind mix (``legacy``), the
    full heterogeneous zoo (``mixed``), or one registered zoo workload;
    every graph built on ``device``."""
    if workload == "legacy":
        kinds = [
            lambda s: ("ising30/C2.5", ising_grid(30, 2.5, seed=s,
                                                  device=device)),
            lambda s: ("chain2000/C10", chain_graph(2000, seed=s,
                                                    device=device)),
            lambda s: ("protein60", protein_like_graph(60, seed=s,
                                                       device=device)),
        ]
        for i in range(n):
            yield (i,) + kinds[i % 3](i)
    elif workload == "mixed":
        for i, (kind, pgm) in enumerate(zoo_stream(n, device=device)):
            yield i, kind, pgm
    else:
        gen = get_workload(workload)
        for i in range(n):
            yield i, workload, gen(seed=i, device=device)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=9)
    ap.add_argument("--eps", type=float, default=1e-3)
    ap.add_argument("--async", dest="async_mode", action="store_true",
                    help="online pipeline: double-buffered slots, prefetch "
                         "staging, bucket compaction")
    ap.add_argument("--growth", type=float, default=2.0,
                    help="bucket edge-ceiling growth factor; inf = 1 bucket "
                         "(sync mode only: online bucketing needs "
                         "per-request shapes)")
    ap.add_argument("--max-batch", type=int, default=4,
                    help="resident bucket width (evacuated slots backfill)")
    ap.add_argument("--chunk-rounds", type=int, default=512,
                    help="rounds per chunk between evacuation sweeps")
    ap.add_argument("--no-evacuate", action="store_true",
                    help="baseline: run each bucket to completion")
    # choices= come from the registries (repro_torch.core.registry), so the
    # CLI surface cannot drift from what is actually registered.
    ap.add_argument("--policy", default="fifo",
                    choices=list_admission_policies(),
                    help="admission policy")
    ap.add_argument("--scheduler", default="rnbp",
                    choices=list_schedulers(),
                    help="message scheduler; rnbp (default) uses the "
                         "paper's protein-run kwargs")
    ap.add_argument("--backend", default=None, choices=list_backends(),
                    help="message-update backend (BPConfig.backend); "
                         "default: triton on the card, ref on the CPU")
    ap.add_argument("--window-ms", type=float, default=10.0,
                    help="windowed policy: admission window in ms")
    ap.add_argument("--slo-ms", type=float, default=None,
                    help="latency budget per request in ms; attaches "
                         "(rid, pgm, slo) triples to the stream and "
                         "reports SLO attainment + evictions")
    ap.add_argument("--ingest-threads", type=int, default=0,
                    help="feeder threads pulling the request stream "
                         "(0 = pull on the serving thread)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="serving replicas behind the router tier "
                         "(repro_torch.serve); > 1 implies the async "
                         "pipeline")
    ap.add_argument("--routing", default="round_robin",
                    choices=list_routing_policies(),
                    help="router placement policy")
    ap.add_argument("--steal", action="store_true",
                    help="cross-replica work stealing when a replica's "
                         "pending work drains below its low watermark")
    ap.add_argument("--workload", default="legacy",
                    choices=["legacy", "mixed"] + list_workloads(),
                    help="request mix: the historic 3-kind stream "
                         "(legacy), the heterogeneous zoo_stream (mixed), "
                         "or one registered zoo generator")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; fails without a GPU) or 'cpu'")
    return ap


def run(args, log=lambda *a, **k: None) -> dict:
    """Serve ``args.requests`` requests as the flags say. ``log`` receives
    the mode line as soon as serving starts. Returns ``backend``,
    ``mode``, ``kinds`` (rid -> kind), the serving result (``result``:
    records, stats, percentiles) and ``wall_s``."""
    device = resolve_device(args.device)
    backend = args.backend or sum_backend(device)
    sched_kwargs = ({"low_p": 0.4, "high_p": 0.9}  # paper's protein run
                    if args.scheduler == "rnbp" else {})
    engine = BPEngine(BPConfig(
        scheduler=args.scheduler, scheduler_kwargs=sched_kwargs,
        backend=backend, eps=args.eps, max_rounds=6000, history=False),
        device=device)

    t_all = time.perf_counter()
    kinds = {}
    admission_kwargs = ({"window_s": args.window_ms / 1e3}
                        if args.policy == "windowed" else {})
    kw = dict(max_batch=args.max_batch, chunk_rounds=args.chunk_rounds,
              evacuate=not args.no_evacuate, admission=args.policy,
              admission_kwargs=admission_kwargs,
              ingest_threads=args.ingest_threads)
    slo_s = None if args.slo_ms is None else args.slo_ms / 1e3

    def online():
        # Online path: the generator is consumed lazily; each request is
        # padded and staged the moment it is pulled (bucket_shape
        # ceilings), overlapped with the in-flight device chunks. With an
        # SLO the items become (rid, pgm, slo) deadline triples.
        for rid, kind, pgm in request_stream(args.requests, args.workload,
                                             device):
            kinds[rid] = kind
            yield pgm if slo_s is None else (rid, pgm, slo_s)

    if args.replicas > 1:
        mode = "routed"
        log(f"{args.requests} requests (router tier: {args.replicas} "
            f"replicas, routing={args.routing}, steal={args.steal}, "
            f"policy={args.policy})", flush=True)
        rep = serve_routed(engine, online(), 0, replicas=args.replicas,
                           routing=args.routing, steal=args.steal,
                           growth=args.growth, slots=2,
                           prefetch=2 * args.max_batch, device=device, **kw)
    elif args.async_mode:
        mode = "async"
        log(f"{args.requests} requests (async pipeline, "
            f"width={args.max_batch}, policy={args.policy}, "
            f"ingest_threads={args.ingest_threads})", flush=True)
        rep = serve_async(engine, online(), 0, growth=args.growth, slots=2,
                          prefetch=2 * args.max_batch, **kw)
    else:
        mode = "sync"
        stream = list(request_stream(args.requests, args.workload, device))
        kinds = {r[0]: r[1] for r in stream}
        pgms = [r[2] for r in stream]
        t_build = time.perf_counter() - t_all
        log(f"{args.requests} requests (growth={args.growth}, "
            f"width={args.max_batch}); build {t_build:.2f}s", flush=True)
        # Same bitwise results as engine.serve(...) -- the materialized
        # plan with one resident slot is the legacy driver -- but routed
        # through the pipeline so per-request latency is recorded. (With
        # an SLO the stream carries deadline triples and runs online.)
        items = pgms if slo_s is None else [
            (r[0], r[2], slo_s) for r in stream]
        rep = serve_async(engine, items, 0, growth=args.growth,
                          compact=False, slots=1, prefetch=None, **kw)
    return dict(backend=backend, mode=mode, kinds=kinds, result=rep,
                wall_s=time.perf_counter() - t_all)


def report(args, out) -> dict:
    """The request lines and the summary, as the reference prints them;
    returns the numbers behind them (``requests``: per rid ``kind``,
    ``tag``, ``rounds``, ``p_x0``, ``replica``, ``stolen``; ``converged``;
    ``latency_ms``, ``admission_ms``, ``service_ms`` percentiles;
    ``stats``; ``slo``)."""
    rep, kinds = out["result"], out["kinds"]
    done = failed = 0
    requests = {}
    by_rid = {rec.rid: rec for rec in rep.records}
    for rid in sorted(by_rid):
        rec = by_rid[rid]
        ok = bool(rec.result.converged)
        done += ok
        failed += not ok
        tag = "EVIC" if rec.evicted else ("ok  " if ok else "FAIL")
        marg = np.exp(rec.result.beliefs[0].cpu().numpy())
        replica = getattr(rec, "replica", None)
        stolen = bool(getattr(rec, "stolen", False))
        where = (f" r{replica}{'*' if stolen else ' '}"
                 if args.replicas > 1 else "")
        print(f"req {rid:3d} {kinds[rid]:14s} "
              f"{tag} rounds={int(rec.result.rounds):5d} "
              f"latency={rec.latency_s * 1e3:8.1f}ms "
              f"(queue {rec.queue_s * 1e3:7.1f}ms){where} "
              f"P(x0)={np.round(marg[:2], 3)}", flush=True)
        requests[rid] = dict(kind=kinds[rid], tag=tag.strip(),
                             rounds=int(rec.result.rounds), p_x0=marg[:2],
                             replica=replica, stolen=stolen)

    s = rep.stats
    wall = out["wall_s"]
    pct = rep.latency_percentiles((50, 95, 99))
    # Admission wait and device residency report separately: the wait is
    # what the admission policy trades (windowed raises it for fuller
    # buckets), the service time is what the device actually cost.
    adm = rep.latency_percentiles((50, 95, 99), field="admission")
    svc = rep.latency_percentiles((50, 95, 99), field="service")
    policy = (f"routing={s.policy}" if args.replicas > 1
              else f"policy={s.policy}")
    print(f"\nserved {done}/{args.requests} converged "
          f"({failed} unconverged) in {wall:.1f}s "
          f"({args.requests / wall:.1f} graphs/s, {policy})")
    slo = None
    if args.slo_ms is not None:
        attained = sum(1 for rec in rep.records if rec.within_slo)
        evicted = sum(1 for rec in rep.records if rec.evicted)
        slo = dict(attained=attained, evicted=evicted)
        print(f"SLO {args.slo_ms:.0f}ms: attainment "
              f"{attained}/{len(rep.records)} "
              f"({100 * attained / max(len(rep.records), 1):.0f}%), "
              f"{evicted} evicted")
    print(f"latency ms:        p50={pct['p50']:.1f} p95={pct['p95']:.1f} "
          f"p99={pct['p99']:.1f}")
    print(f"admission-wait ms: p50={adm['p50']:.1f} p95={adm['p95']:.1f} "
          f"p99={adm['p99']:.1f}")
    print(f"service ms:        p50={svc['p50']:.1f} p95={svc['p95']:.1f} "
          f"p99={svc['p99']:.1f}")
    if args.replicas > 1:
        # * in the request lines marks work-stolen requests.
        stats = dict(replicas=s.replicas, routed=s.routed, steals=s.steals,
                     stolen=s.stolen, device_sweeps=rep.device_sweeps,
                     useful_sweeps=rep.useful_sweeps,
                     wasted_sweeps=rep.wasted_sweeps)
        print(f"replicas={s.replicas} routed={s.routed} "
              f"steals={s.steals} stolen={s.stolen} "
              f"sweeps: device={rep.device_sweeps} "
              f"useful={rep.useful_sweeps} wasted={rep.wasted_sweeps}")
    else:
        stats = dict(chunks=s.chunks, evacuated=s.evacuated,
                     backfilled=s.backfilled, compactions=s.compactions,
                     admission_holds=s.admission_holds,
                     device_sweeps=s.device_sweeps,
                     useful_sweeps=s.useful_sweeps,
                     wasted_sweeps=s.wasted_sweeps)
        print(f"chunks={s.chunks} evacuated={s.evacuated} "
              f"backfilled={s.backfilled} compactions={s.compactions} "
              f"admission_holds={s.admission_holds} "
              f"sweeps: device={s.device_sweeps} "
              f"useful={s.useful_sweeps} wasted={s.wasted_sweeps}")
    return dict(requests=requests, converged=done, wall_s=wall,
                requests_per_s=args.requests / wall, latency_ms=pct,
                admission_ms=adm, service_ms=svc, stats=stats, slo=slo,
                backend=out["backend"], mode=out["mode"])


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    print(f"backend={args.backend or sum_backend(device)} device={device}",
          flush=True)
    return report(args, run(args, log=print))


if __name__ == "__main__":
    main()
