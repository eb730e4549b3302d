"""Render the roofline table from the port's dry-run records
(``experiments/dryrun_torch/*.json``, written by
``python -m repro_torch.launch.dryrun``).

One row per ``ok`` cell on one mesh: the three roofline terms, the
bottleneck, the useful ratio (model flops over counted flops), the compute
term's share of the three, and whether the predicted peak fits the card's
80 GB (``memory_per_device.peak_ok_80GB``). The terms are counts over the
published peaks of ``roofline.analysis.HW``, not measurements.

Run:  PYTHONPATH=src python -m repro_torch.experiments.render_roofline \\
          [16x16 | 2x16x16]
"""

from __future__ import annotations

import glob
import json
import os
import sys

from repro_torch.roofline.analysis import HW


def hw_note(hw: HW = HW()) -> str:
    """The peaks the terms were charged at."""
    return (f"{hw.peak_flops / 1e12:.0f} TF/s bf16, "
            f"{hw.hbm_bw / 1e9:.0f} GB/s HBM, "
            f"{hw.nvlink_bw / 1e9:.0f} GB/s NVLink, "
            f"{hw.net_bw / 1e9:.0f} GB/s network per GPU "
            f"(H100 SXM5 data sheet, {hw.hbm_bytes / 1e9:.0f} GB)")


def fmt_s(x):
    if x == 0:
        return "0"
    if x < 1e-3:
        return f"{x*1e6:.0f}us"
    if x < 1:
        return f"{x*1e3:.1f}ms"
    return f"{x:.2f}s"


def rows(d="experiments/dryrun_torch", mesh_filter="16x16"):
    """The table's rows: one dict per ``ok`` record on ``mesh_filter``."""
    out = []
    for path in sorted(glob.glob(os.path.join(d, "*.json"))):
        with open(path) as f:
            r = json.load(f)
        if r.get("status") != "ok" or r["mesh"] != mesh_filter:
            continue
        terms = {"compute": r["t_compute"], "memory": r["t_memory"],
                 "collective": r["t_collective"]}
        frac = terms["compute"] / max(sum(terms.values()), 1e-30)
        fit = (r.get("memory_per_device") or {}).get("peak_ok_80GB", None)
        out.append({
            "cell": f"{r['arch']} x {r['shape']}",
            "kind": r["kind"],
            "t_c": terms["compute"], "t_m": terms["memory"],
            "t_x": terms["collective"], "dom": r["bottleneck"],
            "useful": r["useful_ratio"],
            "roofline_frac": frac, "fits": fit,
        })
    return out


def render(d="experiments/dryrun_torch", mesh_filter="16x16"):
    """Print the markdown table and the hardware note; return the rows."""
    table = rows(d, mesh_filter)
    print(f"| cell | kind | compute | memory | collective | bottleneck | "
          f"useful (6ND/counted) | roofline frac | fits 80GB |")
    print("|---|---|---|---|---|---|---|---|---|")
    for r in table:
        fits = "?" if r["fits"] is None else "yes" if r["fits"] else "NO"
        print(f"| {r['cell']} | {r['kind']} | {fmt_s(r['t_c'])} | "
              f"{fmt_s(r['t_m'])} | {fmt_s(r['t_x'])} | **{r['dom']}** | "
              f"{r['useful']:.2f} | {r['roofline_frac']:.2f} | {fits} |")
    print(f"\nterms at {hw_note()}")
    return table


if __name__ == "__main__":
    render(mesh_filter=sys.argv[1] if len(sys.argv) > 1 else "16x16")
