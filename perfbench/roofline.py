"""The benchmark's own work counts and the table of peaks.

A fused BP message update over E directed edges of S states reads, per
edge, the prelude, the current messages and the candidates' destination
mask (S floats, S floats, S bytes) and writes the candidates and the
residual (S floats, 1 float); it reads each distinct pairwise table of the
inputs (S^2 floats) once: one per undirected edge, whose reverse edge uses
it transposed, or a single one where the inputs give every edge the same
table. Each input byte is read once and each output byte written once,
whatever a kernel reads again or copies. Its flops (about 3 S^2 per edge)
need under a twentieth of the bytes' time at S <= 16 on the cards of
``peaks.json``, so the bytes bound the update. Counted over real edges
only: padding is the implementation's choice, not the inputs' need.

A call's rounds are the most ``BPResult.rounds`` among its graphs: a
call's graphs come from one configuration and share a shape, so a
``run_many`` call is one bucket, and a bucket runs until its slowest graph
is done. Counted from the answers, not from the program's launches, so a
round costs the same work however many kernels carry it out.
"""

from __future__ import annotations

import json
import re
from pathlib import Path

import numpy as np

PEAKS_FILE = Path(__file__).resolve().parent / "peaks.json"


def update_bytes(n_edges: int, n_states: int, n_tables: int) -> int:
    """Bytes the fused update must move over ``n_edges`` directed edges
    of ``n_states`` states whose pairwise tables are ``n_tables`` distinct
    (S, S) tables."""
    s = int(n_states)
    return int(n_edges) * ((3 * s + 1) * 4 + s) + int(n_tables) * s * s * 4


def distinct_tables(pairwise: np.ndarray) -> int:
    """The (S, S) tables an input's ``pairwise`` (E_und, S, S) holds: one
    where it is a view that gives every edge the same table (stride 0 along
    the edges), else one an undirected edge."""
    return 1 if pairwise.strides[0] == 0 else int(pairwise.shape[0])


def input_bytes(inputs: dict) -> int:
    """``update_bytes`` of one graph's raw inputs (``perfbench/inputs``)."""
    return update_bytes(2 * len(inputs["edges"]), inputs["unary"].shape[1],
                        distinct_tables(inputs["pairwise"]))


def card_peaks(device_name: str) -> dict | None:
    """The ``peaks.json`` entry whose ``match`` is in ``device_name``, or
    None for a device the table does not list (the CPU among them)."""
    for card in json.loads(PEAKS_FILE.read_text())["cards"]:
        if card["match"] in device_name:
            return card
    return None


def rounds_run(calls: list) -> int:
    """Rounds the calls ran: each call's most ``BPResult.rounds``."""
    return sum(max(c["rounds"]) for c in calls)


def round_work(calls: list) -> int:
    """Bytes the calls' rounds had to move: each round updates every edge
    of its call's graphs."""
    return sum(max(c["rounds"]) * c["update_bytes"] for c in calls)


def kernel_share(ctx: dict, pattern: str) -> float | None:
    """Percent of its bytes bound that a kernel reached in the traced
    slice: the bytes its calls' rounds had to move at the card's peak
    rate, over the device seconds of the kernels whose names match
    ``pattern``. None without a trace, a known card or a matching kernel
    (a kernel taken off the path, or renamed, leaves its share silent)."""
    trace, peaks = ctx["trace"], ctx["peaks"]
    if not trace or not peaks:
        return None
    rx = re.compile(pattern)
    secs = sum(s for name, (_, s) in trace["kernels"].items()
               if rx.search(name))
    work = round_work(trace["calls"])
    if secs <= 0 or work <= 0:
        return None
    return 100.0 * work / peaks["hbm_bytes_per_s"] / secs
