"""Roofline terms of a step, from counts: the port of
``repro.roofline.analysis``.

Three terms per cell, per device, as in the reference:

    compute    = flops            / peak FLOP/s
    memory     = HBM bytes        / HBM bytes/s
    collective = collective bytes / link bytes/s

The reference reads XLA's compiled program: per-device flops and bytes
from a jaxpr walk of the global program divided by the device count, and
collective bytes from the partitioned HLO's text. The port has no compiled
program. Its counts are one rank's real work, counted as it runs: flops
and bytes by ``op_cost`` (replicated work included), collective bytes by
``dist.comm`` (``STATS["bytes/<kind>"]``, by the reference's HLO
conventions, and ``GROUP_BYTES`` by group). ``analyze`` takes them; it is
the counterpart of ``analyze_compiled``. The raw ``cost_analysis`` flops
of XLA (``RooflineReport.xla_flops_once``) have no counterpart and are not
reported.

Hardware: ``HW`` holds the published peaks of one NVIDIA H100 SXM5 80 GB
(data sheets, not measurements), none of them a TPU's. A group's
collective bytes cross NVLink when all its ranks share one node of
``HW.node_size`` GPUs, and the network between nodes otherwise: on the
``(16, 16)`` production mesh a "model" group spans two nodes of 8.
``model_flops`` is a copy of the reference's, pure arithmetic on the
parameter tree.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import numpy as np

from repro_torch.dist.comm import KINDS
from repro_torch.models.model import stacked_ndim
from repro_torch.roofline.kernel_model import card_peaks

__all__ = ["HW", "RooflineReport", "collective_bytes", "analyze",
           "model_flops"]

@dataclasses.dataclass(frozen=True)
class HW:
    """Published peaks of one NVIDIA H100 SXM5 80 GB: data sheets, not
    measurements."""
    #: dense bf16 tensor-core FLOP/s (NVIDIA H100 data sheet, SXM5)
    peak_flops: float = 989e12
    #: HBM3 bytes/s (the data sheet's 3.35 TB/s, ``kernel_model.CARD_PEAKS``)
    hbm_bw: float = card_peaks("H100")[0]
    #: NVLink 4 bytes/s each way between the GPUs of a node (900 GB/s in
    #: all; data sheet)
    nvlink_bw: float = 450e9
    #: bytes/s of each GPU's 400 Gb/s ConnectX-7 port between nodes (DGX
    #: H100 data sheet)
    net_bw: float = 50e9
    #: HBM bytes (data sheet: 80 GB)
    hbm_bytes: float = 80e9
    #: GPUs a node joins by NVLink (DGX H100)
    node_size: int = 8


def collective_bytes(stats: Optional[Mapping] = None,
                     group_bytes: Optional[Mapping] = None,
                     hw: HW = HW()) -> Dict[str, float]:
    """This rank's collective bytes by kind (``KINDS``) and ``"total"``,
    from ``dist.comm.STATS`` (or ``stats``), and by the links they cross:
    ``"nvlink"`` (a group inside one node of ``hw.node_size``) and
    ``"network"`` (a group across nodes), from ``dist.comm.GROUP_BYTES``
    (or ``group_bytes``)."""
    if stats is None or group_bytes is None:
        from repro_torch.dist import comm
        stats = comm.STATS if stats is None else stats
        group_bytes = comm.GROUP_BYTES if group_bytes is None \
            else group_bytes
    out = {k: float(stats.get(f"bytes/{k}", 0)) for k in KINDS}
    out["total"] = float(sum(out[k] for k in KINDS))
    out["nvlink"] = out["network"] = 0.0
    for ranks, n in group_bytes.items():
        nodes = {r // hw.node_size for r in ranks}
        out["nvlink" if len(nodes) == 1 else "network"] += float(n)
    return out


@dataclasses.dataclass
class RooflineReport:
    """The reference's report (``xla_flops_once`` dropped: no twin)."""
    flops: float                 # per-device flops (op_cost, rank 0)
    hbm_bytes: float             # per-device HBM traffic (op_cost)
    coll_bytes: float            # per-device collective bytes (dist.comm)
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    model_flops: float           # 6*N(_active)*D (train) / 2*N*D (serve)
    useful_ratio: float          # model_flops / (flops * n_devices)
    coll_breakdown: Dict[str, float]
    memory_per_device: Optional[dict] = None

    def as_dict(self):
        return dataclasses.asdict(self)


def analyze(*, flops: float, hbm_bytes: float, n_devices: int,
            coll: Optional[Mapping] = None, model_flops_global: float = 0.0,
            argument_bytes: Optional[float] = None,
            output_bytes: Optional[float] = None,
            peak_bytes: Optional[float] = None,
            hw: HW = HW()) -> RooflineReport:
    """Roofline terms of one cell from one rank's counts (the counterpart
    of ``analyze_compiled``).

    ``flops``/``hbm_bytes``: the rank's (``op_cost``); every rank of a
    cell does the same work, so the useful ratio divides the global model
    flops by ``flops * n_devices``. Weights read by the step are in
    ``hbm_bytes`` already (the dots' operands), so nothing is added for
    them as the reference adds ``param_bytes``. ``coll``:
    ``collective_bytes()``'s dict; its ``"nvlink"`` bytes are charged at
    ``hw.nvlink_bw``, its ``"network"`` bytes at ``hw.net_bw``. The bytes
    the rank holds -- at entry (``argument_bytes``), made for the results
    (``output_bytes``) and at most at once (``peak_bytes``) -- go into
    ``memory_per_device`` with ``peak_ok_80GB``."""
    coll = dict(coll or {})
    t_c = flops / hw.peak_flops
    t_m = hbm_bytes / hw.hbm_bw
    t_x = coll.get("nvlink", 0.0) / hw.nvlink_bw + \
        coll.get("network", 0.0) / hw.net_bw
    terms = {"compute": t_c, "memory": t_m, "collective": t_x}
    bottleneck = max(terms, key=terms.get)
    done = flops * n_devices
    useful = model_flops_global / done \
        if done > 0 and model_flops_global > 0 else 0.0
    mem = None
    if peak_bytes is not None:
        mem = {"argument_bytes": int(argument_bytes or 0),
               "output_bytes": int(output_bytes or 0),
               "peak_bytes": int(peak_bytes),
               "peak_ok_80GB": bool(peak_bytes < hw.hbm_bytes)}
    return RooflineReport(
        flops=flops, hbm_bytes=hbm_bytes, coll_bytes=coll.get("total", 0.0),
        t_compute=t_c, t_memory=t_m, t_collective=t_x,
        bottleneck=bottleneck, model_flops=model_flops_global,
        useful_ratio=useful, coll_breakdown=coll, memory_per_device=mem)


def model_flops(param_specs: Mapping, n_tokens: float, *, cfg=None,
                kind: str = "train") -> float:
    """6*N*D (dense) / 6*N_active*D (MoE), D = processed tokens.

    ``param_specs`` maps the port's parameter names to anything with a
    ``shape`` (``dict(model.named_parameters())``, ``train_state_specs``'s
    meta tensors). kind: train -> 6ND (fwd+bwd); prefill/decode -> 2ND
    (fwd only). Expert leaves (3-D on the reference's stacked tree, leading
    dim = n_experts per layer) are scaled by the active fraction
    top_k / n_experts."""
    total = 0.0
    for name, leaf in param_specs.items():
        n = float(np.prod(leaf.shape))
        if cfg is not None and cfg.n_experts and \
                stacked_ndim(name, leaf) >= 3 and \
                ("moe" in name and "shared" not in name
                 and "router" not in name):
            # stacked experts: (L, E, a, b) or (E, a, b)
            n *= cfg.experts_per_token / cfg.n_experts
        total += n
    mult = 6.0 if kind == "train" else 2.0
    return mult * total * n_tokens
