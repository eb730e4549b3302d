"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU, with no
GPU: production cells counted as rank 0 of a fake world of 256 ranks, in
a subprocess (the fake world must not meet the other tests' process
groups).

Two cheap production cells -- Mamba2-130M and Qwen3-4B at ``decode_32k``
on the ``(16, 16)`` mesh -- and one BP cell (``bp_ising_512``, the
rank-resident ``"sharded"`` path) return ``ok``; each LM cell's parameter
bytes per rank are what ``launch.sharding``'s specs give; a cell sharded
over "model" moves collective bytes, counted by ``dist.comm`` by kind and
charged at the link its groups cross; the records hold the reference's
report fields (``xla_flops_once`` aside) and the global count over the
devices. The analysis (``roofline.analysis``) is checked on its own too.
"""

import json
import pathlib
import subprocess
import sys

import pytest
import torch
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

from repro_torch import configs as TC
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.launch.sharding import local_shape, param_shardings
from repro_torch.models.model import param_specs
from repro_torch.roofline import analysis as RA

REPO = pathlib.Path(__file__).resolve().parent.parent
CELLS = ("mamba2_130m", "qwen3_4b", "bp_ising_512")
#: the reference's report fields the port keeps
REPORT = ("flops", "hbm_bytes", "coll_bytes", "t_compute", "t_memory",
          "t_collective", "bottleneck", "model_flops", "useful_ratio",
          "coll_breakdown", "memory_per_device")


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    """{arch: record} of one dry run of ``CELLS`` at ``decode_32k`` on the
    single-pod mesh, and the run's stdout."""
    out = tmp_path_factory.mktemp("dryrun")
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin",
           "OMP_NUM_THREADS": "1"}
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun",
         "--arch", ",".join(CELLS), "--shape", "decode_32k",
         "--mesh", "single", "--out", str(out)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
    recs = {}
    for path in out.glob("*.json"):
        rec = json.loads(path.read_text())
        recs[rec["arch"]] = rec
    return recs, run.stdout


def test_cells_are_ok_and_counted(cells):
    recs, stdout = cells
    assert sorted(recs) == sorted(CELLS)
    assert "cells: 3; failures: 0" in stdout
    for arch, rec in recs.items():
        assert rec["status"] == "ok", rec.get("trace")
        assert rec["mesh"] == "16x16" and set(REPORT) <= set(rec)
        assert "xla_flops_once" not in rec
        assert rec["flops"] > 0 and rec["hbm_bytes"] > 0
        assert 0 < rec["useful_ratio"] < 1
        mem = rec["memory_per_device"]
        assert mem["peak_bytes"] >= mem["argument_bytes"] > 0
        assert mem["peak_ok_80GB"]
        g = rec["global_over_devices"]
        assert 0 < g["flops"] <= rec["flops"]
    assert recs["bp_ising_512"]["kind"] == "bp"
    assert recs["bp_ising_512"]["rounds"] == 100


@pytest.mark.parametrize("arch", ["mamba2_130m", "qwen3_4b"])
def test_rank_holds_the_sharding_rules_parameter_bytes(cells, arch):
    """A rank's parameter bytes: each leaf's block by
    ``param_shardings`` on the (16, 16) mesh, in its storage dtype."""
    cfg = TC.get(arch)
    mesh = AbstractMesh((16, 16), ("data", "model"))
    specs = param_specs(cfg)
    pspecs = param_shardings(mesh, specs, "tp")
    want = 0
    for name, spec in specs.items():
        n = 1
        for d in local_shape(spec.shape, pspecs[name], mesh):
            n *= d
        want += n * torch.empty((), dtype=spec.dtype).element_size()
    assert cells[0][arch]["param_bytes"] == want


def test_sharded_cells_move_collective_bytes(cells):
    """Qwen3-4B decode splits over "model" (16 ranks across two nodes of 8:
    the network); the BP cell gathers the residuals and passes its fold
    along the whole world (NVLink inside a node, the network across)."""
    recs = cells[0]
    for arch in ("qwen3_4b", "bp_ising_512"):
        c = recs[arch]["coll_breakdown"]
        assert recs[arch]["coll_bytes"] == c["total"] > 0
        assert c["total"] == sum(c[k] for k in RA.KINDS)
        assert c["nvlink"] + c["network"] == pytest.approx(c["total"])
        assert recs[arch]["t_collective"] > 0
    assert recs["qwen3_4b"]["coll_breakdown"]["network"] > 0
    bp = recs["bp_ising_512"]["coll_breakdown"]
    assert bp["all-gather"] > 0 and bp["collective-permute"] > 0


def test_collective_links_and_report():
    """A group inside one node of 8 is charged at NVLink speed, one across
    nodes at the network's; the bottleneck is the largest term."""
    hw = RA.HW()
    assert (hw.peak_flops, hw.hbm_bw, hw.nvlink_bw, hw.net_bw,
            hw.hbm_bytes) == (989e12, 3.35e12, 450e9, 50e9, 80e9)
    stats = {"bytes/all-gather": 300.0, "bytes/all-reduce": 200.0}
    groups = {(0, 1, 2, 3): 100.0, (0, 8): 400.0}
    c = RA.collective_bytes(stats, groups)
    assert (c["all-gather"], c["all-reduce"], c["total"]) == (300, 200, 500)
    assert (c["nvlink"], c["network"]) == (100.0, 400.0)
    r = RA.analyze(flops=989e12, hbm_bytes=3.35e12 / 2, n_devices=4,
                   coll=c, model_flops_global=989e12, argument_bytes=10,
                   output_bytes=2, peak_bytes=81e9)
    assert r.t_compute == 1.0 and r.t_memory == 0.5
    assert r.t_collective == pytest.approx(100 / 450e9 + 400 / 50e9)
    assert r.bottleneck == "compute" and r.useful_ratio == 0.25
    assert r.memory_per_device == {"argument_bytes": 10, "output_bytes": 2,
                                   "peak_bytes": 81_000_000_000,
                                   "peak_ok_80GB": False}


_BANDED = r"""
import json
from repro_torch.dist import partition_banded
from repro_torch.launch import dryrun as DR
from repro_torch.pgm import ising_grid_fast


class Mesh:                      # bp_cell asks a mesh only for its size
    def __init__(self, n):
        self.n = n

    def size(self, dim=None):
        return self.n


g = ising_grid_fast(16, 2.5, seed=0, device="cpu")
DR.fake_world(32)
wide = DR.bp_cell("bp_ising_512_banded", Mesh(32), pgm=g)
n = wide["bp_ranks"]
holds = {}
for m in (n, 2 * n):
    try:
        partition_banded(g, m)
        holds[m] = True
    except AssertionError:
        holds[m] = False
DR.fake_world(n)
direct = DR.bp_cell("bp_ising_512_banded", Mesh(n), pgm=g)
print(json.dumps({"wide": wide, "direct": direct, "holds": holds}))
"""


def test_banded_cell_falls_back_to_the_ranks_its_partition_holds():
    """``ising_grid_fast(16)`` over a fake world of 32 ranks: bands
    balanced by in-degree over 32 ranks are thinner than a row, so an edge
    skips a band. The cell halves the rank count until the partition
    holds, runs on that sub-mesh (the other ranks idle) and records
    ``bp_ranks``; its counts are the cell's counted directly on a world of
    that many ranks."""
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin",
           "OMP_NUM_THREADS": "1"}
    run = subprocess.run([sys.executable, "-c", _BANDED], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    out = json.loads(run.stdout.strip().splitlines()[-1])
    wide, direct, holds = out["wide"], out["direct"], out["holds"]
    n = wide["bp_ranks"]
    assert 1 <= n < 32 and 32 % n == 0
    assert holds == {str(n): True, str(2 * n): False}
    assert direct["bp_ranks"] == n
    for key in ("round", "flops", "hbm_bytes", "coll_bytes",
                "coll_breakdown", "memory_per_device", "t_compute",
                "t_memory", "t_collective", "bottleneck", "useful_ratio"):
        assert wide[key] == direct[key], key
    assert wide["flops"] > 0 and wide["coll_bytes"] > 0
