"""``chip_smoke.py`` rehearsed on the CPU at tiny sizes.

The script's phases take their device and sizes as arguments, so their
control flow, checks and report fields run here with the kernel's plain
version. A counting shim stands in for the kernel launch count (CPU tensors
launch nothing). Without a GPU, ``main`` exits non-zero and prints no
result.
"""

import pathlib
import sys

import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import triton_update as TT
from repro_torch.pgm import protein_like_graph

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402  (the script lives at the repo root)

CPU = torch.device("cpu")


@pytest.fixture
def counted(monkeypatch):
    """Count calls of the kernel wrapper on the engine's path as launches."""
    real = ops.fused_update_e

    def counting(*args, semiring="sum"):
        TT.LAUNCHES[semiring] += 1
        return real(*args, semiring=semiring)

    monkeypatch.setattr(ops, "fused_update_e", counting)
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
    worst = cs.phase_kernels(CPU, states=(2, 9), edges=(1, 50),
                             table_bytes=1 << 20)
    assert worst == {"sum": 0.0, "max": 0.0}


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
                           "protein/max", "round_parts_ms"}
    trace = cs.phase_trace(pgm, CPU, warm=4, rounds=4)
    assert trace["kernels_per_round"] == 0 and trace["wall_ms_per_round"] > 0
