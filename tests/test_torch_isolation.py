"""The port stands alone, and its entry points default to the GPU.

A fresh interpreter imports every module of ``repro_torch`` and imports
``chip_smoke`` (without running it); neither JAX nor the reference package
``repro`` may then be loaded. Graph builders and ``BPEngine`` called
without ``device=`` must raise when there is no GPU rather than carry on
on the CPU.
"""

import json
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch.core import BPConfig, BPEngine, build_pgm, build_pgm_uniform
from repro_torch.pgm import datasets as TD

REPO = pathlib.Path(__file__).resolve().parent.parent

_PROBE = r"""
import importlib, json, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = sorted(m for m in sys.modules
                if m == "jax" or m.startswith("jax.") or m == "jaxlib"
                or m.startswith("jaxlib.") or m == "repro"
                or m.startswith("repro."))
print(json.dumps({"modules": names, "leaked": leaked,
                  "main": hasattr(chip_smoke, "main")}))
"""


def test_port_and_chip_smoke_import_no_jax_and_no_reference():
    env = {"PYTHONPATH": f"{REPO / 'src'}:{REPO}", "JAX_PLATFORMS": "cpu",
           "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["leaked"] == []
    assert report["main"]
    for mod in ("repro_torch.core.engine", "repro_torch.core.messages",
                "repro_torch.kernels.triton_update", "repro_torch.kernels._build",
                "repro_torch.core.schedulers.rnbp", "repro_torch.pgm.datasets"):
        assert mod in report["modules"]


def test_port_sources_never_name_jax_or_reference():
    """A static guard beside the runtime probe: no import of jax or repro
    in any source file of the port or in chip_smoke.py."""
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    for path in files:
        for line in path.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                mod = s.split()[1]
                assert mod.split(".")[0] not in ("jax", "jaxlib", "repro"), \
                    f"{path.name}: {s}"


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("make", [
    lambda: TD.ising_grid(3, 2.0),
    lambda: TD.ising_grid_fast(3, 2.0),
    lambda: TD.small_ising(3),
    lambda: TD.chain_graph(5),
    lambda: TD.protein_like_graph(10),
    lambda: build_pgm(2, [[0, 1]], [[1.0, 2.0], [1.0, 1.0]],
                      [[[1.0, 2.0], [2.0, 1.0]]]),
    lambda: build_pgm_uniform(2, [[0, 1]], torch.ones(2, 2).numpy(),
                              torch.ones(1, 2, 2).numpy()),
    lambda: BPEngine(BPConfig()),
    lambda: BPEngine(),
], ids=["ising_grid", "ising_grid_fast", "small_ising", "chain_graph",
        "protein_like_graph", "build_pgm", "build_pgm_uniform", "engine",
        "engine_default_config"])
def test_entry_points_default_to_cuda_and_refuse_without_gpu(no_gpu, make):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()


def test_cpu_is_explicit(no_gpu):
    pgm = TD.ising_grid(3, 2.0, device="cpu")
    res = BPEngine(BPConfig(), device="cpu").run(pgm, torch.Generator())
    assert res.beliefs.device.type == "cpu" and bool(res.converged)
