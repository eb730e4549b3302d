"""What the benchmark may import, by whole top-level module names (the
port's name, ``repro_torch``, begins with the JAX package's, ``repro``)."""

import ast
import subprocess
import sys

import pytest

from perfbench import harness

JAX = {"jax", "jaxlib", "flax", "repro"}
YARDSTICK = ("inputs", "reference")


def imported(path):
    """Top-level names of every module ``path`` imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", "") == "import_module":
            arg = node.args[0]
            if isinstance(arg, ast.Constant):
                names.add(arg.value.split(".")[0])
            elif isinstance(arg, ast.JoinedStr):
                names.add(arg.values[0].value.split(".")[0])
    return names


SOURCES = sorted(p for p in harness.HERE.rglob("*.py")
                 if "__pycache__" not in p.parts)


@pytest.mark.parametrize(
    "path", SOURCES, ids=[str(p.relative_to(harness.HERE)) for p in SOURCES])
def test_no_jax_and_a_yardstick_free_of_the_port(path):
    names = imported(path)
    assert not names & JAX, names & JAX
    if path.relative_to(harness.HERE).parts[0] in YARDSTICK:
        assert "repro_torch" not in names


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """A whole CPU run of a cell, then ``sys.modules`` by top-level name;
    the yardstick's modules alone load nothing of the port."""
    code = (
        "import sys, time; sys.path[:0] = [sys.argv[1], sys.argv[2]]\n"
        "import perfbench.reference.pairwise_bp, perfbench.inputs.stereo\n"
        "import perfbench.inputs.ising_grid, perfbench.roofline\n"
        "top = lambda: {m.split('.')[0] for m in sys.modules}\n"
        "assert 'repro_torch' not in top(), 'yardstick loaded the port'\n"
        "from perfbench import harness, loadgen\n"
        "loadgen.TRACE_S = 0.05\n"
        "harness.run_cell('stereo_tsukuba.batch4', 3, 0.2, True, "
        "t_start=time.perf_counter(), device='cpu', config_override="
        "{'graph': {'height': 6, 'width': 8, 'n_disp': 4}}, traffic_override="
        "{'check_period_s': 0.05})\n"
        "assert 'repro_torch' in top()\n"
        "print(sorted(top() & {'jax', 'jaxlib', 'flax', 'repro'}))\n")
    out = subprocess.run([sys.executable, "-c", code, str(harness.ROOT),
                          str(harness.ROOT / "src")], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "[]"
