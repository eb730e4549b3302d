"""The port stands alone, and its entry points default to the GPU.

A fresh interpreter imports every module of ``repro_torch`` and imports
``chip_smoke`` (without running it); neither JAX nor the reference package
``repro`` may then be loaded. Graph builders, ``BPEngine``, the router tier,
``run_bp_resilient`` and the multi-device entry points (``make_bp_mesh``,
``run_bp_sharded``, ``ElasticMesh``), the LM stack's ``build_model`` and
``Model``, its training entry points (``make_train_step``'s model,
``init_train_state``, ``SyntheticLM``), the training launcher (on one
device, and with ``--model-parallel 2 --sharding fsdp``),
``make_production_mesh`` and ``build_model`` on a mesh (either mode),
and the example drivers (``repro_torch.examples.*``: quickstart,
stereo_bp, ldpc_decode, bp_serving, distributed_bp, train_lm) called
without ``device=`` / ``--device cpu`` must raise when there is no GPU
rather than carry on on the CPU; sharded training asked for on the CPU
stays there.
"""

import json
import pathlib
import subprocess
import sys

import pytest
import torch
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

from repro_torch import configs as TC
from repro_torch.configs.base import TRAIN_4K
from repro_torch.core import BPConfig, BPEngine, build_pgm, build_pgm_uniform
from repro_torch.data import SyntheticLM
from repro_torch.dist import make_bp_mesh, run_bp_sharded
from repro_torch.examples import (bp_serving, distributed_bp, ldpc_decode,
                                  quickstart, stereo_bp, train_lm)
from repro_torch.ft import ElasticMesh, run_bp_resilient
from repro_torch.models import Model, build_model
from repro_torch.pgm import datasets as TD
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.serve import Router, serve_routed
from repro_torch.train import make_train_step
from repro_torch.train.step import init_train_state

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
                "repro_torch.core.schedulers.rnbp", "repro_torch.pgm.datasets",
                "repro_torch.core.batch", "repro_torch.kernels.message_update",
                "repro_torch.kernels.ops", "repro_torch.core.serving",
                "repro_torch.core.schedulers.rlx",
                "repro_torch.core.schedulers.rlxtree",
                "repro_torch.serve", "repro_torch.serve.routing",
                "repro_torch.serve.replica", "repro_torch.serve.router",
                "repro_torch.core.exact", "repro_torch.core.serial",
                "repro_torch.core.runner", "repro_torch.checkpoint",
                "repro_torch.checkpoint.ckpt", "repro_torch.ft",
                "repro_torch.ft.resilience", "repro_torch.dist",
                "repro_torch.dist.bp_banded", "repro_torch.dist.comm",
                "repro_torch.roofline", "repro_torch.roofline.kernel_model",
                "repro_torch.configs", "repro_torch.configs.base",
                "repro_torch.configs.qwen3_4b", "repro_torch.models",
                "repro_torch.models.model", "repro_torch.models.blocks",
                "repro_torch.models.convert", "repro_torch.models.layers",
                "repro_torch.models.layers.basic",
                "repro_torch.models.layers.mlp",
                "repro_torch.models.layers.attention",
                "repro_torch.models.layers.ssm",
                "repro_torch.models.layers.moe",
                "repro_torch.models.layers.mla", "repro_torch.launch",
                "repro_torch.launch.serve", "repro_torch.launch.train",
                "repro_torch.train", "repro_torch.train.optimizer",
                "repro_torch.train.step", "repro_torch.data",
                "repro_torch.data.pipeline",
                "repro_torch.roofline.analysis", "repro_torch.launch.mesh",
                "repro_torch.launch.sharding",
                "repro_torch.models.layers.parallel",
                "repro_torch.roofline.op_cost", "repro_torch.launch.dryrun",
                "repro_torch.kernels._dispatch", "repro_torch.examples",
                "repro_torch.examples.quickstart",
                "repro_torch.examples.stereo_bp",
                "repro_torch.examples.ldpc_decode",
                "repro_torch.examples.bp_serving",
                "repro_torch.examples.distributed_bp",
                "repro_torch.examples.train_lm", "repro_torch.experiments",
                "repro_torch.experiments.render_roofline"):
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
    lambda: TD.loop_graph(8),
    lambda: TD.ldpc_graph(0, n=12, dv=2, dc=4),
    lambda: TD.stereo_mrf(3, 4, 2),
    lambda: next(TD.zoo_stream(1)),
    lambda: BPEngine(BPConfig(backend="pallas", batch_backend="pallas")),
    lambda: Router(BPConfig(), 0),
    lambda: serve_routed(BPConfig(), [], 0, replicas=2),
    lambda: run_bp_resilient(TD.ising_grid(3, 2.0, device="cpu"), "lbp",
                             torch.Generator()),
    lambda: make_bp_mesh(),
    lambda: run_bp_sharded(TD.ising_grid(3, 2.0, device="cpu"), "lbp", None,
                           torch.Generator()),
    lambda: ElasticMesh().current(),
    lambda: build_model(TC.get("qwen3_4b").reduced()),
    lambda: Model(TC.get("mamba2_130m").reduced()),
    lambda: make_train_step(build_model(TC.get("qwen3_4b").reduced())),
    lambda: init_train_state(build_model(TC.get("qwen3_4b").reduced()),
                             torch.Generator()),
    lambda: SyntheticLM(TC.get("qwen3_4b").reduced(), TRAIN_4K),
    lambda: launch_train.main(["--arch", "qwen3_4b", "--reduced",
                               "--steps", "1"]),
    lambda: make_production_mesh(),
    lambda: build_model(TC.get("qwen3_4b").reduced(), mesh=object()),
    lambda: build_model(TC.get("mamba2_130m").reduced(), mesh=object(),
                        mode="fsdp"),
    lambda: launch_train.main(["--arch", "qwen3_4b", "--reduced",
                               "--steps", "1", "--model-parallel", "2",
                               "--sharding", "fsdp"]),
    lambda: quickstart.main([]),
    lambda: stereo_bp.main([]),
    lambda: ldpc_decode.main(["--words", "1"]),
    lambda: bp_serving.main(["--requests", "1"]),
    lambda: distributed_bp.main(["--size", "4"]),
    lambda: train_lm.main(["--steps", "1"]),
], ids=["ising_grid", "ising_grid_fast", "small_ising", "chain_graph",
        "protein_like_graph", "build_pgm", "build_pgm_uniform", "engine",
        "engine_default_config", "loop_graph", "ldpc_graph", "stereo_mrf",
        "zoo_stream", "engine_batched", "router", "serve_routed",
        "run_bp_resilient", "make_bp_mesh", "run_bp_sharded",
        "elastic_mesh", "build_model", "model", "make_train_step",
        "init_train_state", "synthetic_lm", "launch_train",
        "make_production_mesh", "build_model_on_a_mesh",
        "build_model_fsdp_on_a_mesh", "launch_train_sharded",
        "example_quickstart", "example_stereo_bp", "example_ldpc_decode",
        "example_bp_serving", "example_distributed_bp", "example_train_lm"])
def test_entry_points_default_to_cuda_and_refuse_without_gpu(no_gpu, make):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()


def test_cpu_is_explicit(no_gpu):
    pgm = TD.ising_grid(3, 2.0, device="cpu")
    res = BPEngine(BPConfig(), device="cpu").run(pgm, torch.Generator())
    assert res.beliefs.device.type == "cpu" and bool(res.converged)


def test_lm_model_on_cpu_stays_on_cpu(no_gpu):
    model = build_model(TC.get("qwen3_4b").reduced(), device="cpu")
    model.init_params(torch.Generator())
    assert all(p.device.type == "cpu" for p in model.parameters())
    cache = model.init_cache(1, 4)
    logits, cache = model.decode_step(
        cache, torch.zeros((1, 1), dtype=torch.long), 0)
    assert logits.device.type == "cpu"
    assert all(t.device.type == "cpu" for t in cache["main"].values())


def test_bucket_on_cpu_stays_on_cpu(no_gpu):
    pgms = [TD.ising_grid(3, 2.0, device="cpu"), TD.chain_graph(9,
                                                                 device="cpu")]
    res = BPEngine(BPConfig(batch_backend="pallas"), device="cpu").run_many(
        pgms, 0)
    assert all(r.beliefs.device.type == "cpu" and bool(r.converged)
               for r in res)


def test_lm_training_on_cpu_stays_on_cpu(no_gpu):
    import dataclasses
    cfg = TC.get("qwen3_4b").reduced()
    model = build_model(cfg, device="cpu")
    state = init_train_state(model, torch.Generator())
    pipe = SyntheticLM(cfg, dataclasses.replace(TRAIN_4K, seq_len=8,
                                                global_batch=2),
                       device="cpu")
    state, metrics = make_train_step(model)(state, pipe.batch(0))
    assert all(t.device.type == "cpu" for t in metrics.values())
    assert all(p.device.type == "cpu" for p in state.params.values())
    assert state.step.device.type == "cpu"


def test_lm_sharded_training_on_cpu_stays_on_cpu(no_gpu):
    """A ZeRO-3 train step and checkpoint gather on a world of one on the
    CPU: every tensor stays there."""
    import dataclasses
    from repro_torch.launch.sharding import train_state_shardings
    from repro_torch.train.step import (reference_shardings, reference_tree,
                                        train_state_specs)
    from repro_torch.checkpoint import save_pytree
    import tempfile
    cfg = TC.get("granite_moe_3b_a800m").reduced()
    cpu = torch.device("cpu")
    with launch_train.world_of_one(cpu), tempfile.TemporaryDirectory() as d:
        mesh = ElasticMesh(2, device="cpu").current()
        model = build_model(cfg, device="cpu", mesh=mesh, mode="fsdp")
        state = init_train_state(model, torch.Generator())
        pipe = SyntheticLM(cfg, dataclasses.replace(TRAIN_4K, seq_len=8,
                                                    global_batch=2),
                           device="cpu")
        state, metrics = make_train_step(model)(state, pipe.batch(0))
        specs = reference_shardings(train_state_shardings(
            mesh, train_state_specs(model), "fsdp"))
        save_pytree(d, 1, reference_tree(state), sharding_tree=specs,
                    mesh=mesh)
    assert all(t.device.type == "cpu" for t in metrics.values())
    assert all(p.device.type == "cpu" for p in state.params.values())
