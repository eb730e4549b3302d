"""The port's sharding rules (``repro_torch.launch.sharding``, ``mesh``)
held against the reference's own functions, spec for spec.

- Every parameter leaf of all ten ``ARCH_IDS`` at their published widths
  (``param_specs``: shapes only, nothing allocated), at "model" sizes 1, 2,
  4, 8 and 16 on two data widths, in both modes: the port's spec of a
  per-layer leaf equals the reference's spec of the stacked leaf without
  its leading ``None``, and an unstacked leaf's spec equals it whole.
- ``cache_shardings`` of every family's decode cache and
  ``batch_shardings`` of its batch, B = 1 (replicated) included, and
  ``_fsdp_pspec``'s rule that leaves under 2**20 elements replicate.
- Every case of ``tests/test_sharding.py``, ported.
- Placement: ``shard_tensor``'s blocks put back by ``unshard`` give the
  input bitwise, for every coordinate of meshes with and without a pod
  axis, tuple axes included (``gather_tensor`` over real process groups
  runs in ``tests/test_torch_lm_sharded.py``).

The reference's rules run on ``jax.sharding.AbstractMesh`` (sizes and
names, no devices), the port's on its ``AbstractMesh`` twin.
"""

import functools
import itertools

import jax
import jax.numpy as jnp
import pytest
import torch
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)
from jax.sharding import AbstractMesh as JMesh

from repro import configs as RC
from repro.launch import mesh as RMESH
from repro.launch import sharding as RS
from repro.models import build_model as ref_build
from repro_torch import configs as TC
from repro_torch.launch import mesh as TMESH
from repro_torch.launch import sharding as TS
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.launch.sharding import P
from repro_torch.models import build_model, param_specs
from repro_torch.models.model import STACKS

MPS = (1, 2, 4, 8, 16)
DPS = (1, 16)
NAMES = ("data", "model")


def both(shape, names=NAMES):
    return JMesh(tuple(shape), tuple(names)), AbstractMesh(shape, names)


def as_p(spec) -> tuple:
    """A reference ``PartitionSpec`` as the tuple the port's ``P`` is."""
    return tuple(spec)


def ref_name(name: str) -> str:
    """The reference's tree path of a port parameter name: the layer
    index of a block stack dropped."""
    parts = name.split(".")
    if parts[0] in STACKS:
        del parts[1]
    return ".".join(parts)


def flat(tree, prefix=""):
    out = {}
    for key, sub in tree.items():
        if isinstance(sub, dict):
            out.update(flat(sub, f"{prefix}{key}."))
        else:
            out[prefix + key] = sub
    return out


@functools.lru_cache(maxsize=None)
def ref_specs(arch):
    return ref_build(RC.get(arch)).param_specs()


# ------------------------------------------------------------- the rules --

@pytest.mark.parametrize("mode", ["tp", "fsdp"])
@pytest.mark.parametrize("mp", MPS)
@pytest.mark.parametrize("arch", RC.ARCH_IDS)
def test_param_specs_equal_the_reference_at_published_widths(arch, mp,
                                                             mode):
    cfg = TC.get(arch)
    specs = param_specs(cfg)
    ref = flat(ref_specs(arch))
    # every port leaf has the reference leaf's shape (less the stack axis)
    for name, spec in specs.items():
        r = ref[ref_name(name)]
        stacked = name.split(".")[0] in STACKS
        assert spec.shape == (r.shape[1:] if stacked else r.shape), name
    assert {ref_name(n) for n in specs} == set(ref)
    for dp in DPS:
        jmesh, mesh = both((dp, mp))
        want = flat(RS.param_shardings(jmesh, ref_specs(arch), mode))
        got = TS.param_shardings(mesh, specs, mode)
        assert got.keys() == specs.keys()
        for name, spec in got.items():
            w = as_p(want[ref_name(name)].spec)
            stacked = name.split(".")[0] in STACKS
            assert isinstance(spec, P)
            assert spec == (w[1:] if stacked else w), (name, dp, mp)


@pytest.mark.parametrize("mp", MPS)
@pytest.mark.parametrize("arch", RC.ARCH_IDS)
def test_cache_specs_equal_the_reference(arch, mp):
    model = build_model(TC.get(arch), device="meta")
    rmodel = ref_build(RC.get(arch))
    for b, s in ((128, 32768), (1, 1000), (16, 4096)):
        for dp in DPS:
            jmesh, mesh = both((dp, mp))
            want = RS.cache_shardings(jmesh, rmodel.init_cache_specs(b, s))
            got = TS.cache_shardings(mesh, model.init_cache_specs(b, s))
            assert got.keys() == want.keys()
            for group in want:
                assert got[group].keys() == want[group].keys()
                for name, sh in want[group].items():
                    assert got[group][name] == as_p(sh.spec), (group, name)


BATCH_MESHES = [((1, 1), NAMES), ((2, 1), NAMES), ((16, 16), NAMES),
                ((4, 2), NAMES), ((2, 16, 16), ("pod", "data", "model")),
                ((2, 2, 4), ("pod", "data", "model"))]


@pytest.mark.parametrize("mode", ["tp", "fsdp"])
@pytest.mark.parametrize("shape,names", BATCH_MESHES)
def test_batch_specs_equal_the_reference(shape, names, mode):
    jmesh, mesh = both(shape, names)
    for b in (1, 2, 8, 16, 32, 256, 512):
        batch = {"tokens": (b, 64), "labels": (b, 64),
                 "frontend_embeds": (b, 16, 32), "pos": ()}
        want = RS.batch_shardings(jmesh, {k: jax.ShapeDtypeStruct(
            v, jnp.float32) for k, v in batch.items()}, mode)
        got = TS.batch_shardings(mesh, batch, mode)
        assert {k: as_p(v.spec) for k, v in want.items()} == got, b


def test_fsdp_small_leaves_replicate_as_the_reference():
    class Entry:
        def __init__(self, key):
            self.key = key
    axes = ("data", "model")
    for name, shape in (("w_in", (1023, 1024)), ("w_in", (1024, 1024)),
                        ("table", (4096, 256)), ("table", (4095, 256)),
                        ("ln1", (4096,)), ("w_out", (8, 512, 256)),
                        ("wq", (3, 1 << 20))):
        for size in (1, 2, 16, 256):
            for stacked in (False, True):
                full = ((4,) + shape) if stacked else shape
                want = RS._fsdp_pspec((Entry(name),), jax.ShapeDtypeStruct(
                    full, jnp.float32), axes, size, stacked)
                assert TS._fsdp_pspec(name, full, axes, size, stacked) == \
                    as_p(want), (name, shape, size, stacked)
    assert TS._fsdp_pspec("w_in", (1023, 1024), axes, 2) == P(None, None)
    assert TS._fsdp_pspec("w_in", (1024, 1024), axes, 2) == P(None, axes)


@pytest.mark.parametrize("shape,names", BATCH_MESHES)
def test_mesh_queries_equal_the_reference(shape, names):
    jmesh, mesh = both(shape, names)
    assert TMESH.data_axes(mesh) == RMESH.data_axes(jmesh)
    assert TMESH.data_size(mesh) == RMESH.data_size(jmesh)
    assert TMESH.model_size(mesh) == RMESH.model_size(jmesh)
    assert TMESH.axis_sizes(mesh) == dict(jmesh.shape)


def test_train_state_and_replicated_specs():
    from repro_torch.train.step import train_state_specs
    cfg = TC.get("qwen3_4b").reduced()
    model = build_model(cfg, device="meta")
    mesh = AbstractMesh((2, 4), NAMES)
    state = TS.train_state_shardings(mesh, train_state_specs(model))
    params = TS.param_shardings(mesh, param_specs(cfg))
    assert state.params == params == state.opt.mu == state.opt.nu
    assert state.step == state.opt.count == P()
    assert TS.replicated(mesh, {"a": 1, "b": {"c": 2}}) == \
        {"a": P(), "b": {"c": P()}}


# ----------------------------------------- tests/test_sharding.py, ported --

def spec_of(name, shape, mp=16, stacked=False):
    return TS._param_pspec(name, shape, mp, stacked)


class TestParamRules:
    def test_column_parallel(self):
        assert spec_of("wq", (4096, 2048)) == P(None, "model")

    def test_row_parallel(self):
        assert spec_of("wo", (2048, 4096)) == P("model", None)

    def test_divisibility_fallback(self):
        assert spec_of("wq", (128, 75)) == P(None, None)

    def test_embedding_vocab_sharded(self):
        assert spec_of("table", (152064, 2560)) == P("model", None)

    def test_moe_expert_ff_sharded(self):
        assert spec_of("w_in", (40, 1536, 512)) == P(None, None, "model")
        assert spec_of("w_out", (40, 512, 1536)) == P(None, "model", None)

    def test_stacked_leading_layer_axis(self):
        assert spec_of("wq", (36, 2560, 4096), stacked=True) == \
            P(None, None, "model")
        # the port's per-layer leaf: the same spec without the layer axis
        assert spec_of("blocks.3.attn.wq", (2560, 4096)) == P(None, "model")

    def test_norms_replicated(self):
        assert spec_of("ln1", (2560,)) == P(None)


class TestTreeShardings:
    @pytest.mark.parametrize("arch", ["qwen3_4b", "granite_moe_3b_a800m",
                                      "mamba2_130m", "whisper_medium"])
    def test_param_shardings_cover_tree(self, arch):
        specs = param_specs(TC.get(arch))
        sh = TS.param_shardings(AbstractMesh((1, 1), NAMES), specs)
        assert sh.keys() == specs.keys()

    def test_cache_seq_sharded_on_model(self):
        model = build_model(TC.get("qwen3_4b"), device="meta")
        sh = TS.cache_shardings(AbstractMesh((1, 1), NAMES),
                                model.init_cache_specs(128, 32768))
        assert sh["main"]["k"][2] == "model"

    def test_batch_replicates_when_indivisible(self):
        sh = TS.batch_shardings(AbstractMesh((2, 1), NAMES),
                                {"tokens": (1, 1)})
        assert sh["tokens"] == P(None, None)


# ------------------------------------------------------------- placement --

PLACEMENTS = [
    ((2, 4), NAMES, P(None, "model"), (3, 8)),
    ((2, 4), NAMES, P("data", None, "model"), (4, 5, 8)),
    ((2, 4), NAMES, P(("data", "model"), None), (16, 3)),
    ((2, 4), NAMES, P(None, ("model", "data")), (2, 16)),
    ((2, 2, 4), ("pod", "data", "model"), P(("pod", "data"), "model"),
     (8, 12)),
    ((2, 2, 4), ("pod", "data", "model"), P(None, ("pod", "data", "model")),
     (1, 32)),
    ((3, 1), NAMES, P(), (5, 7)),
    ((1, 1), NAMES, P("data", "model"), (2, 2)),
]


@pytest.mark.parametrize("shape,names,spec,tshape", PLACEMENTS)
def test_shard_then_unshard_is_bitwise(shape, names, spec, tshape):
    mesh = AbstractMesh(shape, names)
    t = torch.randn(tshape, generator=torch.Generator().manual_seed(0))
    coords = list(itertools.product(*(range(n) for n in shape)))
    blocks = {c: TS.shard_tensor(t, spec, mesh, coordinate=c)
              for c in coords}
    for c, block in blocks.items():
        assert tuple(block.shape) == TS.local_shape(tshape, spec, mesh)
        assert block.is_contiguous()
    assert torch.equal(TS.unshard(blocks, spec, mesh), t)


def test_block_layout_is_named_shardings():
    """The rank at mesh coordinate c holds what ``NamedSharding``'s
    ``devices_indices_map`` gives the device at c, on a 4-device CPU mesh
    (a tuple of axes row-major)."""
    import json
    import subprocess
    import sys
    script = r"""
import json, os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as JP
mesh = jax.make_mesh((2, 4), ("data", "model"))
out = []
for spec in (JP(None, "model"), JP(("data", "model"), None),
             JP(None, ("model", "data")), JP("data", "model")):
    idx = NamedSharding(mesh, spec).devices_indices_map((16, 16))
    rows = []
    for c in np.ndindex(2, 4):
        d = mesh.devices[c]
        rows.append([list(c), [[s.start or 0, s.stop or 16] for s in idx[d]]])
    out.append(rows)
print(json.dumps(out))
"""
    res = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=120,
                         env={"JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin"})
    assert res.returncode == 0, res.stderr
    want = json.loads(res.stdout.strip().splitlines()[-1])
    mesh = AbstractMesh((2, 4), NAMES)
    t = torch.arange(256).reshape(16, 16)
    for spec, rows in zip((P(None, "model"), P(("data", "model"), None),
                           P(None, ("model", "data")), P("data", "model")),
                          want):
        for c, bounds in rows:
            got = TS.shard_tensor(t, spec, mesh, coordinate=c)
            (r0, r1), (c0, c1) = bounds
            assert torch.equal(got, t[r0:r1, c0:c1]), (spec, c)


def test_placement_refuses_an_indivisible_split():
    mesh = AbstractMesh((1, 4), NAMES)
    with pytest.raises(ValueError, match="split 4 ways"):
        TS.local_shape((6, 8), P("model", None), mesh)
    with pytest.raises(ValueError, match="more entries"):
        TS.shard_tensor(torch.zeros(4), P(None, "model"), mesh,
                        coordinate=(0, 0))
