"""The port's op-level counter (``repro_torch.roofline.op_cost``), the
kernels' dispatcher ops and ``kernel_model.round_cost``, held against the
reference's jaxpr walker (``repro.roofline.jaxpr_cost``) on the same
programs.

- The programs of ``tests/test_roofline.py::TestJaxprCounter``: a matmul
  (flops and bytes exact), a batched einsum (flops exact), L layers in a
  loop (2 %), a train step with per-layer checkpointing (4 dots a layer,
  5 %).
- Each fused op charged by the fused-kernel contract: bytes equal to
  ``fused_update_cost`` and to the reference's interpret-mode trace, flops
  equal to the model, on the pre-aligned shapes of
  ``TestKernelCostModel``.
- ``round_cost`` of ``lbp``, ``rbp``, ``rnbp`` on ``ising_grid(8, 2.0)``:
  at least the kernel, under 6x its bytes (the reference's pin), and
  within ``ROUND_RATIO`` of the reference's ``round_cost``.
- The ten families at ``reduced()``, one device: prefill, decode and train
  dot flops against the reference's ``dot_general`` flops, exact where
  both sides run the same products, the difference pinned where they do
  not (``dot_pin``); the total flops, less that difference, within
  ``TOTAL_TOL``. Bytes are not compared there: jax's transposes,
  broadcasts and multi-operand einsums move bytes that torch's views and
  elementwise products do not (``op_cost``'s docstring).
"""

import importlib

import jax
import jax.numpy as jnp
import pytest
import torch
from torch.utils.checkpoint import checkpoint
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

from repro import configs as RC
from repro.configs.base import InputShape as RShape
from repro.core import messages as JM
from repro.core.schedulers import get_scheduler as j_get_scheduler
from repro.data.pipeline import make_batch_specs as r_batch_specs
from repro.kernels import ops as JO
from repro.models import build_model as r_build
from repro.models.layers import ssm as RS
from repro.pgm import datasets as JD
from repro.roofline import kernel_model as JK
from repro.train.step import make_train_step as r_train_step
from repro.train.step import train_state_specs as r_state_specs
from repro_torch import configs as TC
from repro_torch.configs.base import InputShape as TShape
from repro_torch.core.graph import PGM
from repro_torch.core.schedulers import get_scheduler
from repro_torch.data import make_batch_specs as t_batch_specs
from repro_torch.kernels import message_update as MU
from repro_torch.kernels import ops as TO
from repro_torch.kernels import triton_update as TT
from repro_torch.models import build_model
from repro_torch.models.layers import ssm as TS
from repro_torch.roofline import kernel_model as TK
from repro_torch.roofline.op_cost import (Cost, OpCounter, charge,
                                          op_cost, trace_cost)
from repro_torch.train.step import init_train_state, make_train_step

JC = importlib.import_module("repro.roofline.jaxpr_cost")
F32 = torch.float32


def j_spec(shape, dtype=jnp.float32):
    return jax.ShapeDtypeStruct(shape, dtype)


def j_dots(jaxpr) -> float:
    """The reference walker's ``dot_general`` flops alone, through scans
    (times their length) and every jaxpr-carrying primitive."""
    total = 0.0
    for eqn in jaxpr.eqns:
        prim = eqn.primitive.name
        if prim == "dot_general":
            total += JC._dot_cost(eqn).flops
        elif prim == "scan":
            total += j_dots(eqn.params["jaxpr"].jaxpr) * eqn.params["length"]
        else:
            inner = (eqn.params.get("jaxpr") or eqn.params.get("call_jaxpr")
                     or eqn.params.get("fun_jaxpr"))
            if inner is not None:
                total += j_dots(getattr(inner, "jaxpr", inner))
    return total


# --------------------------------------------- TestJaxprCounter's programs --

def test_plain_matmul_is_the_reference_exactly():
    m, k, n = 64, 128, 256
    ref = JC.trace_cost(lambda a, b: a @ b, j_spec((m, k)), j_spec((k, n)))
    got = trace_cost(lambda a, b: a @ b, ((m, k), F32), ((k, n), F32))
    assert (got.flops, got.bytes) == (ref.flops, ref.bytes) == \
        (2 * m * k * n, 4 * (m * k + k * n + m * n))


def test_batched_einsum_flops_are_the_reference_exactly():
    ref = JC.trace_cost(lambda x, w: jnp.einsum("bik,bkj->bij", x, w),
                        j_spec((8, 16, 32)), j_spec((8, 32, 64)))
    got = trace_cost(lambda x, w: torch.einsum("bik,bkj->bij", x, w),
                     ((8, 16, 32), F32), ((8, 32, 64), F32))
    assert got.flops == ref.flops == 2 * 8 * 16 * 32 * 64


def test_layers_in_a_loop_count_each_layer():
    """A Python loop over layers against the reference's ``scan``: each
    layer counted as it runs, within 2 %."""
    m, k, L = 64, 128, 7

    def j_f(ws, x):
        return jax.lax.scan(lambda h, w: (jnp.tanh(h @ w), None), x, ws)[0]

    def t_f(ws, x):
        for w in ws:
            x = torch.tanh(x @ w)
        return x
    ref = JC.trace_cost(j_f, j_spec((L, k, k)), j_spec((m, k)))
    got = trace_cost(t_f, ((L, k, k), F32), ((m, k), F32))
    dot = 2 * m * k * k
    assert abs(got.flops - L * (dot + m * k)) / (L * dot) < 0.02
    assert abs(got.flops - ref.flops) / ref.flops < 0.02


def test_train_step_counts_forward_recompute_and_backward():
    """fwd + recomputed fwd + dW + dh = 4 dots a layer, as the reference
    counts its remat'd scan, within 5 %."""
    m, k, L = 64, 128, 4

    def j_loss(ws, x):
        def body(h, w):
            return jax.checkpoint(lambda h, w: jnp.tanh(h @ w))(h, w), None
        return jnp.sum(jax.lax.scan(body, x, ws)[0] ** 2)

    def j_step(ws, x):
        _, g = jax.value_and_grad(j_loss)(ws, x)
        return jax.tree.map(lambda a, b: a - b, ws, g)

    def t_step(ws, x):
        # the reference's scan body takes dh in every layer, the first
        # included: so x requires grad too
        ws = ws.detach().requires_grad_(True)
        h = x.detach().requires_grad_(True)
        for w in ws.unbind(0):
            h = checkpoint(lambda h, w: torch.tanh(h @ w), h, w,
                           use_reentrant=False)
        (h ** 2).sum().backward()
        with torch.no_grad():
            return ws - ws.grad

    expected = L * 4 * 2 * m * k * k
    ref = JC.trace_cost(j_step, j_spec((L, k, k)), j_spec((m, k)))
    got = op_cost(t_step, torch.zeros(L, k, k), torch.zeros(m, k))
    assert abs(got.flops - expected) / expected < 0.05
    assert abs(ref.flops - expected) / expected < 0.05


def test_live_bytes_follow_storages():
    with OpCounter(live=True) as c:
        a = torch.zeros(1000)           # 4,000 B
        b = a + 1                       # 8,000 held
        del a                           # 4,000
        c2 = b.view(10, 100) * 2        # 8,000
        del b, c2
    assert c.live.peak == 8000 and c.live.now == 0
    assert c.calls["aten.zeros"] == 1 and c.by_class["view"] == Cost()


# --------------------------------------------------------- the fused ops --

def _operands(e, s):
    return (((e, s, s), F32), ((e, s), F32), ((e, s), F32),
            ((e, s), torch.int8))


@pytest.mark.parametrize("s,e", [(2, 1024), (4, 1024), (8, 512)])
@pytest.mark.parametrize("semiring", ["sum", "max"])
def test_fused_op_charged_by_the_kernel_contract(s, e, semiring):
    """``repro_torch::fused_update_e`` counted as one fused call: bytes are
    the model's, exactly, and so are the reference's interpret-mode trace
    bytes; flops are the model's."""
    from repro.kernels.triton_update import fused_update_e as j_fused
    model = TK.fused_update_cost(e, s, semiring=semiring)
    got = trace_cost(lambda *o: TT.fused_update_e(*o, semiring=semiring),
                     *_operands(e, s))
    ref = JC.trace_cost(lambda *o: j_fused(*o, semiring=semiring,
                                           interpret=True),
                        j_spec((e, s, s)), j_spec((e, s)), j_spec((e, s)),
                        j_spec((e, s), jnp.bool_))
    assert got.bytes == model.bytes == ref.bytes
    assert got.flops == model.flops
    ops = [torch.zeros(sh, dtype=dt) for sh, dt in _operands(e, s)]
    with OpCounter() as c:
        TT.fused_update_e(*ops, semiring=semiring)
    assert c.cost == model and c.calls == {"repro_torch.fused_update_e": 1}


@pytest.mark.parametrize("s,e", [(4, 1024), (8, 512)])
def test_transposed_fused_op_charged_by_the_kernel_contract(s, e):
    from repro.kernels.message_update import fused_update_t as j_fused_t
    model = TK.fused_update_cost(e, s)
    ops = (((s, s, e), F32), ((s, e), F32), ((s, e), F32),
           ((s, e), torch.int8))
    got = trace_cost(MU.fused_update_t, *ops)
    ref = JC.trace_cost(lambda *o: j_fused_t(*o, interpret=True),
                        j_spec((s, s, e)), j_spec((s, e)), j_spec((s, e)),
                        j_spec((s, e), jnp.bool_))
    assert got.bytes == model.bytes == ref.bytes
    assert got.flops == model.flops
    # the CUDA tensors of the card, faked: no kernel is built or launched
    before = dict(MU.LAUNCHES)
    assert trace_cost(MU.fused_update_t, *ops, device="cuda") == got
    assert MU.LAUNCHES == before and MU._lib is None


def test_dispatcher_ops_keep_the_plain_values_and_count_no_launch():
    """On CPU tensors each op runs the kernel's plain version (bitwise the
    direct call) and counts no launch."""
    from repro_torch.kernels.ref import fused_update_e_ref, fused_update_t_ref
    g = torch.Generator().manual_seed(0)
    e, s = 64, 5
    ops = (torch.randn(e, s, s, generator=g), torch.randn(e, s, generator=g),
           torch.randn(e, s, generator=g),
           (torch.rand(e, s, generator=g) > 0.2).to(torch.int8))
    before = (dict(TT.LAUNCHES), dict(MU.LAUNCHES))
    for semiring in ("sum", "max"):
        got = torch.ops.repro_torch.fused_update_e(*ops, semiring)
        want = fused_update_e_ref(*ops, semiring)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    t_ops = (ops[0].permute(1, 2, 0).contiguous(),
             *(t.t().contiguous() for t in ops[1:]))
    got = MU.fused_update_t(*t_ops)
    want = fused_update_t_ref(*t_ops)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (TT.LAUNCHES, MU.LAUNCHES) == before


# ------------------------------------------------------------ round_cost --

#: the port's round bytes over the reference's, per scheduler, at
#: ising_grid(8, 2.0), the port's edge-prelude kernel charged as the
#: reference charges its plain prelude: at most this far apart either way.
#: Measured: 0.926-0.928 for lbp, rbp and rnbp (19,588 B less the
#: kernel's 7,536 plus the reference prelude's 18,320, over 32,804 B for
#: lbp; 0.965 before the prelude was a kernel, its torch gathers counted
#: op by op); the flops are 0.70-0.74 of the reference's (the reference's
#: kernel body traces more elementwise ops than the hand model charges)
ROUND_RATIO = 1.1


@pytest.mark.parametrize("name", ["lbp", "rbp", "rnbp"])
def test_round_cost_dominated_by_the_update(name):
    """The reference's pin: a round costs at least the kernel and under 6x
    its bytes; and the port's round is within ``ROUND_RATIO`` of the
    reference's, counted as the same program: the port runs its prelude
    as one kernel (``repro_torch::edge_prelude``, which moves fewer bytes
    than the plain prelude), the reference as plain jnp, so the bytes the
    counter charged the port's prelude op in the round are swapped for
    what the reference's plain prelude is charged."""
    jg = JD.ising_grid(8, 2.0, seed=0)
    g = PGM.from_numpy(vars(jg), jg.n_real_vertices, jg.n_real_edges,
                       device="cpu")
    kernel = TK.fused_update_cost(g.n_edges, g.n_states_max)
    got = TK.round_cost(g, get_scheduler(name), TO.make_triton_update(),
                        rng=torch.Generator().manual_seed(0))
    assert got.flops >= kernel.flops and got.bytes >= kernel.bytes
    assert got.bytes < 6.0 * kernel.bytes
    ref = JK.round_cost(jg, j_get_scheduler(name),
                        JO.make_triton_update(True))
    # what the counter itself charged the prelude's op in that round
    charged = []

    class Charges(OpCounter):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            if str(func.overloadpacket) == "repro_torch.edge_prelude":
                charged.append(charge(func, args, kwargs or {}, out))
            return out
    one_round, args = TK.engine_round(g, get_scheduler(name),
                                      TO.make_triton_update(),
                                      rng=torch.Generator().manual_seed(0))
    with Charges() as c:
        one_round(*args)
    assert c.cost == got
    (one_op,) = charged                     # one prelude op a round
    prelude = one_op["fused"]
    assert prelude == TK.edge_prelude_cost(g.n_edges, g.n_vertices,
                                           g.n_states_max,
                                           g.in_edges.shape[1])
    ref_prelude = JC.trace_cost(lambda lm: JM.edge_prelude(jg, lm),
                                j_spec((g.n_edges, g.n_states_max)))
    assert prelude.bytes < ref_prelude.bytes
    as_ref = got.bytes - prelude.bytes + ref_prelude.bytes
    assert 1 / ROUND_RATIO < as_ref / ref.bytes < ROUND_RATIO, \
        (got, prelude, ref, ref_prelude)
    # on fake tensors the same round costs the same
    from torch._subclasses.fake_tensor import FakeTensorMode
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    with mode:
        fake = TK.round_cost(g, get_scheduler(name), TO.make_triton_update(),
                             rng=torch.Generator().manual_seed(0))
    assert fake == got


# --------------------------------------------------- the ten LM families --

B, S = 2, 16


def _r_serve(cfg):
    if cfg.frontend == "vision":
        t = cfg.n_frontend_tokens
        return {"frontend_embeds": j_spec((B, t, cfg.d_model), jnp.bfloat16),
                "tokens": j_spec((B, S - t), jnp.int32)}
    if cfg.frontend == "audio":
        return {"frontend_embeds": j_spec((B, S, cfg.d_model), jnp.bfloat16),
                "tokens": j_spec((B, 1), jnp.int32)}
    return {"tokens": j_spec((B, S), jnp.int32)}


def _t_serve(batch):
    dt = {"bfloat16": torch.bfloat16, "int32": torch.int32}
    return {k: torch.zeros(v.shape, dtype=dt[str(v.dtype)]) for k, v in
            batch.items()}


def ref_counts(arch):
    """{step: (dot flops, total Cost)} of the reference at ``reduced()``."""
    cfg = RC.get(arch).reduced()
    model = r_build(cfg)
    ps = model.param_specs()
    jaxprs = {
        "prefill": jax.make_jaxpr(model.prefill)(ps, _r_serve(cfg)),
        "decode": jax.make_jaxpr(model.decode_step)(
            ps, model.init_cache_specs(B, S), j_spec((B, 1), jnp.int32),
            j_spec((), jnp.int32)),
        "train": jax.make_jaxpr(r_train_step(model))(
            r_state_specs(model), r_batch_specs(cfg, RShape("t", S, B,
                                                            "train")))}
    return {k: (j_dots(j.jaxpr), JC.jaxpr_cost(j.jaxpr))
            for k, j in jaxprs.items()}


def port_counts(arch):
    """{step: (dot flops, total Cost)} of the port at ``reduced()``."""
    cfg = TC.get(arch).reduced()
    model = build_model(cfg, device="cpu")
    out = {}
    with OpCounter() as c:
        model.prefill(_t_serve(_r_serve(RC.get(arch).reduced())))
    out["prefill"] = c
    with OpCounter() as c:
        model.decode_step(model.init_cache(B, S),
                          torch.zeros((B, 1), dtype=torch.int32),
                          torch.tensor(S - 1))
    out["decode"] = c
    state = init_train_state(model, torch.Generator().manual_seed(0))
    batch = {k: torch.zeros(v.shape, dtype=v.dtype) for k, v in
             t_batch_specs(cfg, TShape("t", S, B, "train")).items()}
    step = make_train_step(model)
    with OpCounter() as c:
        step(state, batch)
    out["train"] = c
    return {k: (c.by_class["dot"].flops, c.cost) for k, c in out.items()}


def _experts(arch, tokens):
    """Flops of the forward expert products of the routed tokens: three
    products of d x f per routed copy, in every MoE layer."""
    cfg = TC.get(arch).reduced()
    layers = cfg.n_layers - cfg.n_dense_layers
    return 6.0 * tokens * cfg.experts_per_token * cfg.d_model * cfg.d_ff \
        * layers


def _scan_excess(arch, step):
    """The reference's SSD dot flops over the port's, in every SSM layer:
    its ``ssd_chunked`` (prefill, padded to one chunk of 256) or its
    decode's outer product ``einsum("bh,bhp,bn->bhpn")``, both
    multi-operand einsums that jax splits into ``dot_general``s with
    contractions of length 1, where the port multiplies elementwise."""
    cfg = TC.get(arch).reduced()
    h, p, n = cfg.d_inner // cfg.ssm_head_p, cfg.ssm_head_p, cfg.ssm_state
    if step == "decode":
        ref = j_dots(jax.make_jaxpr(
            lambda a, b, c: jnp.einsum("bh,bhp,bn->bhpn", a, b, c))(
            j_spec((B, h)), j_spec((B, h, p)), j_spec((B, n))).jaxpr)
        return ref * cfg.n_layers
    shapes = ((B, 256, h, p), (B, 256, h), (h,), (B, 256, n), (B, 256, n))
    ref = j_dots(jax.make_jaxpr(lambda *a: RS.ssd_chunked(*a, chunk=256))(
        *(j_spec(s) for s in shapes)).jaxpr)
    with OpCounter() as c:
        TS.ssd_chunked(*(torch.zeros(s) for s in shapes), chunk=256)
    return (ref - c.by_class["dot"].flops) * cfg.n_layers


def dot_pin(arch, step, ref_dots, got_dots):
    """Check the port's dot flops against the reference's: equal where
    both run the same products, else the pinned difference."""
    cfg = TC.get(arch).reduced()
    tokens = B * (1 if step == "decode" else S)
    if cfg.n_experts:
        # the reference's walker charges ``ragged_dot`` one flop per output
        # element (``jaxpr_cost.py:166-168``); the port's groups are plain
        # products, counted as dots
        fwd = _experts(arch, tokens)
        if step != "train":
            assert got_dots - ref_dots == fwd
        else:
            # forward, recompute and both gradients: 4x, and up to 5 % more
            # where torch's checkpoint recomputes a product the reference's
            # remat drops (the combine of the routed copies)
            assert 4 * fwd <= got_dots - ref_dots <= 4.2 * fwd
        return got_dots - ref_dots
    if cfg.ssm or cfg.hybrid:
        if step != "train":
            assert ref_dots - got_dots == _scan_excess(arch, step)
        else:
            # the scan's products, forward, recompute and backward, through
            # the same multi-operand einsums: fewer dots in the port
            assert got_dots < ref_dots
        return got_dots - ref_dots
    if arch == "whisper_medium" and step == "prefill":
        # the decoder's attention over its one token contracts a length of
        # 1: torch's einsum multiplies, jax's makes a dot_general
        assert ref_dots - got_dots == \
            2.0 * B * cfg.n_heads * cfg.resolved_head_dim * cfg.n_layers
        return got_dots - ref_dots
    assert got_dots == ref_dots
    return 0.0


#: the total flops, less the pinned dot difference, within this share of
#: the reference's (measured: 0.959 to 1.040 over the 30 steps)
TOTAL_TOL = 0.10


@pytest.mark.parametrize("arch", list(TC.ARCH_IDS))
def test_lm_steps_count_the_reference_dots(arch):
    ref, got = ref_counts(arch), port_counts(arch)
    for step in ("prefill", "decode", "train"):
        (rd, rc), (gd, gc) = ref[step], got[step]
        diff = dot_pin(arch, step, rd, gd)
        assert abs((gc.flops - diff) / rc.flops - 1) <= TOTAL_TOL, \
            (step, gc, rc)
