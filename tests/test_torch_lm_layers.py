"""The LM stack's layers in the port against the JAX reference.

The same numpy inputs and parameters (drawn from a seed, norm weights
around 1 so they matter) go through each reference function in
``repro.models.layers`` and its port in ``repro_torch.models.layers``;
float32 outputs agree within 1e-5 (absolute and relative). MoE routing is
compared first (the chosen experts equal), so a routing flip shows as
itself and not as an output mismatch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

from repro.models.layers import attention as RA
from repro.models.layers import basic as RB
from repro.models.layers import mla as RMLA
from repro.models.layers import moe as RMOE
from repro.models.layers import ssm as RS
from repro_torch.models.layers import attention as TA
from repro_torch.models.layers import basic as TB
from repro_torch.models.layers import mla as TMLA
from repro_torch.models.layers import moe as TMOE
from repro_torch.models.layers import ssm as TS

TOL = 1e-5


def draw(spec, rng):
    """numpy parameters for a port spec: dense leaves N(0, scale^2),
    constant leaves their value plus a 0.1-scale perturbation."""
    out = {}
    for k, leaf in spec.items():
        if isinstance(leaf, dict):
            out[k] = draw(leaf, rng)
        elif leaf.scale is not None:
            out[k] = (rng.standard_normal(leaf.shape) * leaf.scale).astype(
                np.float32)
        else:
            out[k] = (leaf.fill + 0.1 * rng.standard_normal(leaf.shape)
                      ).astype(np.float32)
    return out


def jx(tree):
    return jax.tree.map(jnp.asarray, tree)


def th(tree):
    if isinstance(tree, dict):
        return {k: th(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def close(port, ref, tol=TOL):
    np.testing.assert_allclose(np.asarray(port.detach().float()),
                               np.asarray(ref, np.float32), rtol=tol,
                               atol=tol)


def normal(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


# ---------------------------------------------------------- primitives ---

def test_rms_norm_and_layer_norm():
    rng = np.random.default_rng(0)
    x, w, b = normal(rng, 3, 5, 24), normal(rng, 24), normal(rng, 24)
    close(TB.rms_norm(th(w), th(x)), RB.rms_norm(jnp.asarray(w),
                                                 jnp.asarray(x)))
    close(TB.layer_norm(th(w), th(b), th(x)),
          RB.layer_norm(jnp.asarray(w), jnp.asarray(b), jnp.asarray(x)))


def test_rms_norm_keeps_bfloat16_in_and_out():
    rng = np.random.default_rng(1)
    x, w = normal(rng, 4, 32), normal(rng, 32)
    port = TB.rms_norm(th(w), th(x).to(torch.bfloat16))
    ref = RB.rms_norm(jnp.asarray(w), jnp.asarray(x, jnp.bfloat16))
    assert port.dtype == torch.bfloat16
    close(port, ref.astype(jnp.float32), tol=1e-2)


@pytest.mark.parametrize("theta", [1e4, 1e6])
@pytest.mark.parametrize("positions_1d", [False, True])
def test_apply_rope(theta, positions_1d):
    rng = np.random.default_rng(2)
    x = normal(rng, 2, 7, 3, 16)
    pos = np.arange(3, 10, dtype=np.int32)
    if not positions_1d:
        pos = np.stack([pos, pos + 100])
    close(TB.apply_rope(th(x), th(pos), theta),
          RB.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))


@pytest.mark.parametrize("d,theta", [(8, 1e4), (16, 1e4), (128, 1e6),
                                     (256, 1e4)])
def test_rope_frequencies_on_the_device_are_the_references(d, theta):
    np.testing.assert_array_equal(
        TB.rope_frequencies(d, theta, "cpu").numpy(),
        np.asarray(RB.rope_frequencies(d, theta), np.float32))


@pytest.mark.parametrize("name", ["silu", "gelu", "gelu_tanh", "relu"])
def test_act_fn(name):
    x = np.linspace(-6, 6, 401, dtype=np.float32)
    close(TB.act_fn(name)(th(x)), RB.act_fn(name)(jnp.asarray(x)))


def test_embed_and_unembed():
    rng = np.random.default_rng(3)
    table = normal(rng, 40, 16, scale=0.02)
    toks = rng.integers(0, 40, (2, 5)).astype(np.int32)
    x = normal(rng, 2, 5, 16)
    close(TB.embed({"table": th(table)}, th(toks), torch.float32),
          RB.embed({"table": jnp.asarray(table)}, jnp.asarray(toks),
                   jnp.float32))
    close(TB.unembed({"table": th(table)}, th(x)),
          RB.unembed({"table": jnp.asarray(table)}, jnp.asarray(x)))


# The bfloat16 dtype policy, where it is computed: float32 scores and
# unembedding move a bf16 model's logits by about as much as the bf16
# matmuls' own rounding does, so a model-level bound cannot tell them from
# bf16 ones. Each check below is held against a control that breaks the
# policy and must miss.
BF16_ULP = 2.0 ** -8


def bf16_round(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(a).bfloat16().double().numpy()


def rel_err(got, want) -> float:
    got = np.asarray(got.float() if torch.is_tensor(got) else got,
                     np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_unembed_of_bf16_activations_is_a_float32_product():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(normal(rng, 2, 5, 64)).bfloat16()
    table = normal(rng, 300, 64, scale=0.02)
    want = x.double().numpy() @ table.astype(np.float64).T
    got = TB.unembed({"table": th(table)}, x)
    ref = RB.unembed({"table": jnp.asarray(table)},
                     jnp.asarray(x.float().numpy(), jnp.bfloat16))
    control = TB.unembed({"table": th(table).bfloat16()}, x)
    assert got.dtype == torch.float32
    assert rel_err(got, want) <= 1e-5 and rel_err(ref, want) <= 1e-5
    assert rel_err(control, want) > 1e-4


@pytest.mark.parametrize("path", ["forward", "decode"])
def test_attention_scores_of_bf16_inputs_run_in_float32(path):
    """Scores near 40, spread over a few units: bf16 rounds them by up to
    0.125, which moves the softmax weights by percents. Weights of 0 and 1
    make q, k and v exact slices of the bf16 input, so both packages must
    match a float64 oracle of the policy (scores in float32 or better,
    softmax weights cast to bf16, PV, output in bf16) within one bf16 ulp,
    and the oracle with its scores rounded to bf16 must miss by five."""
    h, d, s, b = 2, 16, 12, 2
    eye = np.eye(3 * d, dtype=np.float32)
    p = {"wq": eye[:, :2 * d], "wk": eye[:, :d], "wv": eye[:, 2 * d:],
         "wo": eye[:2 * d]}
    rng = np.random.default_rng(1)
    xa = rng.standard_normal((b, s, 3 * d))
    xa[..., :2 * d] = 3.2 + 0.3 * xa[..., :2 * d]
    x = torch.from_numpy(xa.astype(np.float32)).bfloat16()
    x64 = x.double().numpy()
    q = x64[..., :2 * d].reshape(b, s, 1, h, d)
    k, v = x64[..., None, :d], x64[..., None, 2 * d:]
    scores = np.einsum("bqhgd,bshd->bhgqs", q, k) / np.sqrt(d)
    causal = np.tril(np.ones((s, s), bool))

    def oracle(sc):
        sc = np.where(causal, sc, -np.inf)
        w = np.exp(sc - sc.max(-1, keepdims=True))
        w = bf16_round(w / w.sum(-1, keepdims=True))
        out = np.einsum("bhgqs,bshd->bqhgd", w, v).reshape(b, s, 2 * d)
        return bf16_round(out)[:, -1:] if path == "decode" else bf16_round(out)

    want, control = oracle(scores), oracle(bf16_round(scores))
    kw = dict(n_heads=h, n_kv_heads=1, head_dim=d, rope_theta=0.0)
    tp = {n: th(w).bfloat16() for n, w in p.items()}
    rp = {n: jnp.asarray(w, jnp.bfloat16) for n, w in p.items()}
    rx = jnp.asarray(x.float().numpy(), jnp.bfloat16)
    if path == "forward":
        got = TA.attn_forward(tp, x, torch.arange(s), **kw)[0]
        ref = RA.attn_forward(rp, rx, jnp.arange(s), **kw)[0]
    else:
        ck = torch.zeros(b, s + 3, 1, d, dtype=torch.bfloat16)
        cv = ck.clone()
        ck[:, :s - 1, 0] = x[:, :s - 1, :d]
        cv[:, :s - 1, 0] = x[:, :s - 1, 2 * d:]
        rck, rcv = (jnp.asarray(c.float().numpy(), jnp.bfloat16)
                    for c in (ck, cv))
        got = TA.attn_decode(tp, x[:, -1:], ck, cv, s - 1, **kw)[0]
        ref = RA.attn_decode(rp, rx[:, -1:], rck, rcv, jnp.int32(s - 1),
                             **kw)[0]
    assert got.dtype == torch.bfloat16
    assert rel_err(got[..., :2 * d], want) <= BF16_ULP
    assert rel_err(np.asarray(ref, np.float32)[..., :2 * d], want) <= BF16_ULP
    assert rel_err(control, want) >= 5 * BF16_ULP


def test_dense_init_scale_and_generator():
    g = torch.Generator().manual_seed(0)
    w = TB.dense_init(g, (512, 256))
    assert w.dtype == torch.float32 and w.shape == (512, 256)
    assert abs(float(w.std()) - 1 / np.sqrt(512)) < 2e-3
    again = TB.dense_init(torch.Generator().manual_seed(0), (512, 256))
    assert torch.equal(w, again)


# ----------------------------------------------------------- attention ---

ATTN = dict(n_heads=4, n_kv_heads=2, head_dim=8)


def attn_params(rng, qk_norm=True):
    return draw(TA.init_attention(32, 4, 2, 8, qk_norm=qk_norm), rng)


@pytest.mark.parametrize("s,q_block", [(8, 512), (16, 4)],
                         ids=["one_block", "q_blocks"])
@pytest.mark.parametrize("mode", ["causal", "window", "bidirectional"])
def test_attn_forward(s, q_block, mode):
    rng = np.random.default_rng(4)
    p = attn_params(rng)
    x = normal(rng, 2, s, 32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (2, s)).copy()
    kw = dict(ATTN, rope_theta=1e4, qk_norm=True, q_block=q_block,
              causal=mode != "bidirectional",
              sliding_window=3 if mode == "window" else 0)
    out, (k, v) = TA.attn_forward(th(p), th(x), th(pos), **kw)
    rout, (rk, rv) = RA.attn_forward(jx(p), jnp.asarray(x), jnp.asarray(pos),
                                     **kw)
    close(out, rout)
    close(k, rk)
    close(v, rv)


def test_attn_forward_rejects_a_ragged_last_block():
    rng = np.random.default_rng(5)
    x = th(normal(rng, 1, 10, 32))
    with pytest.raises(AssertionError):
        TA.attn_forward(th(attn_params(rng)), x, torch.arange(10), q_block=4,
                        **ATTN)


@pytest.mark.parametrize("window", [0, 4])
def test_attn_decode_writes_at_pos(window):
    rng = np.random.default_rng(6)
    p = attn_params(rng)
    x1 = normal(rng, 2, 1, 32)
    ck, cv = normal(rng, 2, 12, 2, 8), normal(rng, 2, 12, 2, 8)
    kw = dict(ATTN, rope_theta=1e6, qk_norm=True, sliding_window=window)
    tk, tv = th(ck), th(cv)
    out, tk2, tv2 = TA.attn_decode(th(p), th(x1), tk, tv, 7, **kw)
    rout, rk, rv = RA.attn_decode(jx(p), jnp.asarray(x1), jnp.asarray(ck),
                                  jnp.asarray(cv), jnp.int32(7), **kw)
    close(out, rout)
    close(tk, rk)           # written in place
    close(tv, rv)
    assert tk2 is tk and tv2 is tv


def test_attn_decode_takes_a_tensor_position():
    rng = np.random.default_rng(7)
    p = th(attn_params(rng, qk_norm=False))
    x1 = th(normal(rng, 1, 1, 32))
    c1 = [th(normal(rng, 1, 6, 2, 8)) for _ in range(2)]
    c2 = [c.clone() for c in c1]
    a = TA.attn_decode(p, x1, *c1, 3, **ATTN)[0]
    b = TA.attn_decode(p, x1, *c2, torch.tensor(3), **ATTN)[0]
    assert torch.equal(a, b) and torch.equal(c1[0], c2[0])


@pytest.mark.parametrize("pos", [5, 37])
def test_attn_decode_ring(pos):
    rng = np.random.default_rng(8)
    p = attn_params(rng)
    w = 8
    x1 = normal(rng, 2, 1, 32)
    ck, cv = normal(rng, 2, w, 2, 8), normal(rng, 2, w, 2, 8)
    # slot j holds the latest position before pos that is j mod w (-1: none)
    last = pos - 1 - (pos - 1 - np.arange(w)) % w
    cpos = np.where(last >= 0, last, -1).astype(np.int32)
    kw = dict(ATTN, rope_theta=1e4, qk_norm=True, sliding_window=w)
    tk, tv, tp = th(ck), th(cv), th(cpos)
    out = TA.attn_decode_ring(th(p), th(x1), tk, tv, tp, pos, **kw)[0]
    rout, rk, rv, rp = RA.attn_decode_ring(
        jx(p), jnp.asarray(x1), jnp.asarray(ck), jnp.asarray(cv),
        jnp.asarray(cpos), jnp.int32(pos), **kw)
    close(out, rout)
    close(tk, rk)
    close(tv, rv)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(rp))


def test_cross_attn_and_cross_kv():
    rng = np.random.default_rng(9)
    p = draw(TA.init_cross_attention(32, 4, 8), rng)
    x, enc = normal(rng, 2, 3, 32), normal(rng, 2, 6, 32)
    k, v = TA.cross_kv(th(p), th(enc), n_heads=4, head_dim=8)
    rk, rv = RA.cross_kv(jx(p), jnp.asarray(enc), n_heads=4, head_dim=8)
    close(k, rk)
    close(v, rv)
    close(TA.cross_attn(th(p), th(x), k, v, n_heads=4, head_dim=8),
          RA.cross_attn(jx(p), jnp.asarray(x), rk, rv, n_heads=4,
                        head_dim=8))


# ----------------------------------------------------------------- SSM ---

SSM = dict(d_inner=64, d_state=8, head_p=16)


def ssm_params(rng):
    p = draw(TS.init_ssm(32, 64, 8, 16), rng)
    p["A_log"] = normal(rng, 4, scale=0.5)
    return p


def test_ssd_chunked():
    rng = np.random.default_rng(10)
    b, s, h, pdim, n = 2, 12, 3, 4, 5
    x, B, C = normal(rng, b, s, h, pdim), normal(rng, b, s, n), \
        normal(rng, b, s, n)
    dt = np.abs(normal(rng, b, s, h, scale=0.5))
    A = -np.abs(normal(rng, h))
    y, hl = TS.ssd_chunked(th(x), th(dt), th(A), th(B), th(C), chunk=4)
    ry, rh = RS.ssd_chunked(jnp.asarray(x), jnp.asarray(dt), jnp.asarray(A),
                            jnp.asarray(B), jnp.asarray(C), chunk=4)
    close(y, ry)
    close(hl, rh)


def test_ssd_chunked_gradients_finite_over_long_chunks():
    """Over a chunk long enough that exp(cum_i - cum_j) overflows above the
    diagonal, the port's scan equals the reference's forward and its
    gradients are finite; the reference's ``where(mask, exp(.), 0)``
    backpropagates NaN there (0 * inf)."""
    rng = np.random.default_rng(15)
    b, s, h, pdim, n = 1, 32, 2, 4, 3
    x, B, C = normal(rng, b, s, h, pdim), normal(rng, b, s, n), \
        normal(rng, b, s, n)
    dt = np.full((b, s, h), 4.0, np.float32)       # cum_i - cum_j up to 124
    A = -np.ones(h, np.float32)
    ts = [th(a).requires_grad_(True) for a in (x, dt, A, B, C)]
    y, hl = TS.ssd_chunked(*ts, chunk=s)
    ry, rh = RS.ssd_chunked(*map(jnp.asarray, (x, dt, A, B, C)), chunk=s)
    close(y, ry)
    close(hl, rh)
    (y.sum() + hl.sum()).backward()
    assert all(bool(torch.isfinite(t.grad).all()) for t in ts)
    rgrads = jax.grad(lambda *a: sum(
        o.sum() for o in RS.ssd_chunked(*a, chunk=s)), argnums=(0, 1, 2))(
        *map(jnp.asarray, (x, dt, A, B, C)))
    assert any(bool(jnp.isnan(g).any()) for g in rgrads)


@pytest.mark.parametrize("s", [10, 8], ids=["padded", "whole_chunks"])
def test_ssm_forward(s):
    rng = np.random.default_rng(11)
    p = ssm_params(rng)
    x = normal(rng, 2, s, 32)
    out, (st, conv) = TS.ssm_forward(th(p), th(x), chunk=4, **SSM)
    rout, (rst, rconv) = RS.ssm_forward(jx(p), jnp.asarray(x), chunk=4, **SSM)
    close(out, rout)
    close(st, rst)
    close(conv, rconv)


def test_causal_conv_with_history():
    rng = np.random.default_rng(12)
    xbc, w, hist = normal(rng, 2, 5, 6), normal(rng, 4, 6), normal(rng, 2, 3, 6)
    out, st = TS._causal_conv(th(xbc), th(w), th(hist))
    rout, rst = RS._causal_conv(jnp.asarray(xbc), jnp.asarray(w),
                                jnp.asarray(hist))
    close(out, rout)
    close(st, rst)


def test_ssm_decode():
    rng = np.random.default_rng(13)
    p = ssm_params(rng)
    x1 = normal(rng, 2, 1, 32)
    st, conv = normal(rng, 2, 4, 16, 8), normal(rng, 2, 3, 80)
    out, st2, conv2 = TS.ssm_decode(th(p), th(x1), th(st), th(conv), **SSM)
    rout, rst, rconv = RS.ssm_decode(jx(p), jnp.asarray(x1), jnp.asarray(st),
                                     jnp.asarray(conv), **SSM)
    close(out, rout)
    close(st2, rst)
    close(conv2, rconv)


# ----------------------------------------------------------------- MoE ---

def moe_params(rng, n_shared):
    p = draw(TMOE.init_moe(32, 6, 24, n_shared, 24), rng)
    p["router"] = normal(rng, 32, 6)        # well separated routing logits
    return p


@pytest.mark.parametrize("dispatch", ["ragged", "dense"])
@pytest.mark.parametrize("n_shared", [0, 1])
def test_moe_routes_then_matches(dispatch, n_shared):
    rng = np.random.default_rng(14)
    p = moe_params(rng, n_shared)
    x = normal(rng, 2, 7, 32)
    _, _, top_p, top_e = TMOE._route(th(p), th(x).reshape(14, 32), 2)
    _, _, rtop_p, rtop_e = RMOE._route(jx(p), jnp.asarray(x).reshape(14, 32),
                                       2)
    np.testing.assert_array_equal(top_e.numpy(), np.asarray(rtop_e))
    close(top_p, rtop_p)
    out, (lb, z) = TMOE.moe(th(p), th(x), n_experts=6, top_k=2,
                            dispatch=dispatch)
    rout, (rlb, rz) = RMOE.moe(jx(p), jnp.asarray(x), n_experts=6, top_k=2,
                               dispatch=dispatch)
    close(out, rout)
    close(lb, rlb)
    close(z, rz)


def test_moe_ragged_and_dense_agree():
    rng = np.random.default_rng(15)
    p = th(moe_params(rng, 0))
    x = th(normal(rng, 3, 5, 32))
    a = TMOE.moe(p, x, n_experts=6, top_k=3, dispatch="ragged")[0]
    b = TMOE.moe(p, x, n_experts=6, top_k=3, dispatch="dense")[0]
    close(a, b.numpy())


def test_moe_sharded_dispatch_raises():
    """Without a mesh (the model's or ``set_shard_mesh``'s) the "sharded"
    dispatch raises, as the reference asserts; with one it runs
    (``tests/test_torch_lm_sharded.py``)."""
    rng = np.random.default_rng(16)
    with pytest.raises(ValueError, match="set_shard_mesh"):
        TMOE.moe(th(moe_params(rng, 0)), th(normal(rng, 1, 2, 32)),
                 n_experts=6, top_k=2, dispatch="sharded")


# ----------------------------------------------------------------- MLA ---

MLA = dict(n_heads=4, q_lora=24, kv_lora=16, rope_d=8, nope_d=16, v_d=12)


def mla_params(rng):
    return draw(TMLA.init_mla(32, **MLA), rng)


@pytest.mark.parametrize("s,q_block", [(6, 512), (12, 4)],
                         ids=["one_block", "q_blocks"])
def test_mla_forward(s, q_block):
    rng = np.random.default_rng(17)
    p = mla_params(rng)
    x = normal(rng, 2, s, 32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (2, s)).copy()
    out, (c, kr) = TMLA.mla_forward(th(p), th(x), th(pos), q_block=q_block,
                                    **MLA)
    rout, (rc, rkr) = RMLA.mla_forward(jx(p), jnp.asarray(x),
                                       jnp.asarray(pos), q_block=q_block,
                                       **MLA)
    close(out, rout)
    close(c, rc)
    close(kr, rkr)


def test_mla_decode():
    rng = np.random.default_rng(18)
    p = mla_params(rng)
    x1 = normal(rng, 2, 1, 32)
    cc, ckr = normal(rng, 2, 9, 16), normal(rng, 2, 9, 8)
    tc, tkr = th(cc), th(ckr)
    out = TMLA.mla_decode(th(p), th(x1), tc, tkr, 4, **MLA)[0]
    rout, rc, rkr = RMLA.mla_decode(jx(p), jnp.asarray(x1), jnp.asarray(cc),
                                    jnp.asarray(ckr), jnp.int32(4), **MLA)
    close(out, rout)
    close(tc, rc)
    close(tkr, rkr)
