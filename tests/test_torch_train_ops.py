"""The port's training ops, layers, initializers, schedules and reader
against ``mila_tpu`` on identical numpy inputs: forward values and, for
every op with a manual VJP in JAX, the gradients (JAX's ``jax.vjp`` against
``torch.autograd.grad`` with the same cotangent).

Tolerances: in f32 both sides compute the same formulas in f32; products
and sums run in other orders and transcendentals come from other
libraries, a few f32 ulps: rtol/atol 1e-5 (2e-5 where a sum runs over a
vocabulary or a sequence). In bf16 each output is one rounding of an f32
value; a one-ulp difference before that rounding flips it by one bf16 step
(2^-8 of the value), so outputs and gradients agree within 1e-2 of the
largest reference value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mila_tpu import ops as jops
from mila_tpu_torch import ops as tops

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _j(a, dt):
    return jnp.asarray(a).astype(dt)


def _t(a, dt, grad=False):
    return torch.from_numpy(np.asarray(a)).to(dt).requires_grad_(grad)


def _as_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, dtype):
    got, want = _as_np(got), _as_np(want)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-2 * np.abs(want).max() + 1e-6)


def _vjp_pair(jfn, tfn, arrays, g, dtype):
    """(JAX out, JAX grads), (torch out, torch grads) for float inputs."""
    jd, td = DTYPES[dtype]
    jout, vjp = jax.vjp(jfn, *(_j(a, jd) for a in arrays))
    jgrads = vjp(_j(g, jout.dtype))
    targs = [_t(a, td, grad=True) for a in arrays]
    tout = tfn(*targs)
    tgrads = torch.autograd.grad(tout, targs, _t(g, tout.dtype))
    return (jout, jgrads), (tout, tgrads)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("bias", [True, False])
def test_linear_forward_and_vjp(dtype, bias):
    x, w, b, g = _np(0, 3, 5, 48), _np(1, 48, 40, scale=0.2), _np(2, 40), _np(3, 3, 5, 40)
    args = [x, w, b] if bias else [x, w]
    (jo, jg), (to, tg) = _vjp_pair(lambda *a: jops.linear(*a), lambda *a: tops.linear(*a), args,
                                   g, dtype)
    _close(to, jo, dtype)
    assert to.dtype == DTYPES[dtype][1]
    for a, b_ in zip(tg, jg):
        assert a.dtype == DTYPES[dtype][1]
        _close(a, b_, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_residual_vjp(dtype):
    a, b, g = _np(4, 2, 7, 16), _np(5, 2, 7, 16), _np(6, 2, 7, 16)
    (jo, jg), (to, tg) = _vjp_pair(jops.residual, tops.residual, [a, b], g, dtype)
    _close(to, jo, dtype)
    for x, y in zip(tg, jg):
        np.testing.assert_array_equal(_as_np(x), _as_np(y))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("approx", ["tanh", "exact", "sigmoid"])
def test_gelu_forward_and_vjp(dtype, approx):
    # In bf16, XLA's CPU evaluates JAX's GELU chain (about ten ops) rounding
    # to bf16 between ops, up to a few bf16 steps off; the port evaluates it
    # in f32 and rounds once. So the bf16 reference is JAX's f32 function on
    # the same bf16-rounded inputs, and the port must equal it rounded:
    # within one bf16 step (2^-8) of each value.
    x, g = _np(7, 4, 64, scale=2.0), _np(8, 4, 64)
    if dtype == "float32":
        (jo, (jg,)), (to, (tg,)) = _vjp_pair(lambda a: jops.gelu(a, approx),
                                             lambda a: tops.gelu(a, approx), [x], g, dtype)
        _close(to, jo, dtype)
        _close(tg, jg, dtype)
        return
    xb, gb = _t(x, torch.bfloat16, True), _t(g, torch.bfloat16)
    to = tops.gelu(xb, approx)
    (tg,) = torch.autograd.grad(to, xb, gb)
    jo, vjp = jax.vjp(lambda a: jops.gelu(a, approx), jnp.asarray(_as_np(xb)))
    (jg,) = vjp(jnp.asarray(_as_np(gb)))
    assert to.dtype == tg.dtype == torch.bfloat16
    np.testing.assert_allclose(_as_np(to), np.asarray(jo), rtol=2 ** -8, atol=1e-6)
    np.testing.assert_allclose(_as_np(tg), np.asarray(jg), rtol=2 ** -8, atol=1e-6)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_layer_norm_forward_and_vjp(dtype):
    # x in the working dtype, gamma and beta f32 (GPT-2's bf16 layout).
    x, gam, bet, g = _np(9, 3, 6, 64, scale=3.0), 1 + _np(10, 64, scale=0.1), _np(11, 64), \
        _np(12, 3, 6, 64)
    jd, td = DTYPES[dtype]
    jout, vjp = jax.vjp(lambda a, b, c: jops.layer_norm(a, b, c, 1e-5), _j(x, jd),
                        jnp.asarray(gam), jnp.asarray(bet))
    jg = vjp(_j(g, jd))
    xs, gs, bs = _t(x, td, True), _t(gam, torch.float32, True), _t(bet, torch.float32, True)
    tout = tops.layer_norm(xs, gs, bs, 1e-5)
    tg = torch.autograd.grad(tout, (xs, gs, bs), _t(g, td))
    _close(tout, jout, dtype)
    _close(tg[0], jg[0], dtype)
    assert tg[1].dtype == torch.float32 and tg[2].dtype == torch.float32
    # dgamma, dbeta: f32 sums over 18 rows of bf16-rounded products.
    for a, b in zip(tg[1:], jg[1:]):
        np.testing.assert_allclose(_as_np(a), _as_np(b), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("with_wpe", [True, False])
def test_encoder_forward_and_vjp(dtype, with_wpe):
    tokens = np.random.default_rng(13).integers(0, 50, (3, 10)).astype(np.int32)
    tokens[0, :4] = 7  # repeated tokens: the segment sum adds rows
    wte, wpe, g = _np(14, 50, 32, scale=0.02), _np(15, 16, 32, scale=0.02), _np(16, 3, 10, 32)
    jd, td = DTYPES[dtype]
    jt = jnp.asarray(tokens)
    if with_wpe:
        jout, vjp = jax.vjp(lambda a, b: jops.encoder(jt, a, b), _j(wte, jd), _j(wpe, jd))
    else:
        jout, vjp = jax.vjp(lambda a: jops.encoder(jt, a, None), _j(wte, jd))
    jg = vjp(_j(g, jd))
    ts = [_t(wte, td, True)] + ([_t(wpe, td, True)] if with_wpe else [])
    tout = tops.encoder(torch.from_numpy(tokens), *ts, *([] if with_wpe else [None]))
    tg = torch.autograd.grad(tout, ts, _t(g, td))
    _close(tout, jout, dtype)
    for a, b in zip(tg, jg):
        assert a.dtype == td
        _close(a, b, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_softmax_vjp(dtype):
    x, g = _np(17, 4, 9, 33, scale=2.0), _np(18, 4, 9, 33)
    (jo, (jg,)), (to, (tg,)) = _vjp_pair(lambda a: jops.softmax(a, -1),
                                         lambda a: tops.softmax(a, -1), [x], g, dtype)
    _close(to, jo, dtype)
    _close(tg, jg, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mha_qkv_forward_and_grad(dtype):
    # JAX differentiates its plain attention by autodiff and so does the
    # port; the softmax sums run over up to 24 keys.
    qkv, g = _np(19, 2, 24, 3 * 32), _np(20, 2, 24, 32)
    (jo, (jg,)), (to, (tg,)) = _vjp_pair(lambda a: jops.mha_qkv(a, 4),
                                         lambda a: tops.mha_qkv(a, 4), [qkv], g, dtype)
    if dtype == "float32":
        np.testing.assert_allclose(_as_np(to), _as_np(jo), rtol=5e-5, atol=5e-5)
        np.testing.assert_allclose(_as_np(tg), _as_np(jg), rtol=5e-5, atol=5e-5)
    else:
        _close(to, jo, dtype)
        _close(tg, jg, dtype)


# --------------------------------------------------------------------------
# layers, initializers, schedules, reader
# --------------------------------------------------------------------------

def test_initializers_are_seeded_by_name_and_sized_like_jax():
    from mila_tpu.tensor import init as jinit
    from mila_tpu_torch.tensor import init as tinit
    from mila_tpu_torch.utils.rng import generator, split_named

    g1, g2 = split_named(generator(3), "a", "b"), split_named(generator(3), "b", "a")
    assert torch.equal(torch.randn(5, generator=g1["a"]), torch.randn(5, generator=g2["a"]))
    assert not torch.equal(torch.randn(5, generator=g1["b"]), torch.randn(5, generator=g2["a"]))
    w = tinit.xavier_uniform(generator(0), (300, 200), dtype=torch.bfloat16)
    jw = jinit.xavier_uniform(jax.random.key(0), (300, 200))
    limit = float(np.sqrt(6.0 / 500))
    assert w.dtype == torch.bfloat16 and w.shape == (300, 200)
    assert w.float().abs().max() <= limit * 1.004 and float(jnp.abs(jw).max()) <= limit
    n = tinit.normal(generator(1), (400, 100), 0.02)
    assert abs(float(n.std()) - 0.02) < 1e-3 and abs(float(n.mean())) < 1e-3
    assert torch.equal(tinit.ones((3,)), torch.ones(3)) and torch.equal(tinit.zeros((3,)),
                                                                        torch.zeros(3))


@pytest.mark.parametrize("name,args", [
    ("constant", (3e-4,)),
    ("warmup_cosine", (6e-4, 10, 100, 6e-5)),
    ("warmup_linear", (1e-3, 5, 50)),
    ("step_decay", (0.1, 0.5, 7)),
])
def test_schedules_match_jax(name, args):
    from mila_tpu.optim import schedules as js
    from mila_tpu_torch.optim import schedules as ts

    jf, tf = getattr(js, name)(*args), getattr(ts, name)(*args)
    for step in (0, 1, 4, 5, 9, 10, 11, 37, 99, 100, 150):
        got, want = float(tf(step)), float(jf(step))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)


def test_array_reader_batches_in_jax_order():
    from mila_tpu.data.loader import ArrayReader as JReader
    from mila_tpu_torch.data.loader import ArrayReader as TReader

    x = np.arange(50 * 3).reshape(50, 3).astype(np.int32)
    y = np.arange(50).astype(np.int32)
    for kw in (dict(seed=4), dict(seed=4, shuffle=False, drop_last=False),
               dict(seed=1, process_rank=1, num_processes=2)):
        jr, tr = JReader(x, y, 8, **kw), TReader(x, y, 8, **kw)
        for epoch in (0, 1, 3):
            jr.reset(epoch)
            tr.reset(epoch)
            assert jr.num_batches == tr.num_batches
            for (a, b), (c, d) in zip(jr, tr):
                np.testing.assert_array_equal(a, c)
                np.testing.assert_array_equal(b, d)


def test_dropout_uses_its_generator_and_only_in_training():
    from mila_tpu_torch.nn import Dropout, DropoutConfig
    from mila_tpu_torch.utils.rng import generator

    d = Dropout(DropoutConfig(rate=0.25))
    x = torch.ones(64, 64)
    assert torch.equal(d.apply({}, x), x)
    a = d.apply({}, x, training=True, rngs={"dropout": generator(5)})
    b = d.apply({}, x, training=True, rngs={"dropout": generator(5)})
    assert torch.equal(a, b)
    kept = a != 0
    assert 0.7 < kept.float().mean() < 0.8
    torch.testing.assert_close(a[kept], torch.full_like(a[kept], 1 / 0.75))
    with pytest.raises(ValueError, match="rngs"):
        d.apply({}, x, training=True)


def test_layers_match_jax_on_bridged_params():
    # Sequential(Linear, Gelu, LayerNorm, Softmax), the SoftmaxCrossEntropy
    # loss and a Residual around a Linear, on params bridged from JAX.
    from mila_tpu import nn as jnn
    from mila_tpu_torch import nn as tnn
    from mila_tpu_torch.bridge import params_from_jax

    def build(nn):
        return nn.Sequential([
            ("fc", nn.Linear(nn.LinearConfig(name="fc", in_features=16, out_features=32))),
            ("act", nn.Gelu(nn.GeluConfig(approximation="exact"))),
            ("res", nn.Residual(nn.Linear(nn.LinearConfig(in_features=32, out_features=32)))),
            ("ln", nn.LayerNorm(nn.LayerNormConfig(features=32))),
            ("sm", nn.Softmax()),
        ])

    jm, tm = build(jnn), build(tnn)
    jp = jm.init(jax.random.key(0), (4, 16))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    x = _np(21, 4, 16)
    want = jm.apply(jp, jnp.asarray(x))
    got = tm.apply(tp, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    assert tm.parameter_count(tp) == jm.parameter_count(jp)
    assert tm.output_shape((4, 16)) == jm.output_shape((4, 16))
    tshapes = {k: tuple(v.shape) for k, v in tm.init(torch.Generator(), (4, 16), device="cpu")["fc"].items()}
    assert tshapes == {k: tuple(v.shape) for k, v in jp["fc"].items()}
    logits, t = _np(22, 6, 10), np.array([1, 2, -100, 4, 0, 9], np.int32)
    for red in ("mean", "sum", "none"):
        jl = jnn.SoftmaxCrossEntropy(jnn.SoftmaxCrossEntropyConfig(reduction=red)).apply(
            {}, jnp.asarray(logits), targets=jnp.asarray(t))
        tl = tnn.SoftmaxCrossEntropy(tnn.SoftmaxCrossEntropyConfig(reduction=red)).apply(
            {}, torch.from_numpy(logits), targets=torch.from_numpy(t))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-6)


def test_quantized_linear_routes_to_the_quant_kernel():
    from mila_tpu.inference.quantize import quantize as jquant
    from mila_tpu.nn import Linear as JLinear, LinearConfig as JCfg
    from mila_tpu_torch.bridge import params_from_jax
    from mila_tpu_torch.kernels import quant_matmul as qm
    from mila_tpu_torch.nn import Linear, LinearConfig

    w, b, x = _np(23, 64, 48, scale=0.1), _np(24, 48), _np(25, 5, 64)
    qt = jquant(jnp.asarray(w), "int8", block_size=0)
    jp = {"weight": qt, "bias": jnp.asarray(b)}
    want = JLinear(JCfg(in_features=64, out_features=48)).apply(jp, jnp.asarray(x))
    tp = params_from_jax({"weight": jax.tree_util.tree_map(np.asarray, qt),
                          "bias": np.asarray(b)}, device="cpu")
    calls = qm.quant_linear_plain.calls
    got = Linear(LinearConfig(in_features=64, out_features=48)).apply(tp, torch.from_numpy(x))
    assert qm.quant_linear_plain.calls == calls + 1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_remat_block_same_values_and_grads():
    # remat (torch.utils.checkpoint) changes no value: forward and every
    # parameter gradient equal the block without it, with dropout drawn from
    # a generator (the recomputation replays the forward's mask).
    from mila_tpu_torch.nn import TransformerBlock, TransformerBlockConfig
    from mila_tpu_torch.utils.rng import generator
    from mila_tpu_torch.utils.tree import tree_leaves, tree_unflatten

    cfg = TransformerBlockConfig(embedding_dim=32, num_heads=4, dropout=0.1)
    blk, blk_r = TransformerBlock(cfg), TransformerBlock(cfg.replace(remat=True))
    params = blk.init(generator(0), (2, 8, 32), device="cpu")
    x = torch.from_numpy(_np(26, 2, 8, 32))
    outs = []
    for b in (blk, blk_r):
        leaves = [p.clone().requires_grad_() for p in tree_leaves(params)]
        y = b.apply(tree_unflatten(params, leaves), x, training=True,
                    rngs={"dropout": generator(9)})
        outs.append((y, torch.autograd.grad((y ** 2).sum(), leaves)))
    torch.testing.assert_close(outs[0][0], outs[1][0], rtol=1e-6, atol=1e-6)
    for a, b in zip(outs[0][1], outs[1][1]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
