"""The port's convolution ops, layers and CNN classifier: twins of the nine
tests in ``tests/nn/test_conv.py``, then the same functions against the
JAX package: ``conv2d`` (SAME and VALID, stride 1 and 2, odd and even
sizes, with and without bias) and both pools, forward and gradient
(``jax.vjp`` on one cotangent), max pooling over windows with ties; the
``CNNClassifier``'s logits from bridged params; one ``Model`` train step
(loss, every gradient leaf, the params after AdamW) against JAX's
``Model``; and the archive each package exports for the CNN, compared
blob for blob, which neither package's ``load_exported`` rebuilds.

Tolerances, of each tensor's largest magnitude: f32 convolutions and pools
1e-5 (both sides sum in f32 in other orders); bf16 2^-6 (both round once
from f32, so at most a step or two of 2^-8 apart; a bf16 average pool is
summed in bf16 by JAX). Max pooling's gradient is exact: each window's
cotangent goes to its first maximum on both sides. The CNN's logits and
its step: 1e-5 relative for the loss, 1e-4 of each leaf's largest value
for the gradients (a gradient through two convolutions, pools and three
GELUs), and after AdamW every param within 2 lr of JAX's, within 1e-6
where |m| is above 1e-3 of its leaf's max (below, a near-zero gradient
may take the other sign and step the other way).
"""

import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mila_tpu.models.cnn_classifier import CNNClassifier as JCNN
from mila_tpu.models.cnn_classifier import CNNClassifierConfig as JCNNConfig
from mila_tpu.models.export import export_model as j_export_model
from mila_tpu.models.export import load_exported as j_load_exported
from mila_tpu.models.model import Model as JModel
from mila_tpu.models.model import ModelConfig as JModelConfig
from mila_tpu.ops import avg_pool2d as j_avg_pool2d
from mila_tpu.ops import conv2d as j_conv2d
from mila_tpu.ops import max_pool2d as j_max_pool2d
from mila_tpu.optim import AdamW as JAdamW
from mila_tpu.optim import AdamWConfig as JAdamWConfig
from mila_tpu_torch.bridge import params_from_jax
from mila_tpu_torch.data import synthetic_mnist
from mila_tpu_torch.models import CNNClassifier, CNNClassifierConfig
from mila_tpu_torch.models.export import export_model, load_exported
from mila_tpu_torch.models.model import Model, ModelConfig
from mila_tpu_torch.nn import Conv2D, Conv2DConfig, Flatten, Pool2D, Pool2DConfig
from mila_tpu_torch.ops import avg_pool2d, conv2d, max_pool2d, softmax_cross_entropy
from mila_tpu_torch.optim import AdamW, AdamWConfig
from mila_tpu_torch.utils.registry import models as model_registry
from mila_tpu_torch.utils.tree import tree_leaves, tree_unflatten

TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -6}


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _randn(seed, *shape):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape)
                            .astype(np.float32))


def _arr(rng, shape, dtype, scale=1.0):
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(a).astype(dtype), torch.from_numpy(a).to(getattr(torch, dtype))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol, what=""):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30), err_msg=what)


# --------------------------------------------------------------------------
# Twins of tests/nn/test_conv.py
# --------------------------------------------------------------------------

class TestConvOps:
    def test_identity_kernel(self):
        x = torch.arange(16.0).reshape(1, 4, 4, 1)
        w = torch.zeros(3, 3, 1, 1)
        w[1, 1, 0, 0] = 1.0
        torch.testing.assert_close(conv2d(x, w), x, rtol=1e-6, atol=0)

    def test_matches_manual_valid_conv(self):
        x, w = _randn(0, 1, 5, 5, 1), _randn(1, 3, 3, 1, 1)
        y = conv2d(x, w, padding="VALID")
        assert y.shape == (1, 3, 3, 1)
        manual = sum(float(x[0, 1 + di, 1 + dj, 0]) * float(w[di, dj, 0, 0])
                     for di in range(3) for dj in range(3))
        np.testing.assert_allclose(float(y[0, 1, 1, 0]), manual, rtol=1e-4)

    def test_bias_and_stride(self):
        x, w = _randn(2, 2, 8, 8, 3), _randn(3, 3, 3, 3, 16)
        y = conv2d(x, w, torch.ones(16), stride=2)
        assert y.shape == (2, 4, 4, 16)

    def test_pools(self):
        x = torch.arange(16.0).reshape(1, 4, 4, 1)
        mp, ap = max_pool2d(x, 2), avg_pool2d(x, 2)
        assert mp.shape == (1, 2, 2, 1)
        assert float(mp[0, 0, 0, 0]) == 5.0
        assert float(ap[0, 0, 0, 0]) == 2.5


class TestConvLayer:
    def test_init_and_shapes(self):
        layer = Conv2D(Conv2DConfig(in_channels=1, out_channels=8))
        p = layer.init(_gen(), (2, 28, 28, 1), device="cpu")
        assert p["weight"].shape == (3, 3, 1, 8)
        assert p["bias"].shape == (8,) and not p["bias"].any()
        # He normal: std sqrt(2 / fan_in), fan_in = 3 * 3 * 1.
        assert abs(float(p["weight"].std()) - (2 / 9) ** 0.5) < 0.15
        y = layer.apply(p, torch.zeros(2, 28, 28, 1))
        assert y.shape == (2, 28, 28, 8)
        assert layer.output_shape((2, 28, 28, 1)) == (2, 28, 28, 8)

    def test_channel_mismatch(self):
        layer = Conv2D(Conv2DConfig(in_channels=3, out_channels=8))
        with pytest.raises(ValueError, match="channels"):
            layer.init(_gen(), (1, 8, 8, 1), device="cpu")

    def test_pool_flatten_shapes(self):
        pool = Pool2D(Pool2DConfig(window=2))
        assert pool.output_shape((1, 28, 28, 8)) == (1, 14, 14, 8)
        assert Flatten().output_shape((2, 14, 14, 8)) == (2, 14 * 14 * 8)


class TestCNNClassifier:
    def test_forward_from_flat_input(self):
        model = CNNClassifier(CNNClassifierConfig(conv_channels=(8, 16), hidden_dim=32))
        p = model.init(_gen(), (4, 784), device="cpu")
        y = model.apply(p, _randn(0, 4, 784))
        assert y.shape == (4, 10)

    def test_learns_synthetic_digits(self):
        model = CNNClassifier(CNNClassifierConfig(conv_channels=(8,), hidden_dim=32))
        params = model.init(_gen(), (32, 784), device="cpu")
        opt = AdamW(AdamWConfig(learning_rate=2e-3))
        state = opt.init(params)
        x_np, y_np = synthetic_mnist(n=256, seed=0)
        x, y = torch.from_numpy(x_np), torch.from_numpy(y_np)

        def step(params, state):
            leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
            loss = softmax_cross_entropy(model.apply(tree_unflatten(params, leaves), x), y).mean()
            grads = tree_unflatten(params, list(torch.autograd.grad(loss, leaves)))
            p2, s2 = opt.step(state, params, grads)
            return p2, s2, float(loss.detach())

        params, state, l0 = step(params, state)
        for _ in range(20):
            params, state, loss = step(params, state)
        assert loss < l0 * 0.5


# --------------------------------------------------------------------------
# Against the JAX package
# --------------------------------------------------------------------------

def _vjp_check(jfn, tfn, jargs, targs, tol, seed=7, vjp_in_f32=False):
    """Forward and gradients of both on one cotangent. ``vjp_in_f32``:
    JAX's VJP is taken on the inputs and cotangent widened to f32 (its
    bf16 convolution has no transpose: ``conv_general_dilated`` with
    ``preferred_element_type`` f32 refuses the mixed dtypes of its own
    VJP), which the port's gradient, computed in f32 and rounded once,
    must match to its tolerance."""
    jout, vjp = jax.vjp(jfn, *jargs)
    if vjp_in_f32:
        _, vjp = jax.vjp(jfn, *[a.astype(jnp.float32) for a in jargs])
    leaves = [t.clone().requires_grad_() for t in targs]
    tout = tfn(*leaves)
    assert tout.shape == jout.shape and tout.dtype == getattr(torch, str(jout.dtype))
    _close(tout, jout, tol, "forward")
    jg, tg = _arr(np.random.default_rng(seed), jout.shape, str(jout.dtype))
    if vjp_in_f32:
        jg = jg.astype(jnp.float32)
    for i, (a, b) in enumerate(zip(torch.autograd.grad(tout, leaves, tg), vjp(jg))):
        assert a.dtype == targs[i].dtype
        _close(a, b, tol, f"gradient of argument {i}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hw,k,stride,padding,bias", [
    (8, 3, 1, "SAME", True),
    (8, 3, 2, "SAME", True),    # padding total 1: lo 0, hi 1
    (7, 3, 2, "SAME", False),   # padding total 2: lo 1, hi 1
    (9, 4, 2, "SAME", True),    # an even kernel: total 3, lo 1, hi 2
    (9, 3, 1, "VALID", True),
    (10, 3, 2, "VALID", False),
])
def test_conv2d_matches_jax(hw, k, stride, padding, bias, dtype):
    rng = np.random.default_rng(hw * 10 + k)
    jx, tx = _arr(rng, (2, hw, hw + 1, 3), dtype)
    jw, tw = _arr(rng, (k, k, 3, 5), dtype, 0.4)
    jb, tb = _arr(rng, (5,), dtype, 0.2)
    if bias:
        _vjp_check(lambda x, w, b: j_conv2d(x, w, b, stride=stride, padding=padding),
                   lambda x, w, b: conv2d(x, w, b, stride=stride, padding=padding),
                   (jx, jw, jb), (tx, tw, tb), TOL[dtype], vjp_in_f32=dtype == "bfloat16")
    else:
        _vjp_check(lambda x, w: j_conv2d(x, w, stride=stride, padding=padding),
                   lambda x, w: conv2d(x, w, stride=stride, padding=padding),
                   (jx, jw), (tx, tw), TOL[dtype], vjp_in_f32=dtype == "bfloat16")


def test_conv2d_refuses_an_unknown_padding():
    with pytest.raises(ValueError, match="SAME or VALID"):
        conv2d(torch.zeros(1, 4, 4, 1), torch.zeros(3, 3, 1, 1), padding="FULL")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["max", "avg"])
@pytest.mark.parametrize("window,stride", [(2, None), (3, 2), (2, 1)])
def test_pools_match_jax(kind, window, stride, dtype):
    rng = np.random.default_rng(window * 7 + (stride or 0))
    jx, tx = _arr(rng, (2, 9, 8, 4), dtype)
    jfn, tfn = (j_max_pool2d, max_pool2d) if kind == "max" else (j_avg_pool2d, avg_pool2d)
    tol = TOL[dtype] if kind == "avg" else 0.0
    _vjp_check(lambda x: jfn(x, window, stride), lambda x: tfn(x, window, stride), (jx,),
               (tx,), tol)


@pytest.mark.parametrize("window,stride", [(2, None), (3, 1)])
def test_max_pool_gradient_goes_to_the_first_maximum_of_tied_windows(window, stride):
    # A conv + GELU over the synthetic digits' zero background ties whole
    # windows; here integer values in 0..2 tie most windows, several ways.
    x = np.random.default_rng(11).integers(0, 3, (2, 8, 8, 3)).astype(np.float32)
    g = np.random.default_rng(12).standard_normal(
        (2, (8 - window) // (stride or window) + 1, (8 - window) // (stride or window) + 1, 3)
    ).astype(np.float32)
    _, vjp = jax.vjp(lambda a: j_max_pool2d(a, window, stride), jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_()
    (got,) = torch.autograd.grad(max_pool2d(tx, window, stride), tx, torch.from_numpy(g))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # Where a window holds its maximum more than once, one element takes it all.
    assert (got != 0).sum() < tx.numel()


def _jax_cnn(cfg_kw, seed=0, batch=4):
    module = JCNN(JCNNConfig(**cfg_kw))
    return module, module.init(jax.random.key(seed), (batch, 784))


def _bridged(jparams):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")


def _by_path(tree):
    return {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_cnn_params_tree_and_logits_match_jax():
    cfg = dict(conv_channels=(8, 16), hidden_dim=32)
    jmodule, jparams = _jax_cnn(cfg)
    module = CNNClassifier(CNNClassifierConfig(**cfg))
    own = module.init(_gen(), (4, 784), device="cpu")
    jshapes = {k: (tuple(v.shape), str(v.dtype)) for k, v in _by_path(jparams).items()}
    tshapes = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
               for k, v in _by_path(own).items()}
    assert tshapes == jshapes
    assert [n for n, _ in module.children()] == [n for n, _ in jmodule.children()]
    assert module.config.to_dict() == jmodule.config.to_dict()
    tparams = _bridged(jparams)
    assert module.parameter_count(tparams) == jmodule.parameter_count(jparams)
    x = synthetic_mnist(n=6, seed=1)[0]
    _close(module.apply(tparams, torch.from_numpy(x)), jmodule.apply(jparams, jnp.asarray(x)),
           1e-5)


def test_cnn_model_train_step_matches_jax():
    cfg = dict(conv_channels=(8, 16), hidden_dim=32)
    lr = 1e-3
    jmodel = JModel(JCNN(JCNNConfig(**cfg)), JAdamW(JAdamWConfig(learning_rate=lr)),
                    JModelConfig(epochs=1, verbose=False, prefetch_depth=0))
    jmodel.build(jax.random.key(0), (16, 784))
    tmodel = Model(CNNClassifier(CNNClassifierConfig(**cfg)),
                   AdamW(AdamWConfig(learning_rate=lr)), ModelConfig(epochs=1, verbose=False),
                   device="cpu")
    tmodel.params = _bridged(jmodel.params)
    tmodel.opt_state = tmodel.optimizer.init(tmodel.params)
    tmodel._compile()
    x, y = synthetic_mnist(n=16, seed=2)

    def jloss(p):
        return jmodel._loss_fn(jmodel.module, p, jnp.asarray(x), jnp.asarray(y))

    jl, jg = jax.value_and_grad(jloss)(jmodel.params)
    tl, tg = tmodel._value_and_grad(tmodel.params, torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    jflat, tflat = _by_path(jg), _by_path(tg)
    assert set(jflat) == set(tflat) and len(tflat) == 8
    for path, want in jflat.items():
        _close(tflat[path], want, 1e-4, path)

    jp, js, jl2 = jmodel._train_step(jmodel.params, jmodel.opt_state, jnp.asarray(x),
                                     jnp.asarray(y))
    tp, ts, tl2 = tmodel._train_step(tmodel.params, tmodel.opt_state, torch.from_numpy(x),
                                     torch.from_numpy(y))
    np.testing.assert_allclose(float(tl2), float(jl2), rtol=1e-5)
    assert ts.step == int(js.step) == 1
    mflat, tpflat = _by_path(js.m), _by_path(tp)
    for path, want in _by_path(jp).items():
        d = np.abs(_np(tpflat[path]) - _np(want))
        m = np.abs(_np(mflat[path]))
        assert d.max() <= 2 * lr * 1.01, path
        signal = m > 1e-3 * m.max()
        assert (d[signal] <= 1e-6).all(), path


def test_cnn_trains_through_model_on_the_synthetic_digits():
    # test_learns_synthetic_digits's run (21 full-batch steps over 256
    # samples) through Model.train: one step an epoch.
    from mila_tpu_torch.data import ArrayReader

    model = Model(CNNClassifier(CNNClassifierConfig(conv_channels=(8,), hidden_dim=32)),
                  AdamW(AdamWConfig(learning_rate=2e-3)),
                  ModelConfig(epochs=21, verbose=False), device="cpu")
    model.build(0, (256, 784))
    hist = model.train(ArrayReader(*synthetic_mnist(n=256, seed=0), batch_size=256, seed=0))
    assert len(hist.train_losses) == 21
    assert hist.train_losses[-1] < 0.5 * hist.train_losses[0]


def test_cnn_registers_as_a_model_and_exports_as_a_sequential(tmp_path):
    # Both packages write the same archive for the CNN (a Sequential spec;
    # CNNClassifier is not in the archive's model table), and neither
    # rebuilds it: the spec's first entry is the reshape Lambda.
    assert model_registry.get("CNNClassifier") is CNNClassifier
    cfg = dict(conv_channels=(4, 8), hidden_dim=16)
    jmodule, jparams = _jax_cnn(cfg)
    a, b = tmp_path / "jax.mila", tmp_path / "port.mila"
    j_export_model(a, jmodule, jparams)
    export_model(b, CNNClassifier(CNNClassifierConfig(**cfg)), _bridged(jparams))
    with zipfile.ZipFile(a) as za, zipfile.ZipFile(b) as zb:
        assert za.namelist() == zb.namelist()
        for name in za.namelist():
            assert za.read(name) == zb.read(name), name
        assert b'"type": "Lambda"' in zb.read("model/architecture.json")
    for path in (a, b):
        with pytest.raises(KeyError, match="no component named 'Lambda'"):
            j_load_exported(path)
        with pytest.raises(KeyError, match="no component named 'Lambda'"):
            load_exported(path, device="cpu")
