"""Llama trained through ``Model`` in the port, against the JAX package, at
``LlamaConfig.tiny`` (2 layers, H 128, FFN 256, NH 4 / NKV 2, vocab 512,
T 128): the params tree ``Llama.init`` builds (names, shapes, dtypes),
``apply(training=True)``, ``rms_norm``'s and ``swiglu``'s gradients at the
block's shapes against JAX's custom VJPs, the loss and every gradient leaf
of one step against ``jax.value_and_grad`` of JAX's ``Model`` loss (the
plain product; the flash route at NH 2 / NKV 1, D 64, where JAX's kernel
runs in interpret mode and the port's plain twins; bf16), three f32 AdamW
steps through ``Model.train`` against JAX's, one bf16 step with
stochastic rounding onto f32 masters, a save and resume bit-equal to a run
straight through, a JAX-written Llama checkpoint resumed in the port, and
an exported Llama loaded in both packages.

Tolerances, of each tensor's largest magnitude: f32 logits and gradients
1e-4 (f32 sums in other orders through two layers; 2e-4 for the flash
route's gradients, whose JAX side sums keys in tiles), the loss 1e-5
relative. bf16: the logits 2e-2 and the gradients 3e-2 (one bf16 rounding
apart at each op, more in the backward's chain), the loss 2e-3 relative.
The gradient ops alone at the block's shapes: f32 1e-5, bf16 2^-6 (both
round once from f32). After AdamW each param moves by about lr * sign(g)
on both sides where |g| stands above rounding noise; where it does not,
the sides may step opposite ways, 2 lr apart a step. So after three f32
steps every param is within 6 lr of JAX's, and where |m| is above 1e-4 of
its leaf's max at most 0.1 % of the elements are more than 2e-5 off; after
one bf16 step the masters are held the same way with the noise floor at
3e-2 of a leaf's max |m| and 1e-3 lr. A checkpoint resumed from JAX: the
losses 1e-5 relative, the params 1e-5 of each leaf's max; within the port
a resume is bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mila_tpu.ops as jops
from mila_tpu.data.loader import ArrayReader as JReader
from mila_tpu.models.export import export_model as j_export_model
from mila_tpu.models.export import load_exported as j_load_exported
from mila_tpu.models.llama import Llama as JLlama
from mila_tpu.models.llama import LlamaConfig as JConfig
from mila_tpu.models.model import Model as JModel
from mila_tpu.models.model import ModelConfig as JModelConfig
from mila_tpu.optim import AdamW as JAdamW
from mila_tpu.optim import AdamWConfig as JAdamWConfig
from mila_tpu_torch import kernels, ops
from mila_tpu_torch.bridge import params_from_jax
from mila_tpu_torch.data.loader import ArrayReader
from mila_tpu_torch.models.export import export_model, load_exported
from mila_tpu_torch.models.llama import Llama, LlamaBlock, LlamaConfig
from mila_tpu_torch.models.model import Model, ModelConfig
from mila_tpu_torch.nn.module import CompositeModule
from mila_tpu_torch.optim import AdamW, AdamWConfig
from mila_tpu_torch.utils.tree import tree_leaves

B, T = 2, 128
# The flash route needs D % 64 == 0: the tiny widths at 2 heads over 1.
FLASH = dict(num_heads=2, num_kv_heads=1)


def _cfgs(dtype="float32", impl="xla", **kw):
    kw = dict(param_dtype=dtype, attention_impl=impl, **kw)
    return JConfig.tiny().replace(**kw), LlamaConfig.tiny().replace(**kw)


def _bridge(jtree):
    """JAX params -> the port's, each leaf in its JAX dtype."""
    np_tree = jax.tree_util.tree_map(
        lambda a: np.asarray(a.astype(jnp.float32)) if a.dtype == jnp.bfloat16 else np.asarray(a),
        jtree)
    out = params_from_jax(np_tree, device="cpu")
    return jax.tree_util.tree_map(
        lambda t, a: t.to(torch.bfloat16) if a.dtype == jnp.bfloat16 else t, out, jtree)


def _by_path(tree):
    return {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _tokens(seed, n, V=512):
    x = np.random.default_rng(seed).integers(0, V, (n, T + 1)).astype(np.int32)
    return x[:, :-1], x[:, 1:]


def _assert_trees_close(got, want, tol, what=""):
    gflat, wflat = _by_path(got), _by_path(want)
    assert set(gflat) == set(wflat)
    for path, w in wflat.items():
        w = _np32(w)
        np.testing.assert_allclose(_np32(gflat[path]), w, rtol=0,
                                   atol=tol * max(np.abs(w).max(), 1e-30), err_msg=what + path)


@pytest.mark.parametrize("dtype,tied", [("float32", True), ("bfloat16", True),
                                        ("float32", False)])
def test_params_tree_equals_jax_init(dtype, tied):
    jcfg, tcfg = _cfgs(dtype, tie_embeddings=tied)
    jmodel, tmodel = JLlama(jcfg), Llama(tcfg, device="cpu")
    assert isinstance(tmodel, CompositeModule) and isinstance(tmodel.get("h0"), LlamaBlock)
    assert [n for n, _ in tmodel.children()] == [n for n, _ in jmodel.children()]
    assert ([n for n, _ in tmodel.get("h1").children()]
            == [n for n, _ in jmodel.get("h1").children()])
    jp = jmodel.init(jax.random.key(0), (B, T))
    tp = tmodel.init(torch.Generator().manual_seed(0), (B, T))
    jmeta = {k: (tuple(v.shape), str(v.dtype)) for k, v in _by_path(jp).items()}
    tmeta = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
             for k, v in _by_path(tp).items()}
    assert tmeta == jmeta
    assert tmodel.parameter_count(tp) == jmodel.parameter_count(jp)
    assert tmodel.output_shape((B, T)) == jmodel.output_shape((B, T)) == (B, T, 512)
    assert tmodel.get("h0").output_shape((B, T, 128)) == (B, T, 128)
    w = tp["h0"]["wq"]["weight"].float()
    assert abs(float(w.std()) - 0.02) < 0.002 and float(tp["norm_f"]["gamma"].min()) == 1.0


def test_build_draws_on_the_generator_given():
    # An int seed is a CPU generator seeded with it; a generator is used as
    # given (one on the card draws the weights there).
    tcfg = _cfgs()[1]
    a = Model(Llama(tcfg, device="cpu"), device="cpu")
    b = Model(Llama(tcfg, device="cpu"), device="cpu")
    a.build(3, (B, T))
    b.build(torch.Generator().manual_seed(3), (B, T))
    assert len(tree_leaves(a.params)) == 2 + 9 * tcfg.num_layers
    for x, y in zip(tree_leaves(a.params), tree_leaves(b.params)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_training_matches_jax(dtype):
    jcfg, tcfg = _cfgs(dtype)
    jmodel, tmodel = JLlama(jcfg), Llama(tcfg, device="cpu")
    jp = jmodel.init(jax.random.key(1), (B, T))
    x, _ = _tokens(1, B)
    want = _np32(jmodel.apply(jp, jnp.asarray(x), training=True))
    got = tmodel.apply(_bridge(jp), torch.from_numpy(x), training=True)
    assert got.dtype == getattr(torch, dtype) and got.shape == (B, T, 512)
    tol = 1e-4 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_np32(got), want, rtol=0, atol=tol * np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_and_swiglu_vjps_at_the_block_shapes(dtype):
    rng = np.random.default_rng(2)
    vals = [rng.standard_normal(s).astype(np.float32) for s in ((B, T, 128), (128,),
                                                                 (B, T, 256), (B, T, 256))]
    j = [jnp.asarray(v).astype(dtype) for v in vals]
    t = [torch.from_numpy(v).to(getattr(torch, dtype)) for v in vals]
    tol = 1e-5 if dtype == "float32" else 2.0 ** -6
    cases = ((lambda a, b: jops.rms_norm(a, b, 1e-5), lambda a, b: ops.rms_norm(a, b, 1e-5),
              (0, 1)), (jops.swiglu, ops.swiglu, (2, 3)))
    for jfn, tfn, idx in cases:
        jout, vjp = jax.vjp(jfn, *[j[i] for i in idx])
        leaves = [t[i].clone().requires_grad_() for i in idx]
        tout = tfn(*leaves)
        g = rng.standard_normal(tout.shape).astype(np.float32)
        jg = vjp(jnp.asarray(g).astype(dtype))
        tg = torch.autograd.grad(tout, leaves, torch.from_numpy(g).to(tout.dtype))
        for a, b in zip((tout, *tg), (jout, *jg)):
            b = _np32(b)
            np.testing.assert_allclose(_np32(a), b, rtol=0, atol=tol * np.abs(b).max())


def _models(dtype="float32", impl="xla", sr=False, lr=1e-3, epochs=1, **cfg_kw):
    jcfg, tcfg = _cfgs(dtype, impl, **cfg_kw)
    ocfg = dict(learning_rate=lr, weight_decay=0.1, stochastic_rounding=sr, grad_clip_norm=1.0)
    jmodel = JModel(JLlama(jcfg), JAdamW(JAdamWConfig(**ocfg)),
                    JModelConfig(epochs=epochs, verbose=False, prefetch_depth=0))
    jmodel.build(jax.random.key(0), (B, T))
    tmodel = Model(Llama(tcfg, device="cpu"), AdamW(AdamWConfig(**ocfg)),
                   ModelConfig(epochs=epochs, verbose=False), device="cpu")
    tmodel.params = _bridge(jmodel.params)
    tmodel.opt_state = tmodel.optimizer.init(tmodel.params)
    tmodel._compile()
    return jmodel, tmodel


@pytest.mark.parametrize("dtype,impl", [("float32", "xla"), ("float32", "flash"),
                                        ("bfloat16", "xla")])
def test_loss_and_every_gradient_leaf_match_jax_model(dtype, impl):
    jmodel, tmodel = _models(dtype, impl, **(FLASH if impl == "flash" else {}))
    x, y = _tokens(3, B)

    def jloss(p):
        return jmodel._loss_fn(jmodel.module, p, jnp.asarray(x), jnp.asarray(y))

    jl, jg = jax.value_and_grad(jloss)(jmodel.params)
    calls = kernels.plain_calls()
    tl, tg = tmodel._value_and_grad(tmodel.params, torch.from_numpy(x), torch.from_numpy(y))
    names = [f.__name__ for f in kernels.plain_versions()]
    ran = {n for n, d in zip(names, np.subtract(kernels.plain_calls(), calls)) if d}
    want_ran = {"fused_softmax_cross_entropy_plain", "fused_softmax_cross_entropy_bwd_plain"}
    if impl == "flash":
        want_ran |= {"flash_attention_plain", "flash_attention_bwd_plain"}
    assert ran == want_ran
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5 if dtype == "float32" else 2e-3)
    gtol = (2e-4 if impl == "flash" else 1e-4) if dtype == "float32" else 3e-2
    assert len(_by_path(tg)) == 2 + 9 * 2
    for path, g in _by_path(tg).items():
        assert g.dtype == getattr(torch, dtype), path
    _assert_trees_close(tg, jg, gtol)


def _params_agree(jtree, ttree, jm, *, steps, lr, atol, noise):
    """Every param within 2 lr a step of JAX's; within ``atol`` where |m|
    (JAX's first moment) is above ``noise`` x its leaf's max, for all but
    0.1 % of those elements."""
    jflat, tflat, mflat = _by_path(jtree), _by_path(ttree), _by_path(jm)
    for path, want in jflat.items():
        d = np.abs(_np32(tflat[path]) - _np32(want))
        m = np.abs(_np32(mflat[path]))
        assert d.max() <= steps * 2 * lr * 1.01, path
        signal = m > noise * m.max()
        assert (d[signal] > atol).mean() <= 1e-3, path


def test_model_train_three_f32_steps_match_jax():
    jmodel, tmodel = _models()
    x, y = _tokens(4, 3 * B)
    jh = jmodel.train(JReader(x, y, B, seed=3))
    th = tmodel.train(ArrayReader(x, y, B, seed=3))
    assert tmodel.opt_state.step == int(jmodel.opt_state.step) == 3
    np.testing.assert_allclose(th.train_losses, jh.train_losses, rtol=1e-5)
    _params_agree(jmodel.params, tmodel.params, jmodel.opt_state.m, steps=3, lr=1e-3,
                  atol=2e-5, noise=1e-4)


def test_model_train_bf16_sr_step_matches_jax_state():
    lr = 1e-3
    jmodel, tmodel = _models("bfloat16", sr=True, lr=lr)
    x, y = _tokens(5, B)
    jmodel.train(JReader(x, y, B, seed=0))
    tmodel.train(ArrayReader(x, y, B, seed=0))
    js, ts = jmodel.opt_state, tmodel.opt_state
    assert ts.step == 1 and ts.master is not None
    for name, jt, tt in (("m", js.m, ts.m), ("v", js.v, ts.v)):
        _assert_trees_close(tt, jt, 6e-2, name)
    _params_agree(js.master, ts.master, js.m, steps=1, lr=lr, atol=1e-3 * lr, noise=3e-2)
    for path, w in _by_path(ts.master).items():
        p = _by_path(tmodel.params)[path]
        assert p.dtype == torch.bfloat16
        bound = np.abs(_np32(w)) * 2 ** -7 + 1e-30
        assert (np.abs(_np32(p) - _np32(w)) <= bound).all(), path


def _port_model(epochs, **cfg):
    return Model(Llama(_cfgs("bfloat16")[1], device="cpu"),
                 AdamW(AdamWConfig(learning_rate=1e-3, stochastic_rounding=True,
                                   grad_clip_norm=1.0)),
                 ModelConfig(name="llama", epochs=epochs, verbose=False, **cfg), device="cpu")


def test_resume_is_bit_equal_to_straight_training(tmp_path):
    x, y = _tokens(6, 2 * B)
    straight = _port_model(2)
    straight.build(0, (B, T))
    straight.train(ArrayReader(x, y, B, seed=1))
    first = _port_model(1, checkpoint_dir=str(tmp_path), checkpoint_frequency=1)
    first.build(0, (B, T))
    first.train(ArrayReader(x, y, B, seed=1))
    resumed = _port_model(1, checkpoint_dir=str(tmp_path))
    resumed.build(1, (B, T))  # another init: every leaf must come from the file
    resumed.resume_training(ArrayReader(x, y, B, seed=1))
    assert resumed.opt_state.step == straight.opt_state.step == 4
    assert resumed.history.train_losses == straight.history.train_losses
    for part in ("params", "m", "v", "master"):
        a = straight.params if part == "params" else getattr(straight.opt_state, part)
        b = resumed.params if part == "params" else getattr(resumed.opt_state, part)
        for u, w in zip(tree_leaves(a), tree_leaves(b)):
            assert u.dtype == w.dtype and torch.equal(u, w), part


class _EpochShifted:
    """A JAX reader whose epoch ``e`` is the inner reader's ``e + by``: JAX's
    resume_training counts epochs from 0, the port's from the checkpoint's."""

    def __init__(self, inner, by):
        self.inner, self.by = inner, by

    def reset(self, epoch=None):
        self.inner.reset(epoch + self.by)

    def __iter__(self):
        return iter(self.inner)

    def __len__(self):
        return len(self.inner)


def test_jax_llama_checkpoint_resumes_in_the_port(tmp_path):
    jcfg, tcfg = _cfgs()
    x, y = _tokens(7, 2 * B)

    def jmodel():
        return JModel(JLlama(jcfg), JAdamW(JAdamWConfig(learning_rate=1e-3)),
                      JModelConfig(name="llama", epochs=1, verbose=False,
                                   checkpoint_dir=str(tmp_path), prefetch_depth=0))

    first = jmodel()
    first.build(jax.random.key(0), (B, T))
    first.train(JReader(x, y, B, seed=2))
    first.save_checkpoint(epoch=0)
    jax_resumed = jmodel()
    jax_resumed.resume_training(_EpochShifted(JReader(x, y, B, seed=2), 1))

    port = Model(Llama(tcfg, device="cpu"), AdamW(AdamWConfig(learning_rate=1e-3)),
                 ModelConfig(name="llama", epochs=1, verbose=False,
                             checkpoint_dir=str(tmp_path)), device="cpu")
    port.build(1, (B, T))
    port.resume_training(ArrayReader(x, y, B, seed=2))
    assert port.opt_state.step == int(jax_resumed.opt_state.step) == 4
    np.testing.assert_allclose(port.history.train_losses, jax_resumed.history.train_losses,
                               rtol=1e-5)
    _assert_trees_close(port.params, jax_resumed.params, 1e-5)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_exported_llama_loads_in_both_packages(tmp_path, writer):
    jcfg, tcfg = _cfgs()
    jmodel = JLlama(jcfg)
    jp = jmodel.init(jax.random.key(4), (1, 16))
    path = tmp_path / f"{writer}.mila"
    if writer == "jax":
        j_export_model(path, jmodel, jp)
    else:
        export_model(path, Llama(tcfg, device="cpu"), _bridge(jp))
    toks = np.array([[1, 7, 300, 42, 9]], np.int32)
    tmod, tp = load_exported(path, device="cpu")
    jmod, jp2 = j_load_exported(path)
    assert isinstance(tmod, Llama) and type(jmod).__name__ == "Llama"
    assert tmod.config.to_dict() == jmod.config.to_dict() == jcfg.to_dict()
    _assert_trees_close(tp, jp, 0.0)
    _assert_trees_close(_bridge(jp2), jp, 0.0)
    want = _np32(jmod.apply(jp2, jnp.asarray(toks)))
    np.testing.assert_allclose(_np32(tmod.apply(tp, torch.from_numpy(toks))), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
