"""The training slice against the JAX package: a tiny GPT-2 (L 2, C 128,
NH 2, T 128, vocab 256) with parameters bridged from JAX's init, its
logits, loss and every gradient leaf against ``jax.grad`` (impl "xla" and
"flash"), ``Model.train`` for three steps in f32 against JAX's
``Model.train`` on the same ``ArrayReader``, and one bf16 step with
stochastic rounding.

JAX's flash kernels run in interpret mode on the CPU; the port's CPU path
runs their plain versions. Tolerances: f32 logits and gradients differ by
summation order through two layers: 1e-4 of each tensor's largest value
(2e-4 for the loss-scaled gradients of the flash route, whose JAX side sums
in 128-key tiles). AdamW's first steps move each weight by about lr *
sign(g), the same on both sides wherever |g| stands above rounding noise;
where it does not, the two sides may step opposite ways, 2 lr apart per
step (``_params_agree``). So after three f32 steps every param is within 6
lr of JAX's, and where the gradient is above noise (|m| above 1e-4 of its
leaf's max) at most 0.1 % of the elements are more than 2e-5 off. In bf16
the logits and gradients are one bf16 rounding apart at each op (2e-2 of
the largest value, gradients 3e-2: the backward chains more roundings);
after one step m (0.1 g) and v (0.001 g^2) follow the gradients (6e-2),
and the masters are held like the f32 params, with the noise floor at 3e-2
of a leaf's max |m| and 1e-3 lr for the rest.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mila_tpu.data.loader import ArrayReader as JReader
from mila_tpu.models.gpt2 import GPT2 as JGPT2
from mila_tpu.models.gpt2 import GPT2Config as JConfig
from mila_tpu.models.model import Model as JModel
from mila_tpu.models.model import ModelConfig as JModelConfig
from mila_tpu.ops import softmax_cross_entropy as j_ce
from mila_tpu.optim import AdamW as JAdamW
from mila_tpu.optim import AdamWConfig as JAdamWConfig
from mila_tpu_torch import kernels
from mila_tpu_torch.bridge import params_from_jax
from mila_tpu_torch.data.loader import ArrayReader
from mila_tpu_torch.models.gpt2 import GPT2, GPT2Config
from mila_tpu_torch.models.model import Model, ModelConfig
from mila_tpu_torch.ops import softmax_cross_entropy
from mila_tpu_torch.optim import AdamW, AdamWConfig
from mila_tpu_torch.utils.tree import tree_leaves, tree_unflatten

TINY = dict(vocab_size=256, max_seq_len=128, num_layers=2, num_heads=2, embedding_dim=128)


def _cfgs(dtype, impl):
    kw = dict(TINY, param_dtype=dtype, attention_impl=impl)
    return JConfig(**kw), GPT2Config(**kw)


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


def _tokens(seed, n, T=128, V=256):
    x = np.random.default_rng(seed).integers(0, V, (n, T + 1)).astype(np.int32)
    return x[:, :-1], x[:, 1:]


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gpt2_logits_loss_and_grads_match_jax(impl, dtype):
    jcfg, tcfg = _cfgs(dtype, impl)
    jm, tm = JGPT2(jcfg), GPT2(tcfg)
    jp = jm.init(jax.random.key(0), (2, 128))
    tp = _bridge(jp)
    assert tm.parameter_count(tp) == jm.parameter_count(jp)
    x, y = _tokens(1, 2)

    def jloss(p):
        return j_ce(jm.apply(p, jnp.asarray(x), training=True), jnp.asarray(y)).mean()

    jl, jg = jax.value_and_grad(jloss)(jp)
    jlogits = jm.apply(jp, jnp.asarray(x))
    leaves = [p.clone().requires_grad_() for p in tree_leaves(tp)]
    params = tree_unflatten(tp, leaves)
    logits = tm.apply(params, torch.from_numpy(x), training=True)
    tl = softmax_cross_entropy(logits, torch.from_numpy(y)).mean()
    tg = tree_unflatten(tp, list(torch.autograd.grad(tl, leaves)))
    tol = 1e-4 if dtype == "float32" else 2e-2
    want = _np32(jlogits)
    assert logits.dtype == tree_leaves(tp)[0].dtype
    np.testing.assert_allclose(_np32(logits), want, rtol=0, atol=tol * np.abs(want).max())
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=tol / 10)
    gtol = (2e-4 if impl == "flash" else 1e-4) if dtype == "float32" else 3e-2
    jflat, tflat = _by_path(jg), _by_path(tg)
    assert set(jflat) == set(tflat) and len(tflat) == 2 + 12 * 2 + 2
    for path, want in jflat.items():
        got = tflat[path]
        assert got.dtype == tree_leaves(tp)[0].dtype or got.dtype == torch.float32
        want = _np32(want)
        np.testing.assert_allclose(_np32(got), want, rtol=0, atol=gtol * np.abs(want).max(),
                                   err_msg=path)


def _models(dtype, impl, sr, lr, epochs=1):
    jcfg, tcfg = _cfgs(dtype, impl)
    ocfg = dict(learning_rate=lr, weight_decay=0.1, stochastic_rounding=sr, grad_clip_norm=1.0)
    jmodel = JModel(JGPT2(jcfg), JAdamW(JAdamWConfig(**ocfg)),
                    JModelConfig(epochs=epochs, verbose=False, prefetch_depth=0))
    jmodel.build(jax.random.key(0), (2, 128))
    tmodel = Model(GPT2(tcfg), AdamW(AdamWConfig(**ocfg)),
                   ModelConfig(epochs=epochs, verbose=False), device="cpu")
    tmodel.params = _bridge(jmodel.params)
    tmodel.opt_state = tmodel.optimizer.init(tmodel.params)
    tmodel._compile()
    return jmodel, tmodel


def _params_agree(jtree, ttree, jm, *, steps, lr, atol, noise):
    """Every param within 2 lr per step of JAX's; within ``atol`` wherever
    the gradient stands above rounding noise: |m| (JAX's first moment, a
    running sum of the gradients) above ``noise`` x its leaf's max. Below,
    a gradient whose exact value is 0 (the K third of the qkv bias: softmax
    ignores a shift shared by all keys) is rounding noise on both sides, and
    AdamW moves it by lr * its sign."""
    jflat, tflat, mflat = _by_path(jtree), _by_path(ttree), _by_path(jm)
    for path, want in jflat.items():
        d = np.abs(_np32(tflat[path]) - _np32(want))
        m = np.abs(_np32(mflat[path]))
        assert d.max() <= steps * 2 * lr * 1.01, path
        signal = m > noise * m.max()
        assert (d[signal] > atol).mean() <= 1e-3, path


def test_model_train_three_f32_steps_match_jax():
    jmodel, tmodel = _models("float32", "flash", sr=False, lr=1e-3)
    x, y = _tokens(2, 6)
    jh = jmodel.train(JReader(x, y, 2, seed=3))
    calls = kernels.plain_calls()
    th = tmodel.train(ArrayReader(x, y, 2, seed=3))
    # Per train step: flash forward (with statistics) and backward per layer,
    # CE forward and backward once, the clip's norm and AdamW's step once.
    diff = np.subtract(kernels.plain_calls(), calls)
    names = [f.__name__ for f in kernels.plain_versions()]
    got = {n: int(d) for n, d in zip(names, diff) if d}
    assert got == {"flash_attention_plain": 6, "flash_attention_bwd_plain": 6,
                   "grad_clip_scale_plain": 3, "fused_adamw_step_plain": 3,
                   "fused_softmax_cross_entropy_plain": 3,
                   "fused_softmax_cross_entropy_bwd_plain": 3}
    assert tmodel.opt_state.step == int(jmodel.opt_state.step) == 3
    np.testing.assert_allclose(th.train_losses, jh.train_losses, rtol=1e-5)
    _params_agree(jmodel.params, tmodel.params, jmodel.opt_state.m, steps=3, lr=1e-3,
                  atol=2e-5, noise=1e-4)
    np.testing.assert_allclose(tmodel.evaluate(ArrayReader(x, y, 3, shuffle=False)),
                               jmodel.evaluate(JReader(x, y, 3, shuffle=False)), rtol=1e-5)


def test_model_train_bf16_sr_step_matches_jax_state():
    lr = 1e-3
    jmodel, tmodel = _models("bfloat16", "flash", sr=True, lr=lr)
    x, y = _tokens(4, 2)
    jmodel.train(JReader(x, y, 2, seed=0))
    tmodel.train(ArrayReader(x, y, 2, seed=0))
    js, ts = jmodel.opt_state, tmodel.opt_state
    assert ts.step == 1 and ts.master is not None
    for name, jt, tt in (("m", js.m, ts.m), ("v", js.v, ts.v)):
        jflat, tflat = _by_path(jt), _by_path(tt)
        for path, want in jflat.items():
            want = _np32(want)
            np.testing.assert_allclose(_np32(tflat[path]), want, rtol=0,
                                       atol=6e-2 * np.abs(want).max(), err_msg=name + path)
    _params_agree(js.master, ts.master, js.m, steps=1, lr=lr, atol=1e-3 * lr, noise=3e-2)
    # The stored params are a bf16 rounding of the masters.
    for path, w in _by_path(ts.master).items():
        p = _by_path(tmodel.params)[path]
        bound = np.abs(_np32(w)) * 2 ** -7 + 1e-30
        assert (np.abs(_np32(p) - _np32(w)) <= bound).all(), path


def test_model_checkpoints_and_prefetch_raise_naming_the_gap(tmp_path):
    # The gap this test once named is closed: a checkpoint of the tiny
    # GPT-2 loads back leaf for leaf into a fresh Model, and training
    # through the prefetcher (depth 2, now the default) gives the losses
    # and params of a synchronous run (depth 0) bit for bit.
    x, y = _tokens(5, 4)
    runs = []
    for depth in (0, 2):
        m = Model(GPT2(GPT2Config(**TINY)), AdamW(AdamWConfig(learning_rate=1e-3)),
                  ModelConfig(epochs=1, verbose=False, prefetch_depth=depth), device="cpu")
        m.build(0, (2, 128))
        runs.append((m, m.train(ArrayReader(x, y, 2, seed=1)).train_losses))
    assert ModelConfig().prefetch_depth == 2
    assert runs[0][1] == runs[1][1]
    for a, b in zip(tree_leaves(runs[0][0].params), tree_leaves(runs[1][0].params)):
        assert torch.equal(a, b)
    path = runs[1][0].save_checkpoint(tmp_path / "gpt2.mila", epoch=0)
    fresh = Model(GPT2(GPT2Config(**TINY)), AdamW(AdamWConfig(learning_rate=1e-3)),
                  ModelConfig(epochs=1, verbose=False), device="cpu")
    fresh.load_checkpoint(path)
    assert fresh.opt_state.step == 2
    for tree in ("params", "m", "v"):
        want = runs[1][0].params if tree == "params" else getattr(runs[1][0].opt_state, tree)
        got = fresh.params if tree == "params" else getattr(fresh.opt_state, tree)
        got = _by_path(got)
        for path, a in _by_path(want).items():
            assert torch.equal(a, got[path]), tree + path


def test_grad_accum_equals_one_big_step():
    # grad_accum_steps 2 over a batch of 4 = the mean of two microbatch
    # gradients: the same update as one step on the whole batch (f32).
    cfg = GPT2Config(**dict(TINY, num_layers=1))
    x, y = _tokens(6, 4)
    out = []
    for accum in (1, 2):
        m = Model(GPT2(cfg), AdamW(AdamWConfig(learning_rate=1e-3)),
                  ModelConfig(epochs=1, verbose=False, grad_accum_steps=accum), device="cpu")
        m.build(7, (4, 128))
        p, _, loss = m._train_step(m.params, m.opt_state, torch.from_numpy(x),
                                   torch.from_numpy(y))
        out.append((p, float(loss)))
    np.testing.assert_allclose(out[0][1], out[1][1], rtol=1e-5)
    for a, b in zip(tree_leaves(out[0][0]), tree_leaves(out[1][0])):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=2e-5)


def test_gpt2_config_and_entry_points_default_to_cuda():
    c = GPT2Config.gpt2_124m()
    assert (c.vp, c.num_layers, c.embedding_dim, c.max_seq_len) == (50304, 12, 768, 1024)
    assert GPT2Config.char_lm().vp == JConfig.char_lm().vp
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            Model(GPT2(GPT2Config(**TINY)))


@pytest.mark.parametrize("kind", ["gpt2", "linear", "layer_norm", "residual", "sequential"])
def test_init_without_a_device_means_the_gpu(kind):
    # Every public init resolves device=None to the GPU, as Model does: with
    # no CUDA device it raises resolve_device's error; device="cpu" builds
    # every leaf on the CPU.
    from mila_tpu_torch import nn
    from mila_tpu_torch.utils.rng import generator

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    lin = nn.Linear(nn.LinearConfig(in_features=16, out_features=8))
    module, shape = {
        "gpt2": (GPT2(GPT2Config(**TINY)), (2, 16)),
        "linear": (lin, (4, 16)),
        "layer_norm": (nn.LayerNorm(nn.LayerNormConfig(features=16)), (4, 16)),
        "residual": (nn.Residual(nn.Linear(nn.LinearConfig(in_features=16, out_features=16))),
                     (4, 16)),
        "sequential": (nn.Sequential([("fc", lin), ("sm", nn.Softmax())]), (4, 16)),
    }[kind]
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        module.init(generator(0), shape)
    params = module.init(generator(0), shape, device="cpu")
    leaves = tree_leaves(params)
    assert leaves and all(p.device.type == "cpu" for p in leaves)
