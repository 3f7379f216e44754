"""The MNIST MLP through the port's trainer (mirrors
``tests/models/test_mnist_e2e.py`` and ``tests/models/
test_training_features.py::test_accum_equals_full_batch_sgd`` /
``test_bad_accum_config``), held against the JAX package: the loss over 20
train steps from bridged params on the same batches, one SGD step, the
four ``evaluation`` functions; and within the port, a checkpoint resume and
prefetch depth 2 bit-equal to an uninterrupted synchronous run.

On the synthetic surrogate (no MNIST files here). Tolerances: both sides
compute in f32 (JAX at its highest matmul precision), summing in other
orders: losses within 1e-5 relative, SGD's params and velocities within
1e-6 relative (one step of a linear update), evaluation results within
1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mila_tpu.models import MLPClassifier as JMLP
from mila_tpu.models import MLPClassifierConfig as JMLPConfig
from mila_tpu.models import Model as JModel
from mila_tpu.models import ModelConfig as JModelConfig
from mila_tpu.models import evaluation as jev
from mila_tpu.optim import AdamW as JAdamW
from mila_tpu.optim import AdamWConfig as JAdamWConfig
from mila_tpu.optim import SGD as JSGD
from mila_tpu.optim import SGDConfig as JSGDConfig
from mila_tpu_torch.bridge import params_from_jax, sgd_state_from_jax
from mila_tpu_torch.data import ArrayReader, MnistReader, synthetic_mnist
from mila_tpu_torch.models import (
    MLPClassifier,
    MLPClassifierConfig,
    Model,
    ModelConfig,
    accuracy,
)
from mila_tpu_torch.models import evaluation as tev
from mila_tpu_torch.optim import SGD, AdamW, AdamWConfig, SGDConfig
from mila_tpu_torch.utils.config import ConfigError
from mila_tpu_torch.utils.tree import tree_leaves


def _mnist_model(epochs, **cfg):
    return Model(MLPClassifier(MLPClassifierConfig(name="mnist")),
                 AdamW(AdamWConfig(learning_rate=1e-3)),
                 ModelConfig(name="mnist", epochs=epochs, verbose=False, **cfg), device="cpu")


@pytest.fixture(scope="module")
def trained_model():
    train = MnistReader(batch_size=128, split="train", synthetic_n=4096, seed=0)
    test = MnistReader(batch_size=128, split="test", synthetic_n=1024, shuffle=False,
                       drop_last=False)
    model = _mnist_model(4)
    model.build(0, (128, 784))
    model.train(train)
    return model, test


class TestMnistEndToEnd:
    def test_parameter_count(self, trained_model):
        model, _ = trained_model
        assert model.parameter_count() == 784 * 128 + 128 + 128 * 64 + 64 + 64 * 10 + 10

    def test_loss_decreases(self, trained_model):
        model, _ = trained_model
        h = model.history
        assert len(h.train_losses) == 4
        assert h.train_losses[-1] < h.train_losses[0] * 0.5

    def test_accuracy_target(self, trained_model):
        model, test = trained_model
        xs, ys = [], []
        for xb, yb in test:
            xs.append(model.predict(xb))
            ys.append(yb)
        acc = accuracy(torch.cat(xs), np.concatenate(ys))
        assert acc >= 0.975, f"accuracy {acc:.4f} below 97.5% parity target"

    def test_checkpoint_resume_preserves_behavior(self, trained_model, tmp_path):
        model, test = trained_model
        path = tmp_path / "mnist.mila"
        model.save_checkpoint(path, epoch=3)
        model2 = _mnist_model(1)
        model2.load_checkpoint(path)
        xb, _ = test.next_batch(0)
        torch.testing.assert_close(model2.predict(xb), model.predict(xb), rtol=1e-5, atol=1e-6)
        assert int(model2.opt_state.step) == int(model.opt_state.step)

    def test_evaluate_returns_finite(self, trained_model):
        model, test = trained_model
        loss = model.evaluate(test)
        assert np.isfinite(loss) and loss < 1.0


class TestModelConfigValidation:
    def test_bad_config(self):
        with pytest.raises(ConfigError):
            ModelConfig(epochs=0).validate()
        with pytest.raises(ConfigError):
            ModelConfig(validation_split=1.5).validate()

    def test_train_before_build_raises(self):
        model = Model(MLPClassifier(), device="cpu")
        with pytest.raises(RuntimeError, match="build"):
            model.train(MnistReader(batch_size=8, synthetic_n=64))


class TestEarlyStopping:
    def test_early_stop_triggers(self):
        train = MnistReader(batch_size=64, synthetic_n=256, seed=0)
        val = MnistReader(batch_size=64, split="test", synthetic_n=128, shuffle=False)
        model = Model(MLPClassifier(MLPClassifierConfig()), AdamW(AdamWConfig(learning_rate=1e-3)),
                      ModelConfig(epochs=50, early_stopping_patience=2, verbose=False),
                      device="cpu")
        model.build(1, (64, 784))
        h = model.train(train, val)
        assert len(h.train_losses) < 50


class TestGradAccum:
    def test_accum_equals_full_batch_sgd(self):
        x = np.random.default_rng(0).normal(size=(32, 784)).astype(np.float32)
        y = np.random.default_rng(1).integers(0, 10, 32).astype(np.int32)

        def make(accum):
            m = Model(MLPClassifier(MLPClassifierConfig(hidden_dims=(16,))),
                      config=ModelConfig(epochs=1, verbose=False, grad_accum_steps=accum),
                      device="cpu")
            m.optimizer = SGD(SGDConfig(learning_rate=0.1))
            m.build(0, (32, 784))
            return m

        m1, m4 = make(1), make(4)
        p1, _, l1 = m1._train_step(m1.params, m1.opt_state, torch.from_numpy(x),
                                   torch.from_numpy(y))
        p4, _, l4 = m4._train_step(m4.params, m4.opt_state, torch.from_numpy(x),
                                   torch.from_numpy(y))
        np.testing.assert_allclose(float(l1), float(l4), rtol=1e-5)
        for a, b in zip(tree_leaves(p1), tree_leaves(p4)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-6)

    def test_bad_accum_config(self):
        with pytest.raises(ConfigError):
            ModelConfig(grad_accum_steps=0).validate()


# --------------------------------------------------------------------------
# Against the JAX package
# --------------------------------------------------------------------------

def _jax_mlp(hidden=(128, 64), seed=0):
    module = JMLP(JMLPConfig(hidden_dims=hidden))
    return module, module.init(jax.random.key(seed), (1, 784))


def _bridged(jparams):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")


def test_loss_trajectory_20_steps_matches_jax():
    jmodel = JModel(JMLP(), JAdamW(JAdamWConfig(learning_rate=1e-3)),
                    JModelConfig(epochs=1, verbose=False))
    jmodel.build(jax.random.key(0), (128, 784))
    tmodel = _mnist_model(1)
    tmodel.params = _bridged(jmodel.params)
    tmodel.opt_state = tmodel.optimizer.init(tmodel.params)
    tmodel._compile()
    reader = ArrayReader(*synthetic_mnist(20 * 64, seed=3), batch_size=64, seed=2)
    jp, js, tp, ts = jmodel.params, jmodel.opt_state, tmodel.params, tmodel.opt_state
    jl, tl = [], []
    for x, y in reader:
        jp, js, l_j = jmodel._train_step(jp, js, jnp.asarray(x), jnp.asarray(y))
        tp, ts, l_t = tmodel._train_step(tp, ts, torch.from_numpy(x), torch.from_numpy(y))
        jl.append(float(l_j))
        tl.append(float(l_t))
    assert len(tl) == 20 and tl[-1] < tl[0]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)


@pytest.mark.parametrize("momentum,nesterov,wd", [(0.0, False, 0.0), (0.9, True, 1e-2)])
def test_sgd_step_matches_jax(momentum, nesterov, wd):
    _, jparams = _jax_mlp((32,))
    rng = np.random.default_rng(4)
    jgrads = jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape).astype(np.float32)), jparams)
    cfg = dict(learning_rate=0.05, momentum=momentum, nesterov=nesterov, weight_decay=wd)
    jopt, topt = JSGD(JSGDConfig(**cfg)), SGD(SGDConfig(**cfg))
    js = jopt.init(jparams)
    jp, js = jopt.step(js, jparams, jgrads)  # a non-zero velocity to start from
    tp, ts = _bridged(jp), sgd_state_from_jax(jax.tree_util.tree_map(np.asarray, js), "cpu")
    jp, js = jopt.step(js, jp, jgrads)
    tp, ts = topt.step(ts, tp, _bridged(jgrads))
    assert ts.step == int(js.step) == 2
    for want, got in ((jp, tp), (js.velocity, ts.velocity)):
        for w, g in zip(jax.tree_util.tree_leaves(want), tree_leaves(got)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


def test_evaluation_functions_match_jax():
    jmodule, jparams = _jax_mlp()
    tmodule, tparams = MLPClassifier(), _bridged(jparams)
    x, y = synthetic_mnist(256, seed=5)
    batches = lambda: ArrayReader(x, y, 64, shuffle=False)  # noqa: E731
    noisy = jax.tree_util.tree_map(lambda p: p * 1.5, jparams)
    pairs = [
        (tev.dataset_loss(tmodule, tparams, batches()),
         jev.dataset_loss(jmodule, jparams, batches())),
        (tev.perplexity(tmodule, tparams, batches(), max_batches=3),
         jev.perplexity(jmodule, jparams, batches(), max_batches=3)),
        (tev.top1_accuracy(tmodule, tparams, batches()),
         jev.top1_accuracy(jmodule, jparams, batches())),
    ]
    td = tev.perplexity_delta(tmodule, tparams, _bridged(noisy), batches, max_batches=2)
    jd = jev.perplexity_delta(jmodule, jparams, noisy, batches, max_batches=2)
    pairs += [(td[k], jd[k]) for k in ("ppl_ref", "ppl_test", "delta", "rel_delta")]
    for got, want in pairs:
        np.testing.assert_allclose(got, want, rtol=1e-5)
    with pytest.raises(ValueError, match="no batches"):
        tev.dataset_loss(tmodule, tparams, [])


# --------------------------------------------------------------------------
# Within the port: resume and prefetch, bit for bit
# --------------------------------------------------------------------------

def _run(epochs, depth=2, **cfg):
    m = _mnist_model(epochs, prefetch_depth=depth, **cfg)
    m.build(0, (128, 784))
    return m


def _train_reader():
    return MnistReader(batch_size=128, split="train", synthetic_n=2048, seed=0)


def test_resume_is_bit_equal_to_straight_training(tmp_path):
    straight = _run(4)
    straight.train(_train_reader())
    first = _run(2, checkpoint_dir=str(tmp_path), checkpoint_frequency=2)
    first.train(_train_reader())  # writes mnist_epoch0001.mila
    resumed = _run(2, checkpoint_dir=str(tmp_path))
    resumed.resume_training(_train_reader())
    assert resumed.opt_state.step == straight.opt_state.step == 64
    assert resumed.history.train_losses == straight.history.train_losses
    for part in ("params", "m", "v"):
        a = straight.params if part == "params" else getattr(straight.opt_state, part)
        b = resumed.params if part == "params" else getattr(resumed.opt_state, part)
        for x, y in zip(tree_leaves(a), tree_leaves(b)):
            assert torch.equal(x, y), part
    xb, _ = _train_reader().next_batch(0)
    assert torch.equal(straight.predict(xb), resumed.predict(xb))


def test_prefetch_depth_2_is_bit_equal_to_depth_0():
    runs = [_run(2, depth=d) for d in (0, 2)]
    for m in runs:
        m.train(_train_reader())
    assert runs[0].history.train_losses == runs[1].history.train_losses
    for x, y in zip(tree_leaves(runs[0].params), tree_leaves(runs[1].params)):
        assert torch.equal(x, y)
