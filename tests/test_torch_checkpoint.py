"""The port's model archive and checkpoints (mirrors
``tests/serialization/test_checkpoint.py``), and files passed between the
two packages: each reads what the other writes, blob for blob, for params
and AdamW state in f32, bf16, fp16, fp8 and integer dtypes, for the GPT-2
tree and for a tree holding a list; and a checkpoint the JAX trainer wrote
for the MNIST MLP resumes in the port where JAX resumes it.

Tolerances: archives move bytes, so every leaf read back is bit-equal. The
resumed MLP: 2 epochs of AdamW (16 steps) on both sides from the same file
and the same batches; both compute in f32 (JAX at its highest matmul
precision), so the params agree within 1e-5 of each leaf's largest value.
"""

import zipfile

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from mila_tpu.data import MnistReader as JMnistReader
from mila_tpu.models import MLPClassifier as JMLP
from mila_tpu.models import MLPClassifierConfig as JMLPConfig
from mila_tpu.models import Model as JModel
from mila_tpu.models import ModelConfig as JModelConfig
from mila_tpu.models.gpt2 import GPT2 as JGPT2
from mila_tpu.models.gpt2 import GPT2Config as JGPT2Config
from mila_tpu.optim import AdamW as JAdamW
from mila_tpu.optim import AdamWConfig as JAdamWConfig
from mila_tpu.serialization import ModelArchive as JArchive
from mila_tpu.serialization import OpenMode as JOpenMode
from mila_tpu.serialization import load_checkpoint as j_load_checkpoint
from mila_tpu.serialization import save_checkpoint as j_save_checkpoint
from mila_tpu_torch.bridge import adamw_state_from_jax, params_from_jax
from mila_tpu_torch.data import MnistReader
from mila_tpu_torch.models import MLPClassifier, MLPClassifierConfig, Model, ModelConfig
from mila_tpu_torch.optim import AdamW, AdamWConfig
from mila_tpu_torch.optim.adamw import AdamWState
from mila_tpu_torch.serialization import (
    CheckpointMetadata,
    ModelArchive,
    OpenMode,
    find_latest_checkpoint,
    generate_checkpoint_filename,
    load_checkpoint,
    restore_tree,
    save_checkpoint,
    to_device_tree,
)


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def _np(t):
    """A port tensor as numpy in its own dtype (ml_dtypes for bf16/fp8)."""
    names = {torch.bfloat16: ml_dtypes.bfloat16, torch.float8_e4m3fn: ml_dtypes.float8_e4m3fn,
             torch.float8_e5m2: ml_dtypes.float8_e5m2}
    if t.dtype in names:
        raw = t.reshape(-1).view(torch.uint8).numpy()
        return raw.view(names[t.dtype]).reshape(tuple(t.shape))
    return t.numpy()


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def _assert_bits(got, want):
    """Same dtype name, shape and bytes (numpy arrays of ml_dtypes or plain)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


# --------------------------------------------------------------------------
# Mirrors of tests/serialization/test_checkpoint.py
# --------------------------------------------------------------------------

class TestModelArchive:
    def test_json_round_trip(self, tmp_path):
        p = tmp_path / "a.mila"
        with ModelArchive(p, OpenMode.WRITE) as ar:
            ar.write_json("model/meta.json", {"epoch": 3, "name": "x"})
        with ModelArchive(p) as ar:
            assert ar.read_json("model/meta.json") == {"epoch": 3, "name": "x"}

    def test_tensor_round_trip_dtypes(self, tmp_path):
        p = tmp_path / "t.mila"
        g = _gen(0)
        tensors = {
            "f32": torch.randn(3, 4, generator=g),
            "bf16": torch.randn(8, generator=g).to(torch.bfloat16),
            "i32": torch.arange(6, dtype=torch.int32).reshape(2, 3),
            "i8": torch.tensor([[1, -2], [3, -4]], dtype=torch.int8),
            "scalar": torch.tensor(2.5, dtype=torch.float32),
        }
        with ModelArchive(p, OpenMode.WRITE) as ar:
            for k, v in tensors.items():
                ar.write_tensor(f"tensors/{k}", v)
        with ModelArchive(p) as ar:
            for k, v in tensors.items():
                back = ar.read_tensor(f"tensors/{k}")
                assert back.dtype == v.dtype and back.shape == v.shape
                assert torch.equal(back, v)

    def test_tree_round_trip(self, tmp_path):
        p = tmp_path / "tree.mila"
        g = _gen(1)
        tree = {"fc1": {"weight": torch.randn(4, 8, generator=g), "bias": torch.zeros(8)},
                "ln": {"gamma": torch.ones(8)}}
        with ModelArchive(p, OpenMode.WRITE) as ar:
            ar.write_tree("params", tree)
        with ModelArchive(p) as ar:
            back = ar.read_tree("params")
        assert set(back) == {"fc1", "ln"}
        assert torch.equal(back["fc1"]["weight"], tree["fc1"]["weight"])

    def test_path_normalization_and_escape(self, tmp_path):
        p = tmp_path / "n.mila"
        with ModelArchive(p, OpenMode.WRITE) as ar:
            ar.write_json("a//b/./c.json", 1)
            with pytest.raises(ValueError, match="escapes"):
                ar.write_json("../evil.json", 2)
        with ModelArchive(p) as ar:
            assert ar.read_json("a/b/c.json") == 1
            assert ar.exists("a/b/c.json")
            assert not ar.exists("nope.json")
            assert ar.list("a") == ["a/b/c.json"]


class TestCheckpoint:
    def _params(self, seed=0):
        return {"fc": {"weight": torch.randn(4, 3, generator=_gen(seed)),
                       "bias": torch.zeros(3)}}

    def test_save_load_params_only(self, tmp_path):
        p = tmp_path / "ck.mila"
        params = self._params()
        save_checkpoint(p, params, metadata=CheckpointMetadata(epoch=2, train_loss=0.5))
        data = load_checkpoint(p)
        assert data["meta"]["epoch"] == 2
        assert data["meta"]["framework_version"]
        assert torch.equal(data["params"]["fc"]["weight"], params["fc"]["weight"])
        assert data["optimizer"] is None

    def test_save_load_with_optimizer(self, tmp_path):
        params = self._params()
        opt = AdamW(AdamWConfig(learning_rate=0.01))
        state = opt.init(params)
        params2, state2 = opt.step(state, params, {k: {n: torch.ones_like(t) for n, t in v.items()}
                                                   for k, v in params.items()})
        p = tmp_path / "ck2.mila"
        save_checkpoint(p, params2, opt_state=state2)
        od = to_device_tree(load_checkpoint(p)["optimizer"], device="cpu")
        assert int(od["step"]) == 1 and od["step"].dtype == torch.int32
        torch.testing.assert_close(od["m"]["fc"]["weight"], state2.m["fc"]["weight"], rtol=1e-6,
                                   atol=0)

    def test_filename_and_latest_discovery(self, tmp_path):
        params = self._params()
        for e in (1, 3, 2):
            save_checkpoint(tmp_path / generate_checkpoint_filename("model", e), params,
                            metadata=CheckpointMetadata(epoch=e))
        latest = find_latest_checkpoint(tmp_path, "model")
        assert latest is not None and "epoch0003" in latest.name
        assert find_latest_checkpoint(tmp_path / "missing") is None


# --------------------------------------------------------------------------
# Between the packages
# --------------------------------------------------------------------------

def _mixed_tree(seed):
    """The same tree twice: JAX arrays and port tensors, every archive dtype
    a model stores, and a list of blocks."""
    rng = np.random.default_rng(seed)
    f32 = rng.standard_normal((4, 6)).astype(np.float32)
    j = {
        "f32": jnp.asarray(f32),
        "bf16": jnp.asarray(f32).astype(jnp.bfloat16),
        "fp16": jnp.asarray(f32).astype(jnp.float16),
        "fp8": {"e4m3": jnp.asarray(f32).astype(jnp.float8_e4m3fn),
                "e5m2": jnp.asarray(f32).astype(jnp.float8_e5m2)},
        "int": {"i8": jnp.asarray(rng.integers(-128, 128, (5,)), jnp.int8),
                "i32": jnp.asarray(rng.integers(-9, 9, (2, 3)), jnp.int32),
                "u8": jnp.asarray(rng.integers(0, 256, (7,)), jnp.uint8)},
        "blocks": [{"w": jnp.asarray(f32[i])} for i in range(3)],
        "step": jnp.asarray(5, jnp.int32),
    }
    views = {"bfloat16": (np.int16, torch.bfloat16),
             "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
             "float8_e5m2": (np.uint8, torch.float8_e5m2)}

    def to_port(a):
        a = np.array(a)
        raw, dtype = views.get(a.dtype.name, (None, None))
        return torch.from_numpy(a) if raw is None else torch.from_numpy(a.view(raw)).view(dtype)

    t = jax.tree_util.tree_map(to_port, j)
    return j, t


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_archive_trees_cross_the_packages_blob_for_blob(tmp_path, writer):
    j, t = _mixed_tree(0)
    a, b = tmp_path / "jax.mila", tmp_path / "port.mila"
    with JArchive(a, JOpenMode.WRITE) as ar:
        ar.write_tree("params", j)
    with ModelArchive(b, OpenMode.WRITE) as ar:
        ar.write_tree("params", t)
    # The two writers lay out the same members with the same contents.
    with zipfile.ZipFile(a) as za, zipfile.ZipFile(b) as zb:
        assert za.namelist() == zb.namelist()
        for name in za.namelist():
            assert za.read(name) == zb.read(name), name
    src = a if writer == "jax" else b
    with ModelArchive(src) as ar:
        port_read = ar.read_tree("params")
    with JArchive(src) as ar:
        jax_read = ar.read_tree("params")
    # Lists come back as dicts keyed "0", "1", ... on both sides.
    assert sorted(port_read["blocks"]) == sorted(jax_read["blocks"]) == ["0", "1", "2"]
    port_flat = dict(_paths(port_read))
    for path, want in _paths(jax_read):
        _assert_bits(_np(port_flat[path]), want)
    # restore_tree gives the written tree's shape back, the list included.
    back = restore_tree(port_read, t)
    assert isinstance(back["blocks"], list) and len(back["blocks"]) == 3
    for got, want in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(t)):
        assert got.dtype == want.dtype
        assert torch.equal(got.reshape(-1).view(torch.uint8), want.reshape(-1).view(torch.uint8))


def test_restore_tree_refuses_a_different_tree():
    _, t = _mixed_tree(1)
    with pytest.raises(ValueError, match="keys"):
        restore_tree({"f32": t["f32"]}, t)
    with pytest.raises(ValueError, match="shape"):
        restore_tree({"w": torch.zeros(3)}, {"w": torch.zeros(4)})
    # None leaves and parameter-free children are not written; they come back.
    like = {"a": {"w": torch.zeros(2)}, "act": {}, "opt": None}
    assert restore_tree({"a": {"w": torch.ones(2)}}, like)["act"] == {}


def _jax_gpt2_state(dtype, sr):
    cfg = JGPT2Config(vocab_size=64, max_seq_len=16, num_layers=2, num_heads=2,
                      embedding_dim=32, param_dtype=dtype)
    params = JGPT2(cfg).init(jax.random.key(0), (1, 8))
    opt = JAdamW(JAdamWConfig(learning_rate=1e-2, stochastic_rounding=sr))
    grads = jax.tree_util.tree_map(lambda p: jnp.full(p.shape, 0.5, p.dtype), params)
    params, state = opt.step(opt.init(params), params, grads)
    return params, state


@pytest.mark.parametrize("dtype,sr", [("float32", False), ("bfloat16", True)])
def test_jax_gpt2_checkpoint_loads_in_the_port(tmp_path, dtype, sr):
    params, state = _jax_gpt2_state(dtype, sr)
    p = tmp_path / "jax.mila"
    j_save_checkpoint(p, params, opt_state=state)
    data = load_checkpoint(p)
    flat = dict(_paths(data["params"]))
    for path, want in _paths(jax.tree_util.tree_map(np.asarray, params)):
        _assert_bits(_np(flat[path]), want)
    od = data["optimizer"]
    assert int(od["step"]) == 1 and ("master" in od) == sr
    for part in ("m", "v") + (("master",) if sr else ()):
        flat = dict(_paths(od[part]))
        for path, want in _paths(jax.tree_util.tree_map(np.asarray, getattr(state, part))):
            _assert_bits(_np(flat[path]), want)


@pytest.mark.parametrize("dtype,sr", [("float32", False), ("bfloat16", True)])
def test_port_gpt2_checkpoint_loads_in_jax(tmp_path, dtype, sr):
    jparams, jstate = _jax_gpt2_state(dtype, sr)
    as_np = lambda tree: jax.tree_util.tree_map(  # noqa: E731
        lambda a: np.asarray(a.astype(jnp.float32)) if a.dtype == jnp.bfloat16 else np.asarray(a),
        tree)
    params = params_from_jax(as_np(jparams), device="cpu")
    params = jax.tree_util.tree_map(lambda t, a: t.to(torch.bfloat16) if a.dtype == jnp.bfloat16
                                    else t, params, jparams)
    state = adamw_state_from_jax(jax.tree_util.tree_map(np.asarray, jstate), device="cpu")
    assert isinstance(state, AdamWState)
    p = tmp_path / "port.mila"
    save_checkpoint(p, params, opt_state=state)
    data = j_load_checkpoint(p)
    for path, want in _paths(jax.tree_util.tree_map(np.asarray, jparams)):
        _assert_bits(dict(_paths(data["params"]))[path], want)
    od = data["optimizer"]
    assert od["step"].dtype == np.int32 and int(od["step"]) == 1
    for part in ("m", "v") + (("master",) if sr else ()):
        flat = dict(_paths(od[part]))
        for path, want in _paths(jax.tree_util.tree_map(np.asarray, getattr(jstate, part))):
            _assert_bits(flat[path], want)


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


def test_jax_mlp_checkpoint_resumes_in_the_port(tmp_path):
    def jmodel(epochs):
        return JModel(JMLP(JMLPConfig(name="mnist")), JAdamW(JAdamWConfig(learning_rate=1e-3)),
                      JModelConfig(name="mnist", epochs=epochs, verbose=False,
                                   checkpoint_dir=str(tmp_path)))

    first = jmodel(2)
    first.build(jax.random.key(0), (128, 784))
    first.train(JMnistReader(batch_size=128, synthetic_n=1024, seed=0))
    first.save_checkpoint(epoch=1)
    jax_resumed = jmodel(2)
    jax_resumed.resume_training(
        _EpochShifted(JMnistReader(batch_size=128, synthetic_n=1024, seed=0), 2))

    port = Model(MLPClassifier(MLPClassifierConfig(name="mnist")),
                 AdamW(AdamWConfig(learning_rate=1e-3)),
                 ModelConfig(name="mnist", epochs=2, verbose=False, checkpoint_dir=str(tmp_path)),
                 device="cpu")
    port.build(1, (128, 784))  # other init: every leaf must come from the file
    port.resume_training(MnistReader(batch_size=128, synthetic_n=1024, seed=0))
    assert port.opt_state.step == int(jax_resumed.opt_state.step) == 32
    np.testing.assert_allclose(port.history.train_losses, jax_resumed.history.train_losses,
                               rtol=1e-5)
    flat = dict(_paths(port.params))
    for path, want in _paths(jax.tree_util.tree_map(np.asarray, jax_resumed.params)):
        np.testing.assert_allclose(flat[path].numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(), err_msg=path)
