"""The port's runtime, utilities, viz and plugins, held against the JAX
package (twins of ``tests/core/test_runtime.py``, the Timer/annotate cases
of ``test_profiling_dispatch.py``, the logging, RNG and config cases of
``test_utils.py``, the dtype, initializer and tensor-op cases of
``test_tensor.py`` and the viz and plugin cases of
``test_viz_plugins_factory.py``), plus the public names the port adds in
this slice: ``gelu_exact``/``gelu_sigmoid``/``gelu_tanh``,
``quantization_error``, ``model_bytes``, ``Module.parameter_bytes`` and
``mila_tpu_torch.initialize``.

The same numpy inputs, from a seed, go through both packages. Exact
equality: the PPM bytes, ``render_ascii``, ``render_rgb``,
``render_training_curve`` and ``visualize_params`` text, ``describe``,
``compute_axis_partition``, the StepLogger CSV bytes (both clocks
replaced by one fake clock), ``to_json`` text, ``numpy_rng`` draws, and
``tree_nbytes``/``model_bytes``/``parameter_bytes`` of bridged trees.
Tolerances: the three GELUs and their gradients, and
``quantization_error``, within 1e-6 in f32. The initializers draw from
different generators, so only their statistics are compared. The port has
one CPU device (JAX's tests force eight) and no TPU; ``get_device("auto")``
is the GPU and raises without one.
"""

import dataclasses
import io
import json
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mila_tpu
import mila_tpu_torch
from mila_tpu import runtime as jrt
from mila_tpu.extensibility import PluginManager as JPluginManager
from mila_tpu.inference import quantize as jq
from mila_tpu.models import MLPClassifier as JMLP
from mila_tpu.models import MLPClassifierConfig as JMLPConfig
from mila_tpu.models.gpt2 import GPT2Config as JGPT2Config
from mila_tpu import ops as jgelu
from mila_tpu.tensor import dtypes as jdt
from mila_tpu.tensor import init as jinit
from mila_tpu.tensor import tensor_ops as jops
from mila_tpu.utils import config as jconfig
from mila_tpu.utils import logging as jlog
from mila_tpu.utils import profiling as jprof
from mila_tpu.utils import rng as jrng
from mila_tpu.viz import framebuffer as jviz
from mila_tpu_torch import runtime as trt
from mila_tpu_torch.bridge import params_from_jax
from mila_tpu_torch.extensibility import PluginManager
from mila_tpu_torch.inference import quantize as tq
from mila_tpu_torch.models import MLPClassifier, MLPClassifierConfig
from mila_tpu_torch.models.gpt2 import GPT2Config
from mila_tpu_torch.ops import gelu_exact, gelu_sigmoid, gelu_tanh
from mila_tpu_torch.runtime import (
    DeviceKind,
    ExecutionContext,
    MemoryTracker,
    PrecisionPolicy,
    default_context,
    device_memory_stats,
    format_bytes,
    get_device,
    list_devices,
    resolve,
    set_default_context,
    tree_nbytes,
)
from mila_tpu_torch.tensor import dtypes, init
from mila_tpu_torch.tensor import tensor_ops as tops
from mila_tpu_torch.utils import (
    BaseConfig,
    ConfigError,
    Logger,
    LogLevel,
    RandomGenerator,
    StepLogger,
)
from mila_tpu_torch.utils import logging as tlog
from mila_tpu_torch.utils.profiling import Timer, annotate, trace
from mila_tpu_torch.utils.registry import operations
from mila_tpu_torch.viz import (
    FrameBuffer,
    HeatMapRenderer,
    colormap,
    render_training_curve,
    visualize_params,
)


def _normal(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _jax_tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture
def cpu_context():
    set_default_context(ExecutionContext("cpu"))
    yield
    set_default_context(None)


# --------------------------------------------------------------------------
# tests/core/test_runtime.py: devices
# --------------------------------------------------------------------------

class TestDeviceDiscovery:
    def test_list_devices_nonempty(self):
        assert torch.device("cpu") in list_devices()

    def test_one_cpu_device(self):
        # JAX's test forces eight virtual CPU devices; the port has one.
        assert list_devices(DeviceKind.CPU) == [torch.device("cpu")]
        assert list_devices(DeviceKind.TPU) == []
        assert len(list_devices(DeviceKind.GPU)) == torch.cuda.device_count()

    @pytest.mark.parametrize("spec", ["cpu", "CPU", "cpu:0", " cpu "])
    def test_get_device_by_name(self, spec):
        assert get_device(spec) == torch.device("cpu")

    def test_get_device_auto_is_the_gpu(self):
        if torch.cuda.is_available():
            assert get_device("auto") == torch.device("cuda", 0)
            assert get_device("") == get_device("cuda:0") == get_device("gpu")
        else:
            for spec in ("auto", "", "gpu", "cuda", "cuda:0"):
                with pytest.raises(ValueError, match="no 'gpu' devices"):
                    get_device(spec)

    @pytest.mark.parametrize("spec", ["cpu:1", "cpu:99", "tpu", "tpu:0", "quantum",
                                      "cuda:99"])
    def test_bad_specs(self, spec):
        with pytest.raises(ValueError):
            get_device(spec)

    def test_kinds_match_jax(self):
        assert [k.value for k in DeviceKind] == [k.value for k in jrt.DeviceKind]
        assert DeviceKind.from_string("cuda") == DeviceKind.GPU
        assert jrt.DeviceKind.from_string("cuda") == jrt.DeviceKind.GPU
        # JAX's "auto" prefers the TPU; the port's is the GPU.
        assert DeviceKind.from_string("auto") == DeviceKind.GPU
        with pytest.raises(ValueError):
            DeviceKind.from_string("quantum")

    def test_available_platforms(self):
        assert trt.available_platforms()[-1] == "cpu"
        assert ("gpu" in trt.available_platforms()) == torch.cuda.is_available()


class TestExecutionContext:
    def test_put_and_synchronize(self):
        ctx, jctx = ExecutionContext("cpu"), jrt.ExecutionContext("cpu:2")
        a = np.arange(6.0).reshape(2, 3)
        x = ctx.put(a)
        assert x.device == torch.device("cpu")
        np.testing.assert_array_equal(x.numpy(), np.asarray(jctx.put(a)))
        ctx.synchronize(x)
        ctx.synchronize()
        assert not ctx.is_accelerator and ctx.mesh is None

    def test_props(self):
        p = ExecutionContext("cpu").props()
        assert p.platform == jrt.ExecutionContext("cpu").props().platform == "cpu"
        assert p.num_cores >= 1 and p.memory_bytes is None and p.compute_capability is None

    def test_default_context(self, cpu_context):
        assert default_context().device == torch.device("cpu")
        assert jrt.default_context().device is not None

    def test_default_context_is_the_gpu(self):
        set_default_context(None)
        if torch.cuda.is_available():
            assert default_context().device == torch.device("cuda", 0)
        else:
            with pytest.raises(ValueError):
                default_context()

    def test_no_mesh_yet(self):
        with pytest.raises(NotImplementedError):
            ExecutionContext("cpu", mesh=object())


# --------------------------------------------------------------------------
# precision
# --------------------------------------------------------------------------

_TORCH_NAME = {torch.float32: "float32", torch.bfloat16: "bfloat16", torch.float16: "float16"}


@pytest.mark.parametrize("policy", list(PrecisionPolicy))
@pytest.mark.parametrize("on_accelerator", [True, False])
def test_precision_resolves_like_jax(policy, on_accelerator):
    got = resolve(policy, on_accelerator=on_accelerator, native_dtype=torch.float16)
    want = jrt.resolve(jrt.PrecisionPolicy(policy.value), on_accelerator=on_accelerator,
                       native_dtype=jnp.float16)
    assert [_TORCH_NAME[d] for d in (got.param_dtype, got.compute_dtype, got.accum_dtype)] == \
        [jnp.dtype(d).name for d in (want.param_dtype, want.compute_dtype, want.accum_dtype)]


def test_precision_from_string():
    assert [p.value for p in PrecisionPolicy] == [p.value for p in jrt.PrecisionPolicy]
    assert PrecisionPolicy.from_string("performance") == PrecisionPolicy.PERFORMANCE
    with pytest.raises(ValueError):
        PrecisionPolicy.from_string("fast")


# --------------------------------------------------------------------------
# memory
# --------------------------------------------------------------------------

def _mlp_pair(dtype="float32"):
    jm = JMLP(JMLPConfig(hidden_dims=(64, 32), param_dtype=dtype))
    jp = jm.init(jax.random.key(0), (2, 784))
    return jm, jp, params_from_jax(_jax_tree_np(jp), "cpu")


@pytest.mark.parametrize("what", ["float32", "bfloat16", "int8", "fp8_e4m3", "int4"])
def test_tree_and_model_bytes_match_jax(what):
    """tree_nbytes, model_bytes and Module.parameter_bytes on a bridged
    MLP tree, plain or with its weights quantized."""
    jm, jp, tp = _mlp_pair("bfloat16" if what == "bfloat16" else "float32")
    if what in ("int8", "fp8_e4m3", "int4"):
        jp = jq.quantize_model_params(jp, what, min_size=512)
        tp = params_from_jax(_jax_tree_np(jp), "cpu")
        assert isinstance(tp["fc1"]["weight"], tq.QTensor)
    assert tree_nbytes(tp) == jrt.tree_nbytes(jp)
    assert tq.model_bytes(tp) == jq.model_bytes(jp)
    tm = MLPClassifier(MLPClassifierConfig(hidden_dims=(64, 32)))
    assert tm.parameter_bytes(tp) == jm.parameter_bytes(jp)


def test_tracker_peak():
    t, jt = MemoryTracker(), jrt.MemoryTracker()
    a, ja = torch.zeros(10), jnp.zeros((10,), jnp.float32)
    t.record_alloc({"a": a, "b": [a, a]})
    jt.record_alloc({"a": ja, "b": [ja, ja]})
    t.record_free(a)
    jt.record_free(ja)
    assert dataclasses.asdict(t.stats) == dataclasses.asdict(jt.stats)
    assert t.stats.live_bytes == 80 and t.stats.peak_bytes == 120
    t.reset()
    assert t.stats.allocation_count == 0


@pytest.mark.parametrize("n", [0, 1, 1023, 1024, 1536.5, 3 * 1024**3, 7 * 1024**5, -2048])
def test_format_bytes_matches_jax(n):
    assert format_bytes(n) == jrt.format_bytes(n)


def test_device_memory_stats():
    assert device_memory_stats("cpu") is None
    if not torch.cuda.is_available():
        assert device_memory_stats() is None


# --------------------------------------------------------------------------
# tests/core/test_profiling_dispatch.py: Timer, annotate; trace
# --------------------------------------------------------------------------

class TestTimer:
    def test_scopes_accumulate(self):
        t = Timer()
        with t.scope("a"):
            pass
        with t.scope("a"):
            pass
        with t.scope("b", sync=torch.zeros(4)):
            pass
        with t.scope("c", sync=[torch.zeros(1), {"x": torch.zeros(1)}]):
            pass
        assert t.counts == {"a": 2, "b": 1, "c": 1}
        s = t.summary()
        assert "a" in s and "ms/call" in s

    def test_summary_matches_jax(self):
        t, jt = Timer(), jprof.Timer()
        for timer in (t, jt):
            timer.totals = {"fwd": 0.012345, "bwd": 0.5, "opt": 0.0031}
            timer.counts = {"fwd": 3, "bwd": 7, "opt": 1}
        assert t.summary() == jt.summary()

    def test_annotate_passthrough(self):
        @annotate("f")
        def f(x):
            return x + 1

        assert int(f(torch.tensor(1, dtype=torch.int32))) == 2
        assert f.__name__ == "f"

    def test_trace_writes_a_chrome_trace(self, tmp_path):
        @annotate("mila_span")
        def f(x):
            return x @ x

        with trace(str(tmp_path)):
            f(torch.ones(8, 8))
        files = list(tmp_path.glob("*.pt.trace.json"))
        assert len(files) == 1
        events = json.loads(files[0].read_text())["traceEvents"]
        assert any(e.get("name") == "mila_span" for e in events)


# --------------------------------------------------------------------------
# tests/core/test_utils.py: logging, RNG, config; initialize
# --------------------------------------------------------------------------

class TestLogger:
    def test_levels_match_jax(self):
        assert {k.name: int(k) for k in LogLevel} == {k.name: int(k) for k in jlog.LogLevel}

    def test_custom_backend_receives_messages(self):
        seen = []
        Logger.set_backend(lambda lvl, msg: seen.append((lvl, msg)))
        try:
            Logger.info("hello {} {:.2f}", 42, 0.125)
            assert seen == [(LogLevel.INFO, "hello 42 0.12")]
        finally:
            Logger.set_backend(None)

    def test_level_filtering(self):
        seen = []
        Logger.set_backend(lambda lvl, msg: seen.append(msg))
        old = Logger.get_level()
        try:
            Logger.set_level(LogLevel.WARNING)
            Logger.info("dropped")
            Logger.debug("dropped {}", 1)
            Logger.error("kept")
            Logger.critical("kept {}", 2)
            assert seen == ["kept", "kept 2"]
        finally:
            Logger.set_backend(None)
            Logger.set_level(old)


class _Clock:
    def __init__(self):
        self.t = 100.0

    def monotonic(self):
        self.t += 0.0125
        return self.t


def test_step_logger_csv_bytes_match_jax(monkeypatch, tmp_path):
    out = {}
    for name, mod in (("jax", jlog), ("torch", tlog)):
        monkeypatch.setattr(mod, "time", _Clock())
        buf = io.StringIO()
        sl = mod.StepLogger(["loss", "lr", "note"], stream=buf)
        sl.log_step(1, loss=0.5, lr=1e-3, note="warm")
        sl.log_step(2, loss=0.25, lr=3.0e-4)
        sl.log_step(3, loss=1234567.0, lr=1, note=None)
        out[name] = buf.getvalue().encode()
    assert out["torch"] == out["jax"]
    lines = out["torch"].decode().splitlines()
    assert lines[0] == "time_s,step,loss,lr,note" and lines[2].split(",")[2] == "0.25"
    with StepLogger(["loss"], path=str(tmp_path / "log.csv")) as sl:
        sl.log_step(0, loss=1.0)
    assert (tmp_path / "log.csv").read_text().splitlines()[0] == "time_s,step,loss"
    with pytest.raises(ValueError):
        StepLogger(["x"], stream=io.StringIO(), path=str(tmp_path / "y.csv"))


class TestRandomGenerator:
    @pytest.mark.parametrize("name", ["numpy", "shuffle", "data/train"])
    def test_numpy_rng_draws_match_jax(self, name):
        RandomGenerator.set_seed(123)
        jrng.RandomGenerator.set_seed(123)
        try:
            np.testing.assert_array_equal(RandomGenerator.numpy_rng(name).integers(0, 1 << 30, 16),
                                          jrng.RandomGenerator.numpy_rng(name).integers(
                                              0, 1 << 30, 16))
        finally:
            jrng.RandomGenerator.set_seed(42)

    def test_deterministic_streams(self):
        RandomGenerator.set_seed(123)
        a = torch.rand(8, generator=RandomGenerator.stream("init", "cpu"))
        RandomGenerator.set_seed(123)
        b = torch.rand(8, generator=RandomGenerator.stream("init", "cpu"))
        assert torch.equal(a, b) and RandomGenerator.get_seed() == 123

    def test_distinct_streams(self):
        RandomGenerator.set_seed(1)
        a = torch.rand(8, generator=RandomGenerator.stream("a", "cpu"))
        b = torch.rand(8, generator=RandomGenerator.stream("b", "cpu"))
        r = torch.rand(8, generator=RandomGenerator.root_key("cpu"))
        assert not torch.equal(a, b) and not torch.equal(a, r)

    def test_next_key_is_sequential(self):
        RandomGenerator.set_seed(5)
        first = [torch.rand(4, generator=RandomGenerator.next_key("cpu")) for _ in range(2)]
        RandomGenerator.set_seed(5)
        again = torch.rand(4, generator=RandomGenerator.next_key("cpu"))
        assert torch.equal(first[0], again) and not torch.equal(first[0], first[1])

    @pytest.mark.skipif(torch.cuda.is_available(), reason="checks the no-GPU error")
    @pytest.mark.parametrize("draw", ["root_key", "stream", "next_key"])
    def test_default_device_is_the_gpu(self, draw):
        args = ("init",) if draw == "stream" else ()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            getattr(RandomGenerator, draw)(*args)


@dataclasses.dataclass(frozen=True)
class _DemoConfig(BaseConfig):
    width: int = 8
    rate: float = 0.1
    dims: tuple = (1, 2)

    def validate(self):
        if self.width <= 0:
            raise ConfigError("width must be positive")


@dataclasses.dataclass(frozen=True)
class _JDemoConfig(jconfig.BaseConfig):
    width: int = 8
    rate: float = 0.1
    dims: tuple = (1, 2)


class TestBaseConfig:
    @pytest.mark.parametrize("indent", [None, 2])
    def test_to_json_text_matches_jax(self, indent):
        kw = dict(name="demo", width=32, rate=0.5, dims=(3, 4, 5))
        assert _DemoConfig(**kw).to_json(indent) == _JDemoConfig(**kw).to_json(indent)

    @pytest.mark.parametrize("make", [
        lambda m: m.GPT2Config(),
        lambda m: m.GPT2Config.char_lm(65),
        lambda m: m.GPT2Config(num_layers=2, embedding_dim=64, param_dtype="bfloat16"),
    ], ids=["gpt2-124m", "char-lm", "tiny-bf16"])
    def test_model_config_json_both_ways(self, make):
        import mila_tpu.models.gpt2 as jg
        import mila_tpu_torch.models.gpt2 as tg

        t, j = make(tg), make(jg)
        assert t.to_json() == j.to_json()
        assert GPT2Config.from_json(j.to_json()) == t
        assert JGPT2Config.from_json(t.to_json()) == j

    def test_json_round_trip(self):
        c = _DemoConfig(name="demo", width=32, rate=0.5)
        assert _DemoConfig.from_json(c.to_json()) == c
        with pytest.raises(ConfigError):
            _DemoConfig(width=-1).validate()


def test_initialize_seeds_levels_and_registers():
    old = Logger.get_level()
    try:
        mila_tpu_torch.shutdown()
        assert not mila_tpu_torch.is_initialized()
        mila_tpu_torch.initialize(seed=7, log_level=LogLevel.WARNING)
        assert mila_tpu_torch.is_initialized()
        assert RandomGenerator.get_seed() == 7 and Logger.get_level() == LogLevel.WARNING
        for name in ["LinearOp", "GeluOp", "LayerNormOp", "AttentionOp", "EncoderOp",
                     "ResidualOp", "SoftmaxOp", "SoftmaxCrossEntropyOp"]:
            assert operations.contains(name), name
        assert mila_tpu_torch.__version__ == mila_tpu.__version__
        assert mila_tpu_torch.get_api_version() == mila_tpu.get_api_version()
        mila_tpu_torch.shutdown()
        assert not mila_tpu_torch.is_initialized()
    finally:
        Logger.set_level(old)


# --------------------------------------------------------------------------
# tests/core/test_tensor.py: dtypes, initializers, tensor ops
# --------------------------------------------------------------------------

_DTYPE_NAMES = ["FP32", "FP16", "BF16", "FP8_E4M3", "FP8_E5M2", "INT8", "INT16", "INT32",
                "UINT8", "UINT16", "UINT32", "INT4"]


def test_dtype_registry_matches_jax():
    assert [t.name for t in dtypes.all_dtypes()] == [t.name for t in jdt.all_dtypes()]
    assert set(_DTYPE_NAMES) == {t.name for t in dtypes.all_dtypes()}


@pytest.mark.parametrize("name", _DTYPE_NAMES)
def test_dtype_traits_match_jax(name):
    t, j = dtypes.from_name(name), jdt.from_name(name)
    assert (t.bits, t.is_float, t.is_signed, t.packed, t.size_in_bytes) == \
        (j.bits, j.is_float, j.is_signed, j.packed, j.size_in_bytes)
    assert t.jnp_name == j.jnp_dtype.name
    assert dtypes.from_name(t.jnp_name) is t
    if t.is_float:
        tf, jf = t.finfo, j.finfo
        assert (tf.bits, tf.max, tf.min, tf.eps, tf.tiny) == \
            (jf.bits, float(jf.max), float(jf.min), float(jf.eps), float(jf.tiny))
        assert t.iinfo is None
    else:
        ti, ji = t.iinfo, j.iinfo
        assert (ti.bits, ti.min, ti.max) == (ji.bits, int(ji.min), int(ji.max))
        assert t.finfo is None
    if t.torch_dtype is not None:
        assert dtypes.from_torch(t.torch_dtype) is t
        assert dtypes.is_float_type(t.torch_dtype) == jdt.is_float_type(j.jnp_dtype)
        assert dtypes.itemsize_bits(t.torch_dtype) == jdt.itemsize_bits(j.jnp_dtype)
        host = dtypes.host_equivalent(t.torch_dtype)
        # numpy has no bfloat16 here: the port stages it through float32.
        assert host == (np.float32 if name == "BF16" else jdt.host_equivalent(j.jnp_dtype))
    else:
        assert name == "INT4"


def test_dtype_lookup_errors():
    assert dtypes.from_name("bfloat16") is dtypes.BF16 and dtypes.from_name("bf16") is dtypes.BF16
    with pytest.raises(KeyError):
        dtypes.from_name("complex64")
    with pytest.raises(KeyError):
        dtypes.from_torch(torch.complex64)


class TestInitializers:
    def test_registry_names_match_jax(self):
        assert list(init.INITIALIZERS) == list(jinit.INITIALIZERS)
        assert init.INITIALIZERS["xavier"] is init.xavier_uniform

    def test_zeros_ones_full(self):
        assert torch.all(init.zeros((3, 4)) == 0) and torch.all(init.ones((3, 4)) == 1)
        full = init.full((2,), 7.0, dtype=torch.bfloat16)
        assert full.dtype == torch.bfloat16 and torch.all(full == 7.0)
        np.testing.assert_array_equal(full.float().numpy(),
                                      np.asarray(jinit.full((2,), 7.0, jnp.bfloat16), np.float32))

    @pytest.mark.parametrize("name,shape,var", [
        ("xavier_normal", (256, 128), 2.0 / 384),
        ("he_uniform", (512, 64), 2.0 / 512),
        ("he_normal", (512, 64), 2.0 / 512),
        ("xavier_uniform", (256, 128), 2.0 / 384),
    ])
    def test_variance_like_jax(self, name, shape, var):
        w = init.INITIALIZERS[name](torch.Generator().manual_seed(0), shape)
        jw = jinit.INITIALIZERS[name](jax.random.key(0), shape)
        assert w.shape == tuple(jw.shape) and w.dtype == torch.float32
        np.testing.assert_allclose(float(w.var()), var, rtol=0.15)
        np.testing.assert_allclose(float(w.var()), float(jw.var()), rtol=0.15)

    def test_truncated_normal_like_jax(self):
        w = init.truncated_normal(torch.Generator().manual_seed(0), (200, 100), stddev=0.5,
                                  dtype=torch.bfloat16)
        jw = np.asarray(jinit.truncated_normal(jax.random.key(0), (200, 100), 0.5), np.float32)
        w32 = w.float().numpy()
        assert w.dtype == torch.bfloat16 and np.abs(w32).max() <= 1.0
        assert np.abs(jw).max() <= 1.0
        # A standard normal truncated at +-2 has std 0.8796.
        np.testing.assert_allclose(w32.std(), 0.5 * 0.8796, rtol=0.03)
        np.testing.assert_allclose(w32.std(), jw.std(), rtol=0.03)
        assert abs(w32.mean()) < 0.01

    def test_uniform_range(self):
        x = init.uniform(torch.Generator().manual_seed(0), (1000,), -2.0, 3.0)
        assert x.min() >= -2.0 and x.max() < 3.0


@pytest.mark.parametrize("op", ["add", "subtract", "multiply", "divide"])
def test_elementwise_ops_match_jax(op):
    a, b = _normal(0, 4, 5), _normal(1, 4, 5) + 3.0
    got = getattr(tops, op)(torch.from_numpy(a), torch.from_numpy(b))
    want = getattr(jops, op)(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tops.scale(torch.from_numpy(a), 1.5).numpy(),
                                  np.asarray(jops.scale(jnp.asarray(a), 1.5)))


class TestTensorOps:
    def test_copy_converts_dtype(self):
        x = torch.from_numpy(_normal(0, 4, 4))
        y = tops.copy(x, dtype=torch.bfloat16, device="cpu")
        assert y.dtype == torch.bfloat16 and y.data_ptr() != x.data_ptr()
        h = tops.to_host(y)
        assert isinstance(h, np.ndarray) and h.dtype == np.float32
        np.testing.assert_array_equal(
            h, np.asarray(jops.copy(jnp.asarray(x.numpy()), dtype=jnp.bfloat16), np.float32))
        assert tops.copy([1, 2], device="cpu").dtype == torch.int64
        assert tops.copy(x).device == x.device

    @pytest.mark.skipif(torch.cuda.is_available(), reason="checks the no-GPU error")
    def test_copy_sends_host_data_to_the_gpu(self):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tops.copy([1, 2])

    def test_fill(self):
        x = tops.fill((2, 3), 1.5, device="cpu")
        assert x.shape == (2, 3) and float(x[0, 0]) == 1.5
        assert torch.equal(tops.fill_like(x, 2.0), torch.full((2, 3), 2.0))
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError):
                tops.fill((2,), 0.0)

    @pytest.mark.parametrize("case", ["f32 matrix", "f32 short", "f16", "int32", "edge 1"])
    def test_describe_matches_jax(self, case):
        a = {"f32 matrix": _normal(2, 3, 5), "f32 short": _normal(3, 4),
             "f16": _normal(4, 7).astype(np.float16),
             "int32": np.arange(-5, 9, dtype=np.int32).reshape(2, 7),
             "edge 1": _normal(5, 2, 2)}[case]
        edge = 1 if case == "edge 1" else 3
        assert tops.describe(torch.from_numpy(a), "w", edge) == \
            jops.describe(jnp.asarray(a), "w", edge)

    @pytest.mark.parametrize("shape,axis", [((2, 3, 4, 5), 2), ((2, 3, 4), -1), ((7,), 0),
                                            ((3, 1, 2), -3), ((4, 6), 1)])
    def test_axis_partition_matches_jax(self, shape, axis):
        assert dataclasses.asdict(tops.compute_axis_partition(shape, axis)) == \
            dataclasses.asdict(jops.compute_axis_partition(shape, axis))
        assert tops.compute_axis_partition(shape, axis).num_slices == \
            jops.compute_axis_partition(shape, axis).num_slices

    def test_invalid_axis_raises(self):
        with pytest.raises(ValueError):
            tops.normalize_axis(5, 3)


# --------------------------------------------------------------------------
# ops/gelu.py and inference/quantize.py names
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["gelu_tanh", "gelu_exact", "gelu_sigmoid"])
def test_gelu_variants_match_jax(name):
    x = _normal(6, 64, 33, scale=3.0)
    g = _normal(7, 64, 33)
    tfn = {"gelu_tanh": gelu_tanh, "gelu_exact": gelu_exact, "gelu_sigmoid": gelu_sigmoid}[name]
    jfn = getattr(jgelu, name)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tfn(xt)
    (dx,) = torch.autograd.grad(y, xt, torch.from_numpy(g))
    jy, vjp = jax.vjp(jfn, jnp.asarray(x))
    (jdx,) = vjp(jnp.asarray(g))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=0, atol=1e-6)
    # The tanh form's derivative has 1 - tanh^2 times a term growing as x^2:
    # past |x| 4 both packages lose digits to that cancellation, each in its
    # own order of operations (up to 5e-6 apart at |x| 9).
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype,block", [("int8", 0), ("int8", 32), ("fp8_e4m3", 0),
                                         ("fp8_e5m2", 64), ("int4", 0), ("int4", 32)])
def test_quantization_error_matches_jax(dtype, block):
    w = _normal(8, 128, 48, scale=0.05)
    got = tq.quantization_error(torch.from_numpy(w), dtype, block)
    want = jq.quantization_error(jnp.asarray(w), dtype, block)
    assert 0 < got < 0.2
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# --------------------------------------------------------------------------
# tests/core/test_viz_plugins_factory.py: viz
# --------------------------------------------------------------------------

class TestFrameBuffer:
    def test_basic_ops(self):
        fb = FrameBuffer(16, 8)
        fb.clear((10, 20, 30))
        assert tuple(fb.pixels[0, 0]) == (10, 20, 30)
        fb.set_pixel(3, 2, (255, 0, 0))
        assert tuple(fb.pixels[2, 3]) == (255, 0, 0)
        fb.set_pixel(100, 100, (1, 1, 1))
        with pytest.raises(ValueError):
            FrameBuffer(0, 5)

    def test_ppm_bytes_match_jax(self, tmp_path):
        w = _normal(9, 40, 70)
        out = {}
        for name, mod, t in (("torch", None, torch.from_numpy(w)), ("jax", jviz, jnp.asarray(w))):
            fb = (FrameBuffer if mod is None else mod.FrameBuffer)(96, 48)
            fb.clear((1, 2, 3))
            fb.set_pixel(5, 5, (200, 100, 50))
            fb.blit(90, 40, np.full((20, 20, 3), 9, np.uint8))
            (HeatMapRenderer if mod is None else mod.HeatMapRenderer)(max_size=32).render_to(
                fb, t, 2, 3)
            fb.to_ppm(tmp_path / f"{name}.ppm")
            out[name] = (tmp_path / f"{name}.ppm").read_bytes()
        assert out["torch"] == out["jax"]
        assert out["torch"].startswith(b"P6 96 48 255\n")
        assert len(out["torch"]) == len(b"P6 96 48 255\n") + 96 * 48 * 3


def test_colormap_matches_jax():
    v = np.linspace(-0.2, 1.2, 35, dtype=np.float32).reshape(5, 7)
    got = colormap(torch.from_numpy(v))
    assert got.dtype == np.uint8 and got.shape == (5, 7, 3)
    np.testing.assert_array_equal(got, jviz.colormap(v))


@pytest.mark.parametrize("shape,width,max_size", [((32, 64), 32, 256), ((100, 100), 64, 16),
                                                  ((17,), 8, 256), ((4, 6, 10), 20, 3),
                                                  ((300, 5), 64, 256)])
def test_heatmaps_match_jax(shape, width, max_size):
    w = _normal(10, *shape)
    r, jr = HeatMapRenderer(max_size), jviz.HeatMapRenderer(max_size)
    assert r.render_ascii(torch.from_numpy(w), width) == jr.render_ascii(jnp.asarray(w), width)
    np.testing.assert_array_equal(r.render_rgb(torch.from_numpy(w)),
                                  jr.render_rgb(jnp.asarray(w)))


def test_heatmap_of_bf16_matches_jax():
    w = _normal(11, 24, 40)
    t = torch.from_numpy(w).to(torch.bfloat16)
    j = jnp.asarray(w).astype(jnp.bfloat16)
    assert HeatMapRenderer().render_ascii(t, 40) == jviz.HeatMapRenderer().render_ascii(j, 40)


@pytest.mark.parametrize("losses,width,height", [
    ([3.0, 2.0, 1.0, 0.5], 20, 5), ([2.5], 10, 3), ([1.0, 1.0, 1.0], 12, 4),
    (list(np.linspace(4.0, 0.1, 37) ** 1.5), 60, 12), ([], 60, 12)])
def test_training_curve_matches_jax(losses, width, height):
    got = render_training_curve([float(x) for x in losses], width, height, label="train loss")
    assert got == jviz.render_training_curve([float(x) for x in losses], width, height,
                                             label="train loss")
    if losses:
        # JAX's takes a list only; the port's also a tensor.
        assert "*" in got and "max" in got
        assert render_training_curve(torch.tensor(losses), width, height, "train loss") == got


def test_visualize_params_matches_jax():
    _, jp, tp = _mlp_pair()
    tp = {"z": tp["fc2"], "a": {"fc1": tp["fc1"]}, "head": tp["head"]}
    jp = {"z": jp["fc2"], "a": {"fc1": jp["fc1"]}, "head": jp["head"]}
    got = visualize_params(tp)
    assert got == jviz.visualize_params(jp)
    assert "a/fc1/weight (784, 64)" in got and got.index("a/fc1") < got.index("head/")


# --------------------------------------------------------------------------
# plugins
# --------------------------------------------------------------------------

class TestPluginManager:
    def _write_plugin(self, directory, name="demo", bad=False, op=""):
        directory.mkdir(parents=True, exist_ok=True)
        register = ""
        if op:
            register = ("from mila_tpu_torch.utils.registry import operations; "
                        f"operations.register('{op}', lambda x: x * 2)")
        body = textwrap.dedent(f"""
            class _P:
                name = "{name}"
                version = "1.0"
                initialized = False
                def initialize(self):
                    self.initialized = True
                    {register}
                def shutdown(self): self.initialized = False
            {"MILA_TPU_PLUGIN = _P()" if not bad else "# no export"}
            """)
        p = directory / f"{name}_plugin.py"
        p.write_text(body)
        return p

    def test_load_initialize_unload(self, tmp_path):
        pm = PluginManager()
        plugin = pm.load_from_path(self._write_plugin(tmp_path))
        assert plugin.initialized and pm.get("demo") is plugin
        assert pm.list_plugins() == ["demo"]
        pm.unload("demo")
        assert not plugin.initialized and pm.get("demo") is None

    def test_missing_export_raises(self, tmp_path):
        with pytest.raises(ImportError, match="MILA_TPU_PLUGIN"):
            PluginManager().load_from_path(self._write_plugin(tmp_path, name="bad", bad=True))

    def test_scan_directory_skips_bad_like_jax(self, tmp_path):
        self._write_plugin(tmp_path, name="good")
        self._write_plugin(tmp_path, name="ugly", bad=True)
        got = [p.name for p in PluginManager().scan_directory(tmp_path)]
        assert got == ["good"] == [p.name for p in JPluginManager().scan_directory(tmp_path)]
        assert PluginManager().scan_directory(tmp_path / "absent") == []

    def test_duplicate_rejected(self, tmp_path):
        pm = PluginManager()
        pm.load_from_path(self._write_plugin(tmp_path))
        with pytest.raises(KeyError, match="already loaded"):
            pm.load_from_path(self._write_plugin(tmp_path / "sub"))
        pm.unload_all()
        assert pm.list_plugins() == []

    def test_plugin_registers_an_operation(self, tmp_path):
        pm = PluginManager()
        pm.load_from_path(self._write_plugin(tmp_path, name="opsy", op="DoubleOp"))
        assert operations.get("DoubleOp")(torch.tensor(3.0)) == 6.0
