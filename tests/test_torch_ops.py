"""The port's plain ops against ``mila_tpu.ops`` on identical numpy inputs,
plus the import guard: ``mila_tpu_torch`` never imports JAX or ``mila_tpu``.

Tolerances: both sides compute in f32 on the CPU with the same formulas;
differences come from summation order and transcendental implementations
(XLA vs ATen), a few f32 ulps. We allow rtol/atol 1e-5 (5e-5 for attention,
whose softmax sums over up to 24 keys).
"""

import pathlib
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mila_tpu import ops as jops
from mila_tpu.models.llama import LlamaConfig as JLlamaConfig
from mila_tpu_torch import ops as tops

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _np(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def test_rmsnorm_matches_jax():
    x, g = _np(0, 3, 5, 64), 1.0 + _np(1, 64, scale=0.1)
    want = np.asarray(jops.rms_norm(jnp.asarray(x), jnp.asarray(g), 1e-5))
    got = tops.rms_norm(torch.from_numpy(x), torch.from_numpy(g), 1e-5).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_swiglu_and_residual_match_jax():
    a, b = _np(2, 4, 32), _np(3, 4, 32)
    np.testing.assert_allclose(
        tops.swiglu(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jops.swiglu(jnp.asarray(a), jnp.asarray(b))), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        tops.residual(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jops.residual(jnp.asarray(a), jnp.asarray(b))))


@pytest.mark.parametrize("cfg", ["llama32_1b", "tiny"])
def test_rope_matches_jax(cfg):
    from mila_tpu.ops.rope import rope_frequencies as jfreq

    c = getattr(JLlamaConfig, cfg)()
    want = np.asarray(jfreq(c.hd, c.rope_theta, c.rope_scaling))
    got = tops.rope_frequencies(c.hd, c.rope_theta, c.rope_scaling).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    pos = np.array([[0, 1, 7, 300], [5, 6, 1000, 4095]], np.int32)
    jc, js = jops.rope_cos_sin(jnp.asarray(pos), c.hd, c.rope_theta, c.rope_scaling)
    tc, ts = tops.rope_cos_sin(torch.from_numpy(pos), c.hd, c.rope_theta, c.rope_scaling)
    # cos/sin of angles up to ~4e3 rad: f32 argument reduction differs by ulps.
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=2e-4)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=2e-4)
    x = _np(4, 2, 4, 3, c.hd)
    want = np.asarray(jops.apply_rope(jnp.asarray(x), jc, js))
    got = tops.apply_rope(torch.from_numpy(x), torch.from_numpy(np.array(jc)),
                          torch.from_numpy(np.array(js))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_gqa_attention_matches_jax(masked):
    B, T, NH, NKV, HD = 2, 24, 8, 2, 16
    q, k, v = _np(5, B, T, NH, HD), _np(6, B, T, NKV, HD), _np(7, B, T, NKV, HD)
    mask = None
    if masked:
        mask = np.random.default_rng(8).random((B, T, T)) > 0.3
        mask[:, :, 0] = True
    want = np.asarray(jops.dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=not masked,
        mask=None if mask is None else jnp.asarray(mask)))
    got = tops.dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=not masked,
        mask=None if mask is None else torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=5e-5, atol=5e-5)


def test_port_imports_no_jax():
    """Importing the port pulls in neither jax nor mila_tpu."""
    code = ("import sys, mila_tpu_torch, mila_tpu_torch.models.llama, "
            "mila_tpu_torch.inference.engine, mila_tpu_torch.bridge, "
            "mila_tpu_torch.kernels.decode_fused, mila_tpu_torch.kernels.paged_attention, "
            "mila_tpu_torch.kernels.dense_attention, mila_tpu_torch.kernels.layer_fused, "
            "mila_tpu_torch.kernels.layer_stream, mila_tpu_torch.inference.generator, "
            "mila_tpu_torch.kernels.decode_giga, mila_tpu_torch.kernels.layer_mega, "
            "mila_tpu_torch.kernels.decode_mlp, mila_tpu_torch.inference.requant, "
            "mila_tpu_torch.kernels.flash_attention_bwd, mila_tpu_torch.kernels.fused_adamw, "
            "mila_tpu_torch.kernels.softmax_ce, mila_tpu_torch.nn, mila_tpu_torch.optim, "
            "mila_tpu_torch.models.gpt2, mila_tpu_torch.models.model, mila_tpu_torch.data, "
            "mila_tpu_torch.tensor.init, mila_tpu_torch.utils.rng\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'mila_tpu.'))"
            " or m == 'mila_tpu']\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr


def test_port_sources_never_import_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|mila_tpu)(\s|\.|$)", re.M)
    files = sorted((ROOT / "mila_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    offenders = [str(f) for f in files if pat.search(f.read_text())]
    assert not offenders, offenders
