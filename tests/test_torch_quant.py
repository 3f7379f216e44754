"""Quantization and ``quant_linear`` (plain path) against the JAX package.

q bytes and scales must be bit-identical. ``quant_linear`` is compared
with JAX's Pallas kernel (interpret mode on the CPU) at a tiling shape and
with its ``quant_linear_ref`` fallback at a shape that does not tile.
Tolerance: both sides accumulate bf16-exact products in f32 and differ in
summation order only; f32 outputs agree to ~1e-6 relative, bf16 outputs to
one bf16 step (2^-8), so rtol 1e-5 (f32) and 1e-2 (bf16).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mila_tpu.inference import quantize as jq
from mila_tpu.kernels.quant_matmul import quant_linear as j_quant_linear
from mila_tpu_torch.inference import quantize as tq
from mila_tpu_torch.kernels.quant_matmul import quant_linear

_TORCH = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}


def _w(seed, K, N):
    w = (np.random.default_rng(seed).standard_normal((K, N)) * 0.05).astype(np.float32)
    w[1, :7] = 0.0  # all-zero columns in a block hit the 1e-12 scale floor
    return w


@pytest.mark.parametrize("dtype", ["int8", "fp8_e4m3", "fp8_e5m2", "int4"])
@pytest.mark.parametrize("bs", [0, 64])
def test_quantize_bit_exact(dtype, bs):
    w = _w(0, 256, 384)
    a = jq.quantize(jnp.asarray(w), dtype, bs)
    b = tq.quantize(torch.from_numpy(w), dtype, bs)
    assert (a.block_size, a.packed_rows) == (b.block_size, b.packed_rows)
    np.testing.assert_array_equal(np.asarray(a.q).view(np.uint8), b.q.view(torch.uint8).numpy())
    np.testing.assert_array_equal(np.asarray(a.scale), b.scale.numpy())


def test_int4_pack_unpack_roundtrip():
    vals = np.random.default_rng(1).integers(-7, 8, (64, 48)).astype(np.int8)
    scale = np.ones((1, 48), np.float32)
    jp = jq.pack_int4(jq.QTensor(jnp.asarray(vals), jnp.asarray(scale), 64))
    tp = tq.pack_int4(tq.QTensor(torch.from_numpy(vals), torch.from_numpy(scale), 64))
    np.testing.assert_array_equal(np.asarray(jp.q), tp.q.numpy())
    np.testing.assert_array_equal(tq.unpack_int4(tp).q.numpy(), vals)
    np.testing.assert_array_equal(np.asarray(jq.unpack_int4(jp).q), tq.unpack_int4(tp).q.numpy())


def test_dequantize_matches_jax():
    w = _w(2, 128, 256)
    a, b = jq.quantize(jnp.asarray(w), "int8", 32), tq.quantize(torch.from_numpy(w), "int8", 32)
    np.testing.assert_array_equal(np.asarray(jq.dequantize(a)), tq.dequantize(b).numpy())


_LINEAR_CASES = [
    (8, 256, 384, 0, None, False),     # tiles: the Pallas kernel's arithmetic
    (64, 256, 384, 128, "gelu", True),
    (64, 256, 384, 0, "silu", False),
    (3, 256, 384, 0, None, True),      # M = 3 does not tile: quant_linear_ref
    (8, 96, 200, 0, None, False),      # K, N do not tile either
]


def _check_quant_linear(M, K, N, bs, act, bias, xdt, wdt):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = _w(4, K, N)
    b = (rng.standard_normal(N) * 0.1).astype(np.float32) if bias else None
    jx = jnp.asarray(x, xdt)
    want = j_quant_linear(jx, jq.quantize(jnp.asarray(w), wdt, bs),
                          None if b is None else jnp.asarray(b), activation=act)
    want = np.asarray(jax.device_get(want.astype(jnp.float32)))
    tx = torch.from_numpy(x).to(_TORCH[xdt])
    got = quant_linear(tx, tq.quantize(torch.from_numpy(w), wdt, bs),
                       None if b is None else torch.from_numpy(b), activation=act)
    assert got.dtype == tx.dtype and got.shape == (M, N)
    tol = 1e-5 if xdt == jnp.float32 else 1e-2
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("M,K,N,bs,act,bias", _LINEAR_CASES)
@pytest.mark.parametrize("xdt", [jnp.float32, jnp.bfloat16])
def test_quant_linear_matches_jax(M, K, N, bs, act, bias, xdt):
    _check_quant_linear(M, K, N, bs, act, bias, xdt, "int8")


# fp8 weights: JAX's kernel bit-decodes each byte into the f32 exponent and
# mantissa fields and folds 2^(127 - bias) into the scale row; the port
# converts fp8 to bf16 directly. Both are exact (fp8 subnormals included on
# the CPU), so the tolerances are the int8 cases'.
@pytest.mark.parametrize("M,K,N,bs,act,bias", _LINEAR_CASES)
@pytest.mark.parametrize("xdt", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("wdt", ["fp8_e4m3", "fp8_e5m2"])
def test_quant_linear_fp8_matches_jax(M, K, N, bs, act, bias, xdt, wdt):
    _check_quant_linear(M, K, N, bs, act, bias, xdt, wdt)


def test_quantize_model_params_skips_like_jax():
    rng = np.random.default_rng(5)
    tree = {"embed": {"wte": rng.standard_normal((128, 64)).astype(np.float32)},
            "h0": {"wq": {"weight": rng.standard_normal((64, 128)).astype(np.float32)},
                   "tiny": {"weight": rng.standard_normal((8, 8)).astype(np.float32)},
                   "ln": {"gamma": np.ones(64, np.float32)}}}
    jt = jq.quantize_model_params(jax.tree_util.tree_map(jnp.asarray, tree))
    tt = tq.quantize_model_params(
        {"embed": {"wte": torch.from_numpy(tree["embed"]["wte"])},
         "h0": {k: {n: torch.from_numpy(a) for n, a in v.items()}
                for k, v in tree["h0"].items()}}, device="cpu")
    assert isinstance(jt["h0"]["wq"]["weight"], jq.QTensor)
    assert isinstance(tt["h0"]["wq"]["weight"], tq.QTensor)
    for path in (("embed", "wte"), ("h0", "tiny", "weight"), ("h0", "ln", "gamma")):
        j, t = jt, tt
        for p in path:
            j, t = j[p], t[p]
        assert not isinstance(j, jq.QTensor) and not isinstance(t, tq.QTensor)
    np.testing.assert_array_equal(np.asarray(jt["h0"]["wq"]["weight"].q),
                                  tt["h0"]["wq"]["weight"].q.numpy())


def test_quantize_model_params_needs_a_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tq.quantize_model_params({"w": {"weight": torch.zeros(64, 64)}})
