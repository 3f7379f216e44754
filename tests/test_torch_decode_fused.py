"""The three decode entry points (plain path) against the JAX Pallas kernels
in interpret mode, at decode shapes (M in {1, 8}, K 256, N 512) and at a
shape where both sides fall back to the unfused ops (M 40 > 32).

Tolerance: the same bf16-rounded operands, f32 accumulation in another
order: f32 outputs within 1e-5, bf16 outputs within one bf16 step (1e-2).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mila_tpu.inference import quantize as jq
from mila_tpu.kernels import decode_fused as jdf
from mila_tpu_torch.inference import quantize as tq
from mila_tpu_torch.kernels import decode_fused as tdf

_TORCH = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}


def _inputs(M, K, N, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    g = (1.0 + 0.1 * rng.standard_normal(K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) * 0.05).astype(np.float32)
    r = rng.standard_normal((M, N)).astype(np.float32)
    return x, g, w, r


def _check(got, want, xdt):
    assert got.dtype == _TORCH[xdt]
    tol = 1e-5 if xdt == jnp.float32 else 1e-2
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("M", [1, 8, 40])
@pytest.mark.parametrize("xdt", [jnp.float32, jnp.bfloat16])
def test_rms_quant_linear(M, xdt):
    x, g, w, _ = _inputs(M, 256, 512)
    want = jdf.rms_quant_linear(jnp.asarray(x, xdt), jnp.asarray(g),
                                jq.quantize(jnp.asarray(w)), eps=1e-5)
    got = tdf.rms_quant_linear(torch.from_numpy(x).to(_TORCH[xdt]), torch.from_numpy(g),
                               tq.quantize(torch.from_numpy(w)), eps=1e-5)
    _check(got, want, xdt)


@pytest.mark.parametrize("M", [1, 8, 40])
@pytest.mark.parametrize("xdt", [jnp.float32, jnp.bfloat16])
def test_quant_linear_residual(M, xdt):
    x, _, w, r = _inputs(M, 256, 512, seed=1)
    want = jdf.quant_linear_residual(jnp.asarray(x, xdt), jq.quantize(jnp.asarray(w)),
                                     jnp.asarray(r, xdt))
    got = tdf.quant_linear_residual(torch.from_numpy(x).to(_TORCH[xdt]),
                                    tq.quantize(torch.from_numpy(w)),
                                    torch.from_numpy(r).to(_TORCH[xdt]))
    _check(got, want, xdt)


@pytest.mark.parametrize("M", [1, 8, 40])
@pytest.mark.parametrize("xdt", [jnp.float32, jnp.bfloat16])
def test_rms_quant_linear_swiglu(M, xdt):
    x, g, w, _ = _inputs(M, 256, 2 * 512, seed=2)
    want = jdf.rms_quant_linear_swiglu(jnp.asarray(x, xdt), jnp.asarray(g),
                                       jq.quantize(jnp.asarray(w)), eps=1e-5)
    got = tdf.rms_quant_linear_swiglu(torch.from_numpy(x).to(_TORCH[xdt]),
                                      torch.from_numpy(g), tq.quantize(torch.from_numpy(w)),
                                      eps=1e-5)
    assert got.shape == (M, 512)
    _check(got, want, xdt)


# fp8 weights (JAX: its kernels' bit decode with the scale fixup; the port:
# fp8 -> bf16 directly, both exact): the int8 cases' tolerances.
_FP8 = ["fp8_e4m3", "fp8_e5m2"]


@pytest.mark.parametrize("M", [1, 8, 40])
@pytest.mark.parametrize("xdt", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("wdt", _FP8)
def test_rms_quant_linear_fp8(M, xdt, wdt):
    x, g, w, _ = _inputs(M, 256, 512)
    want = jdf.rms_quant_linear(jnp.asarray(x, xdt), jnp.asarray(g),
                                jq.quantize(jnp.asarray(w), wdt), eps=1e-5)
    got = tdf.rms_quant_linear(torch.from_numpy(x).to(_TORCH[xdt]), torch.from_numpy(g),
                               tq.quantize(torch.from_numpy(w), wdt), eps=1e-5)
    _check(got, want, xdt)


@pytest.mark.parametrize("M", [1, 8, 40])
@pytest.mark.parametrize("xdt", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("wdt", _FP8)
def test_quant_linear_residual_fp8(M, xdt, wdt):
    x, _, w, r = _inputs(M, 256, 512, seed=1)
    want = jdf.quant_linear_residual(jnp.asarray(x, xdt), jq.quantize(jnp.asarray(w), wdt),
                                     jnp.asarray(r, xdt))
    got = tdf.quant_linear_residual(torch.from_numpy(x).to(_TORCH[xdt]),
                                    tq.quantize(torch.from_numpy(w), wdt),
                                    torch.from_numpy(r).to(_TORCH[xdt]))
    _check(got, want, xdt)


@pytest.mark.parametrize("M", [1, 8, 40])
@pytest.mark.parametrize("xdt", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("wdt", _FP8)
def test_rms_quant_linear_swiglu_fp8(M, xdt, wdt):
    x, g, w, _ = _inputs(M, 256, 2 * 512, seed=2)
    want = jdf.rms_quant_linear_swiglu(jnp.asarray(x, xdt), jnp.asarray(g),
                                       jq.quantize(jnp.asarray(w), wdt), eps=1e-5)
    got = tdf.rms_quant_linear_swiglu(torch.from_numpy(x).to(_TORCH[xdt]),
                                      torch.from_numpy(g), tq.quantize(torch.from_numpy(w), wdt),
                                      eps=1e-5)
    assert got.shape == (M, 512)
    _check(got, want, xdt)


@pytest.mark.parametrize("M", [1, 8, 32])
@pytest.mark.parametrize("bs", [0, 128])
@pytest.mark.parametrize("wdt", _FP8)
def test_argmax_head_fp8(M, bs, wdt):
    """The greedy head over fp8 weights: tokens equal JAX's wherever a row's
    top two logits are further apart than 1e-4 of the largest."""
    from mila_tpu_torch.kernels.quant_matmul import scaled_partials

    K, N, vocab = 256, 1024, 900
    x, g, w, _ = _inputs(M, K, N, seed=5 + M)
    want = jdf.rms_quant_linear_argmax(jnp.asarray(x), jnp.asarray(g),
                                       jq.quantize(jnp.asarray(w), wdt, bs), vocab_size=vocab)
    tqt = tq.quantize(torch.from_numpy(w), wdt, bs)
    xt, gt = torch.from_numpy(x), torch.from_numpy(g)
    got = tdf.rms_quant_linear_argmax(xt, gt, tqt, vocab_size=vocab)
    assert got.shape == (M, 1) and got.dtype == torch.int32 and int(got.max()) < vocab
    logits = scaled_partials(tdf._rms_scaled(xt, gt, 1e-5), tqt)[:, :vocab]
    top2 = torch.topk(logits, 2, dim=-1).values
    clear = ((top2[:, 0] - top2[:, 1]) > 1e-4 * logits.abs().max()).numpy()
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(got.numpy()[clear, 0], np.asarray(want)[clear, 0])


def test_block_scales_match_jax():
    x, g, w, r = _inputs(8, 256, 512, seed=3)
    jqt, tqt = jq.quantize(jnp.asarray(w), "int8", 128), tq.quantize(torch.from_numpy(w), "int8", 128)
    want = jdf.rms_quant_linear(jnp.asarray(x), jnp.asarray(g), jqt)
    got = tdf.rms_quant_linear(torch.from_numpy(x), torch.from_numpy(g), tqt)
    _check(got, want, jnp.float32)


def test_plain_versions_count_and_cpu_never_launches():
    x, g, w, r = _inputs(8, 256, 512, seed=4)
    qt = tq.quantize(torch.from_numpy(w))
    before = (tdf.rms_quant_linear.launches, tdf.rms_quant_linear_plain.calls)
    tdf.rms_quant_linear(torch.from_numpy(x), torch.from_numpy(g), qt)
    assert tdf.rms_quant_linear.launches == before[0]
    assert tdf.rms_quant_linear_plain.calls == before[1] + 1


# Llama-3.2-1B's decode projections: (K, output columns, SwiGLU).
_SERVED = {"wqkv": (2048, 3072, False), "wo": (2048, 2048, False), "wgu": (2048, 8192, True),
           "down": (8192, 2048, False), "head": (2048, 129024, False)}


def test_ksplit_plan_covers_the_served_shapes():
    """qgemv_int8's launch plan (pure host arithmetic) at Llama-3.2-1B's
    five shapes, M 1/8/32, per-channel and 128-row scale blocks: at most 8
    K slices (one portable cluster) covering K once in multiples of the
    32-row stage, x's staged slice within its budget, more than one slice
    only while the grid stays within one block per SM (or x forces it); a
    slice may span several scale blocks."""
    for K, n_out, swiglu in _SERVED.values():
        tiles = -(-n_out // (tdf.INT8_COLS // 2 if swiglu else tdf.INT8_COLS))
        for M in (1, 8, 32):
            for bs in (K, 128):
                mt, ks = tdf.plan_qgemv(M, K, n_out, bs, 132, swiglu)
                kc = K // ks
                assert M <= mt <= 32 and ks in (1, 2, 4, 8) and ks * kc == K
                assert kc % tdf.INT8_STAGE_ROWS == 0
                assert tdf._int8_x_bytes(M, kc) <= tdf.INT8_X_BYTES
                assert (ks == 1 or tiles * ks <= 132
                        or tdf._int8_x_bytes(M, 2 * kc) > tdf.INT8_X_BYTES)
    assert tdf.plan_qgemv(8, 2048, 3072, 2048, 132) == (8, 8)
    assert tdf.plan_qgemv(8, 2048, 2048, 2048, 132) == (8, 8)
    assert tdf.plan_qgemv(8, 2048, 8192, 2048, 132, swiglu=True) == (8, 2)
    assert tdf.plan_qgemv(8, 8192, 2048, 8192, 132) == (8, 8)
    assert tdf.plan_qgemv(8, 2048, 129024, 2048, 132) == (8, 1)
    assert tdf.plan_qgemv(32, 2048, 129024, 2048, 132) == (32, 2)  # x's slice forces 2
    assert tdf.plan_qgemv(8, 2048, 3072, 128, 132) == (8, 8)  # 256-row slices, 2 scale blocks
    with pytest.raises(ValueError):
        tdf.plan_qgemv(8, 2048, 3072, 16, 132)  # scale blocks thinner than a stage
