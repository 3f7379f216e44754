"""The fused greedy head ``rms_quant_linear_argmax`` (plain path) against the
JAX entry point, whose Pallas kernel runs in interpret mode on the CPU.

Cases: M 1, 8 and 32; vocab equal to, and smaller than, the padded head
width N (padded columns never win); f32 and bf16 activations; block
scales. The JAX function returns None for shapes its kernel does not take
(M > 32, vocab > N, an int4-packed head); the port returns None for the
same ones.

Tolerance: tokens are compared exactly where the top two logits of a row
(from the f32 scaled partial sums both sides argmax) are further apart
than 1e-4 of the largest; a near-tie may fall either way after a
different f32 summation order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mila_tpu.inference import quantize as jq
from mila_tpu.kernels import decode_fused as jdf
from mila_tpu_torch.inference import quantize as tq
from mila_tpu_torch.kernels import decode_fused as tdf
from mila_tpu_torch.kernels.quant_matmul import scaled_partials

_DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(M, K, N, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    g = (1.0 + 0.1 * rng.standard_normal(K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) * 0.05).astype(np.float32)
    return x, g, w


@pytest.mark.parametrize("M", [1, 8, 32])
@pytest.mark.parametrize("vocab", [1024, 900])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_argmax_matches_jax(M, vocab, dt):
    jdt, tdt = _DT[dt]
    K, N = 256, 1024
    x, g, w = _inputs(M, K, N, seed=M + vocab)
    bs = 128 if M == 8 else 0
    want = jdf.rms_quant_linear_argmax(jnp.asarray(x, jdt), jnp.asarray(g),
                                       jq.quantize(jnp.asarray(w), "int8", bs), vocab_size=vocab)
    tqt = tq.quantize(torch.from_numpy(w), "int8", bs)
    xt = torch.from_numpy(x).to(tdt)
    before = tdf.rms_quant_linear_argmax_plain.calls
    got = tdf.rms_quant_linear_argmax(xt, torch.from_numpy(g), tqt, vocab_size=vocab)
    assert tdf.rms_quant_linear_argmax_plain.calls == before + 1
    assert got.shape == (M, 1) and got.dtype == torch.int32
    assert int(got.max()) < vocab
    logits = scaled_partials(tdf._rms_scaled(xt, torch.from_numpy(g), 1e-5), tqt)[:, :vocab]
    top2 = torch.topk(logits, 2, dim=-1).values
    clear = ((top2[:, 0] - top2[:, 1]) > 1e-4 * logits.abs().max()).numpy()
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(got.numpy()[clear, 0], np.asarray(want)[clear, 0])


def test_padded_columns_never_win():
    K, N, vocab = 256, 1024, 700
    x, g, w = _inputs(4, K, N, seed=5)
    w[:, vocab:] = 10.0  # the padded tail would win every row if it counted
    got = tdf.rms_quant_linear_argmax(torch.from_numpy(x), torch.from_numpy(g),
                                      tq.quantize(torch.from_numpy(w)), vocab_size=vocab)
    want = jdf.rms_quant_linear_argmax(jnp.asarray(x), jnp.asarray(g), jq.quantize(jnp.asarray(w)),
                                       vocab_size=vocab)
    assert int(got.max()) < vocab
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_first_index_wins_ties():
    K, N = 256, 512
    x, g, _ = _inputs(2, K, N, seed=6)
    w = np.zeros((K, N), np.float32)
    w[:, [7, 300]] = 0.05  # two identical columns: equal logits
    got = tdf.rms_quant_linear_argmax(torch.from_numpy(np.abs(x)), torch.ones(K),
                                      tq.quantize(torch.from_numpy(w)), vocab_size=N)
    want = jdf.rms_quant_linear_argmax(jnp.asarray(np.abs(x)), jnp.ones(K),
                                       jq.quantize(jnp.asarray(w)), vocab_size=N)
    np.testing.assert_array_equal(got.numpy()[:, 0], [7, 7])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("case", ["m40", "vocab_gt_n", "int4"])
def test_none_where_jax_gives_none(case):
    K, N = 256, 1024
    M = 40 if case == "m40" else 8
    x, g, w = _inputs(M, K, N, seed=7)
    vocab = N + 1 if case == "vocab_gt_n" else N
    kind = "int4" if case == "int4" else "int8"
    want = jdf.rms_quant_linear_argmax(jnp.asarray(x), jnp.asarray(g),
                                       jq.quantize(jnp.asarray(w), kind), vocab_size=vocab)
    got = tdf.rms_quant_linear_argmax(torch.from_numpy(x), torch.from_numpy(g),
                                      tq.quantize(torch.from_numpy(w), kind), vocab_size=vocab)
    assert want is None and got is None
