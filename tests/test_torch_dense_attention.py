"""Contiguous-cache decode attention: the port against the JAX package.

``decode_attention`` and ``dense_decode_attention`` (plain path) against
``mila_tpu.ops.decode_attention`` and JAX's ``dense_decode_attention`` (its
CPU route is that oracle), with ragged lengths including 1 and T;
``pack_queries`` against JAX's; ``fused_decode_attention`` (plain path)
against JAX's on the CPU (``_fused_decode_attention_ref``): the output, the
roped new k and the cache rows written, with an ``old_lens`` of 0.

Tolerances: f32 on both sides with the same formulas, summation order
apart: atol/rtol 2e-5 (softmax over up to 64 keys). In bf16 one rounding of
the output or of the probabilities may differ by one bf16 step: 1e-2.
The written cache rows are equal: the same roped values, cast once.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mila_tpu.kernels import dense_attention as jda
from mila_tpu.ops import attention as jatt
from mila_tpu_torch.kernels import dense_attention as tda
from mila_tpu_torch.ops import attention as tatt

_DT = {"f32": (jnp.float32, torch.float32, 2e-5), "bf16": (jnp.bfloat16, torch.bfloat16, 1e-2)}


def _np(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _to_np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _case(B=3, NKV=2, NH=8, T=64, HD=32, seed=0):
    return _np(seed, B, 1, NH, HD), _np(seed + 1, B, T, NKV, HD), _np(seed + 2, B, T, NKV, HD)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_decode_attention_matches_jax(dt):
    jdt, tdt, tol = _DT[dt]
    q, k, v = _case()
    lens = np.array([1, 17, 64], np.int32)
    want = jatt.decode_attention(jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
                                 jnp.asarray(lens))
    got = tatt.decode_attention(torch.from_numpy(q).to(tdt), torch.from_numpy(k).to(tdt),
                                torch.from_numpy(v).to(tdt), torch.from_numpy(lens))
    assert got.dtype == tdt and got.shape == (3, 1, 8, 32)
    np.testing.assert_allclose(got.float().numpy(), _to_np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("lens", [[1, 17, 64], [64, 64, 64], [1, 1, 1], [33, 2, 63]])
@pytest.mark.parametrize("squeeze", [True, False])
def test_dense_decode_attention_matches_jax(lens, squeeze):
    q, k, v = _case(seed=3)
    ln = np.array(lens, np.int32)
    qj, qt = jnp.asarray(q), torch.from_numpy(q)
    if not squeeze:
        qj, qt = qj[:, 0], qt[:, 0]
    want = jda.dense_decode_attention(qj, jnp.asarray(k), jnp.asarray(v), jnp.asarray(ln))
    before = tda.dense_decode_attention_plain.calls
    got = tda.dense_decode_attention(qt, torch.from_numpy(k), torch.from_numpy(v),
                                     torch.from_numpy(ln))
    assert tda.dense_decode_attention_plain.calls == before + 1
    assert got.shape == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_pack_queries_matches_jax():
    q = _np(6, 2, 8, 16)
    want = jda.pack_queries(jnp.asarray(q), 2)
    got = tda.pack_queries(torch.from_numpy(q), 2)
    assert got.shape == (2, 8, 32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _tables(old_lens, HD, NKV, theta=10000.0):
    d2 = HD // 2
    inv = 1.0 / (theta ** (np.arange(d2, dtype=np.float32) / d2))
    ang = old_lens[:, None].astype(np.float32) * inv[None]
    c2, s2 = np.cos(ang), np.sin(ang)
    cos_t = np.tile(np.concatenate([c2, c2], -1), (1, NKV)).astype(np.float32)
    sin_t = np.tile(np.concatenate([-s2, s2], -1), (1, NKV)).astype(np.float32)
    return cos_t, sin_t


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_fused_decode_attention_matches_jax(dt):
    jdt, tdt, tol = _DT[dt]
    B, NKV, NH, T, HD = 3, 2, 8, 64, 32
    KD, NQ = NKV * HD, NH * HD
    qkv = _np(7, B, NQ + 2 * KD)
    kc, vc = _np(8, B, T, NKV, HD), _np(9, B, T, NKV, HD)
    old_lens = np.array([0, 17, 63], np.int32)
    cos_t, sin_t = _tables(old_lens, HD, NKV)
    want = jda.fused_decode_attention(
        jnp.asarray(qkv, jdt), None, jnp.asarray(cos_t), jnp.asarray(sin_t),
        jnp.asarray(kc, jdt), jnp.asarray(vc, jdt), jnp.asarray(old_lens), num_heads=NH)
    tk, tv = torch.from_numpy(kc).to(tdt), torch.from_numpy(vc).to(tdt)
    att, k_new, k_out, v_out = tda.fused_decode_attention(
        torch.from_numpy(qkv).to(tdt), None, torch.from_numpy(cos_t), torch.from_numpy(sin_t),
        tk, tv, torch.from_numpy(old_lens), num_heads=NH)
    assert k_out is tk and v_out is tv  # written in place
    assert att.shape == (B, NH, HD) and k_new.shape == (B, KD) and k_new.dtype == tdt
    np.testing.assert_allclose(att.float().numpy(), _to_np(want[0]), rtol=tol, atol=tol)
    np.testing.assert_array_equal(k_new.float().numpy(), _to_np(want[1]))
    np.testing.assert_array_equal(tk.float().numpy(), _to_np(want[2]))
    np.testing.assert_array_equal(tv.float().numpy(), _to_np(want[3]))
    # Row old_lens[b] holds the new row; every other row is unchanged.
    rows = np.arange(B)
    np.testing.assert_array_equal(tk.float().numpy()[rows, old_lens].reshape(B, KD),
                                  k_new.float().numpy())
    untouched = np.ones((B, T), bool)
    untouched[rows, old_lens] = False
    np.testing.assert_array_equal(tv.float().numpy()[untouched],
                                  torch.from_numpy(vc).to(tdt).float().numpy()[untouched])
