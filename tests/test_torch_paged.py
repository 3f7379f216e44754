"""Paged KV cache: decode attention, scatter and the page allocator against
the JAX package.

JAX's ``paged_decode_attention`` runs its gather reference on the CPU, as
the JAX package's own tests run it. Tolerance: f32 softmax and products in
both, differing in summation order: 2e-5 (f32), one bf16 step (bf16).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mila_tpu.inference import kv_cache as jkv
from mila_tpu.kernels.paged_attention import paged_decode_attention as j_paged
from mila_tpu_torch.inference import kv_cache as tkv
from mila_tpu_torch.kernels.paged_attention import paged_decode_attention as t_paged


def _case(B, NH, NKV, HD, ps, W, seed):
    rng = np.random.default_rng(seed)
    P = B * W + 1
    q = rng.standard_normal((B, 1, NH, HD)).astype(np.float32)
    kp = rng.standard_normal((P, NKV, HD, ps)).astype(np.float32)
    vp = rng.standard_normal((P, NKV, HD, ps)).astype(np.float32)
    table = (1 + rng.permutation(P - 1)).reshape(B, W).astype(np.int32)  # shuffled pages
    lens = rng.integers(1, W * ps + 1, B).astype(np.int32)
    lens[0] = ps + 1  # crosses a page boundary by one token
    lens[-1] = W * ps
    return q, kp, vp, table, lens


@pytest.mark.parametrize("NH,NKV", [(4, 2), (8, 2)])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_paged_decode_attention_matches_jax(NH, NKV, dtype):
    q, kp, vp, table, lens = _case(B=4, NH=NH, NKV=NKV, HD=16, ps=8, W=5, seed=NH)
    tdt = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}[dtype]
    want = j_paged(jnp.asarray(q, dtype), jnp.asarray(kp, dtype), jnp.asarray(vp, dtype),
                   jnp.asarray(table), jnp.asarray(lens))
    got = t_paged(*(torch.from_numpy(a).to(tdt) for a in (q, kp, vp)),
                  torch.from_numpy(table), torch.from_numpy(lens))
    assert got.shape == (4, 1, NH, 16) and got.dtype == tdt
    tol = 2e-5 if dtype == jnp.float32 else 1e-2
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


def test_int8_pages_plain_matches_jax():
    q, kp, vp, table, lens = _case(B=3, NH=4, NKV=2, HD=16, ps=8, W=3, seed=9)
    rng = np.random.default_rng(10)
    kq = rng.integers(-127, 128, kp.shape).astype(np.int8)
    vq = rng.integers(-127, 128, vp.shape).astype(np.int8)
    ks = rng.random((kp.shape[0], 2, 8)).astype(np.float32) * 0.02
    vs = rng.random((kp.shape[0], 2, 8)).astype(np.float32) * 0.02
    want = j_paged(jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq), jnp.asarray(table),
                   jnp.asarray(lens), k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    got = t_paged(torch.from_numpy(q), torch.from_numpy(kq), torch.from_numpy(vq),
                  torch.from_numpy(table), torch.from_numpy(lens),
                  k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("prefill", [False, True])
def test_paged_scatter_matches_jax(dtype, prefill):
    L, P, NKV, HD, ps = 2, 6, 2, 8, 4
    rng = np.random.default_rng(11)
    lead = (2, 5) if prefill else (3,)
    # Distinct (page, offset) pairs, as the engine's page tables give.
    if prefill:
        page_ids = np.array([[1, 1, 1, 1, 2], [3, 3, 3, 3, 4]], np.int32)
        offs = np.array([[0, 1, 2, 3, 0], [0, 1, 2, 3, 0]], np.int32)
    else:
        page_ids, offs = np.array([1, 4, 2], np.int32), np.array([3, 0, 3], np.int32)
    k = rng.standard_normal(lead + (NKV, HD)).astype(np.float32)
    v = rng.standard_normal(lead + (NKV, HD)).astype(np.float32)
    jp = jkv.make_paged_pools(L, NKV, HD, P, ps, jnp.dtype(dtype))
    jp = jkv.paged_scatter(jp, 1, jnp.asarray(page_ids), jnp.asarray(offs),
                           jnp.asarray(k), jnp.asarray(v))
    tp = tkv.make_paged_pools(L, NKV, HD, P, ps, getattr(torch, dtype), "cpu")
    tp = tkv.paged_scatter(tp, 1, torch.from_numpy(page_ids), torch.from_numpy(offs),
                           torch.from_numpy(k), torch.from_numpy(v))
    assert sorted(jp) == sorted(tp)
    for name in jp:
        np.testing.assert_array_equal(tp[name].numpy(), np.asarray(jp[name]), err_msg=name)


class TestPageAllocator:
    """Mirrors tests/inference/test_paged_engine.py::TestPageAllocator."""

    def test_page0_reserved(self):
        a = tkv.PageAllocator(num_pages=8, page_size=4, max_slots=2, max_len=16)
        a.ensure(0, 16)
        assert 0 not in a.table[0].tolist()
        assert a.free_pages == 3

    def test_ensure_trim_release(self):
        a = tkv.PageAllocator(num_pages=16, page_size=4, max_slots=2, max_len=32)
        a.ensure(0, 10)
        assert a.free_pages == 12
        a.trim(0, 5)
        assert a.free_pages == 13 and int(a.table[0][2]) == 0
        a.ensure(0, 12)
        assert a.free_pages == 12
        a.release(0)
        assert a.free_pages == 15 and a.table[0].sum() == 0
        a.ensure(1, 32)
        assert a.free_pages == 7 and len(set(a.table[1].tolist())) == 8

    def test_same_pages_as_jax(self):
        ops = [("ensure", 0, 10), ("ensure", 1, 7), ("trim", 0, 3), ("ensure", 1, 20),
               ("release", 0, 0), ("ensure", 0, 30)]
        ja = jkv.PageAllocator(num_pages=20, page_size=4, max_slots=2, max_len=32)
        ta = tkv.PageAllocator(num_pages=20, page_size=4, max_slots=2, max_len=32)
        for op, slot, n in ops:
            for a in (ja, ta):
                getattr(a, op)(slot, *(() if op == "release" else (n,)))
            np.testing.assert_array_equal(ja.table, ta.table)
            assert ja.free_pages == ta.free_pages

    def test_exhaustion_and_width(self):
        a = tkv.PageAllocator(num_pages=3, page_size=4, max_slots=1, max_len=32)
        with pytest.raises(RuntimeError, match="exhausted"):
            a.ensure(0, 32)
        b = tkv.PageAllocator(num_pages=8, page_size=4, max_slots=1, max_len=8)
        with pytest.raises(RuntimeError, match="width"):
            b.ensure(0, 12)

    def test_reservations_gate_admission(self):
        a = tkv.PageAllocator(num_pages=9, page_size=4, max_slots=3, max_len=32)
        assert a.can_admit(16)
        a.reserve(0, 16)  # 4 pages promised, none used yet
        assert a.available_pages == 4
        a.reserve(1, 16)
        assert a.available_pages == 0 and not a.can_admit(1)
        with pytest.raises(RuntimeError, match="cannot reserve"):
            a.reserve(2, 4)
        a.release(0)
        assert a.can_admit(16)
