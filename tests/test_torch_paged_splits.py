"""The sequence splits of the paged decode attention kernel, on the CPU.

``plan_splits`` chooses the number of splits per (row, KV head) on the host
and ``split_pages`` gives each split's pages; the CUDA kernel computes the
same bounds and merges its per-split partials (unnormalised o, running max
m, row sum l) with the log-sum-exp rescale. These tests hold the planner to
its contract and pin that merge: the plain version over a whole row equals
the merge of plain partials over the planner's splits, in f32 (summation
order only: 1e-6), and equals JAX's ``paged_decode_attention`` (its gather
reference on the CPU, as the JAX package's own tests run it; 2e-5). A row
of length 0 merges to zeros, as the TPU kernel's ``l == 0`` branch gives
and the CUDA kernel writes; the plain gather reference gives the mean of V
there (ROADMAP C.2).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mila_tpu.kernels.paged_attention import paged_decode_attention as j_paged
from mila_tpu_torch.kernels import paged_attention as pa

SMS = 132  # the H100 SXM's streaming multiprocessors


@pytest.mark.parametrize("B,NKV,W,ps,sms", [
    (8, 8, 32, 128, SMS),   # serve long: B 8, lens <= 4096
    (8, 8, 33, 128, SMS),   # the engine's table for max_len 4224
    (8, 8, 4, 128, SMS),    # serve paged: lens <= 384 (pages allow only 4)
    (1, 8, 32, 128, SMS),   # one long request
    (16, 8, 40, 16, SMS),   # small pages: 8 pages make a 128-token split
    (3, 2, 4, 16, SMS),     # the whole row under 128 tokens: one split
    (64, 8, 16, 128, SMS),  # enough rows to fill the card unsplit
    (2, 1, 1, 128, 4),
    (5, 1, 7, 24, 16),      # ps not a power of two
])
def test_plan_splits_contract(B, NKV, W, ps, sms):
    S = pa.plan_splits(B, NKV, W, ps, sms)
    assert 1 <= S <= W
    bounds = pa.split_pages(W, S)
    # Page-aligned splits covering [0, W * ps) exactly once, in order.
    assert bounds[0][0] == 0 and bounds[-1][1] == W
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    min_pages = min(W, math.ceil(pa.SPLIT_MIN_TOKENS / ps))
    assert all(hi - lo >= min_pages for lo, hi in bounds)  # each at least a 128-token chunk
    # At least SPLIT_BLOCKS_PER_SM (>= 2) x the SM count of blocks wherever the
    # pages allow it.
    assert pa.SPLIT_BLOCKS_PER_SM >= 2
    most = W // min_pages
    if B * NKV * most >= pa.SPLIT_BLOCKS_PER_SM * sms:
        assert B * NKV * S >= pa.SPLIT_BLOCKS_PER_SM * sms
    else:
        assert S == most


def test_plan_splits_ignores_the_lengths():
    # The planner sees shapes only; no argument carries seq_lens, so a CUDA
    # graph captured at one set of lengths replays at any other.
    import inspect

    assert list(inspect.signature(pa.plan_splits).parameters) == ["B", "NKV", "W", "ps", "sms"]
    assert pa.plan_splits(8, 8, 32, 128, SMS) == 9


def _pages(rng, P, NKV, HD, ps, int8):
    if int8:
        kp = torch.from_numpy(rng.integers(-127, 128, (P, NKV, HD, ps)).astype(np.int8))
        vp = torch.from_numpy(rng.integers(-127, 128, (P, NKV, HD, ps)).astype(np.int8))
        ks = torch.from_numpy(rng.uniform(0.002, 0.02, (P, NKV, ps)).astype(np.float32))
        vs = torch.from_numpy(rng.uniform(0.002, 0.02, (P, NKV, ps)).astype(np.float32))
        return kp, vp, {"k_scale": ks, "v_scale": vs}
    # bf16 values held in f32: the merge is checked in f32.
    kp = torch.from_numpy(rng.standard_normal((P, NKV, HD, ps)).astype(np.float32))
    vp = torch.from_numpy(rng.standard_normal((P, NKV, HD, ps)).astype(np.float32))
    return kp.bfloat16().float(), vp.bfloat16().float(), {}


def _split_partials(q, kp, vp, table, lens, S, k_scale=None, v_scale=None):
    """Per split: o (unnormalised), m, l in f32 [B, NH, S(, HD)], with the
    pages dequantized as the plain version does."""
    B, _, NH, HD = q.shape
    P, NKV, _, ps = kp.shape
    W, G = table.shape[1], NH // NKV
    k, v = kp.float(), vp.float()
    if k_scale is not None:
        k, v = k * k_scale[:, :, None, :], v * v_scale[:, :, None, :]
    tbl = table.long()
    k = k[tbl].permute(0, 2, 1, 4, 3).reshape(B, NKV, W * ps, HD)
    v = v[tbl].permute(0, 2, 1, 4, 3).reshape(B, NKV, W * ps, HD)
    s = torch.einsum("bhgd,bhtd->bhgt", q.reshape(B, NKV, G, HD).float(), k) / math.sqrt(HD)
    pos = torch.arange(W * ps)
    os_, ms, ls = [], [], []
    for lo, hi in pa.split_pages(W, S):
        live = (pos >= lo * ps) & (pos < hi * ps) & (pos[None] < lens[:, None].long())
        live = live[:, None, None]
        m = torch.where(live, s, -math.inf).amax(-1)
        p = torch.where(live, torch.exp(s - torch.where(torch.isinf(m), 0.0, m)[..., None]), 0.0)
        os_.append(torch.einsum("bhgt,bhtd->bhgd", p, v).reshape(B, NH, HD))
        ms.append(m.reshape(B, NH))
        ls.append(p.sum(-1).reshape(B, NH))
    return torch.stack(os_, 2), torch.stack(ms, 2), torch.stack(ls, 2)


def _merge(o, m, l):
    """The CUDA combine: weights exp(m_s - max m), empty splits skipped."""
    M = m.amax(-1, keepdim=True)
    w = torch.where(l > 0, torch.exp(m - torch.where(torch.isinf(M), 0.0, M)), 0.0)
    L, O = (l * w).sum(-1), (o * w[..., None]).sum(-2)
    out = torch.where(L[..., None] > 0, O / L.clamp_min(1e-30)[..., None], 0.0)
    return out[:, None]


def _edge_case(int8, NH, NKV, HD, ps, W, seed):
    """16 rows: lengths 0, 1, ps - 1, ps, ps + 1, W ps and every split end
    +- 1 under the planner's S for B 16, the rest random."""
    B = 16
    S = pa.plan_splits(B, NKV, W, ps, SMS)
    ends = [hi * ps for _, hi in pa.split_pages(W, S)]
    edge = sorted({x for x in [0, 1, ps - 1, ps, ps + 1, W * ps]
                   + [e + d for e in ends for d in (-1, 0, 1)] if 0 <= x <= W * ps})
    rng = np.random.default_rng(seed)
    lens = np.concatenate([edge, rng.integers(1, W * ps + 1, max(0, B - len(edge)))])
    rows = []
    for i in range(0, len(lens), B):  # more edges than rows: another batch of 16
        chunk = lens[i:i + B]
        chunk = np.concatenate([chunk, rng.integers(1, W * ps + 1, B - len(chunk))])
        rows.append(torch.from_numpy(chunk.astype(np.int32)))
    P = B * W + 1
    q = torch.from_numpy(rng.standard_normal((B, 1, NH, HD)).astype(np.float32))
    kp, vp, sc = _pages(rng, P, NKV, HD, ps, int8)
    table = torch.from_numpy((1 + rng.permutation(P - 1)).reshape(B, W).astype(np.int32))
    return S, q, kp, vp, sc, table, rows


@pytest.mark.parametrize("int8", [False, True], ids=["bf16_pages", "int8_pages"])
@pytest.mark.parametrize("NH,NKV,HD,ps,W", [
    (8, 2, 16, 128, 8),   # 128-token pages: 2 splits for B 16
    (16, 2, 32, 16, 24),  # 16-token pages, 8 per split
    (8, 8, 8, 8, 64),     # G 1, 8-token pages
])
def test_merged_split_partials_equal_the_whole_row(int8, NH, NKV, HD, ps, W):
    S, q, kp, vp, sc, table, rows = _edge_case(int8, NH, NKV, HD, ps, W, seed=W + HD)
    assert S > 1
    for lens in rows:
        merged = _merge(*_split_partials(q, kp, vp, table, lens, S, **sc))
        whole = pa.paged_decode_attention_plain(q, kp, vp, table, lens, **sc)
        live = lens > 0
        np.testing.assert_allclose(merged[live].numpy(), whole[live].numpy(),
                                   rtol=1e-6, atol=1e-6)
        assert torch.equal(merged[~live], torch.zeros_like(merged[~live]))


@pytest.mark.parametrize("int8", [False, True], ids=["bf16_pages", "int8_pages"])
def test_merged_split_partials_match_jax(int8):
    S, q, kp, vp, sc, table, rows = _edge_case(int8, 8, 2, 16, 16, 24, seed=3)
    lens = rows[0].clamp_min(1)  # JAX's gather reference averages V at length 0
    merged = _merge(*_split_partials(q, kp, vp, table, lens, S, **sc))
    jsc = {k: jnp.asarray(v.numpy()) for k, v in sc.items()}
    want = j_paged(*(jnp.asarray(t.numpy()) for t in (q, kp, vp, table, lens)), **jsc)
    np.testing.assert_allclose(merged.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
