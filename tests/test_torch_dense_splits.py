"""The sequence splits of the contiguous-cache decode attention, on the CPU.

``plan_splits`` chooses the number S of splits per (row, KV head) from
shapes on the host; each split block of the CUDA kernel reads its row's
length on the device and takes the token range ``split_tokens`` gives, and
the last split of a (row, KV head) merges the per-split partials
(unnormalised o, running max m, row sum l) with the log-sum-exp rescale, in
split order; a fused call's current token joins once, after the merge.
These tests hold the planner and the ranges to their contract and pin that
merge: plain partials over the kernel's ranges, merged as the kernel merges
them, equal the plain version over the whole row in f32 (summation order
only: 1e-6) and JAX's ``dense_decode_attention`` / ``fused_decode_attention``
through their CPU routes (the oracle ``decode_attention`` and
``_fused_decode_attention_ref``, as the JAX package's own tests run them;
2e-5). A dense row of length 0 merges to zeros, as the TPU kernel's
``l == 0`` branch gives and the CUDA kernel writes (the plain reference
averages V there, ROADMAP C.2); a fused row with no cached rows gives the
new v.
"""

import inspect
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mila_tpu.kernels import dense_attention as jda
from mila_tpu_torch.kernels import dense_attention as da

SMS = 132  # the H100 SXM's streaming multiprocessors


@pytest.mark.parametrize("B,NKV,T,sms", [
    (8, 8, 512, SMS),     # the bench's decode shape: lens 129-192 in a 512-row cache
    (1, 8, 4096, SMS),    # one long request
    (8, 8, 4224, SMS),    # serve long's max_len
    (64, 8, 512, SMS),    # enough rows to fill the card unsplit
    (3, 2, 40, SMS),      # a cache of one split
    (5, 1, 24, 16),       # shorter than a split
    (2, 1, 100000, 4),
    (1, 1, 100000, SMS),  # capped at SPLIT_MAX
])
def test_plan_splits_contract(B, NKV, T, sms):
    S = da.plan_splits(B, NKV, T, sms)
    most = max(1, min(da.SPLIT_MAX, T // da.SPLIT_MIN_TOKENS))
    assert 1 <= S <= most
    # At least SPLIT_BLOCKS_PER_SM (>= 2) x the SM count of blocks wherever a
    # full cache allows it, and no more splits than that asks.
    assert da.SPLIT_BLOCKS_PER_SM >= 2
    want = math.ceil(da.SPLIT_BLOCKS_PER_SM * sms / (B * NKV))
    assert S == min(most, max(1, want))


def test_plan_splits_ignores_the_lengths():
    # The planner sees shapes only; no argument carries the lengths, so a CUDA
    # graph captured at one set of lengths replays at any other.
    assert list(inspect.signature(da.plan_splits).parameters) == ["B", "NKV", "T", "sms"]
    assert da.plan_splits(8, 8, 512, SMS) == 5
    assert da.plan_splits(1, 8, 4096, SMS) == 33


@pytest.mark.parametrize("S", [1, 2, 5, 7, 33])
def test_split_tokens_cover_the_row_once(S):
    for length in [0, 1, 31, 32, 33, 63, 64, 129, 160, 192, 511, 512, 4095, 4096]:
        ranges = da.split_tokens(length, S)
        n = min(S, max(1, length // da.SPLIT_MIN_TOKENS))
        assert len(ranges) == n
        assert ranges[0][0] == 0 and ranges[-1][1] == length
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
        sizes = [hi - lo for lo, hi in ranges]
        assert max(sizes) - min(sizes) <= 1
        # Each split holds at least SPLIT_MIN_TOKENS tokens unless the row is shorter.
        assert min(sizes) >= min(length, da.SPLIT_MIN_TOKENS)


def _split_partials(q, k, v, lens, S):
    """Per split of the kernel's ranges: o (unnormalised), m, l in f32
    [B, NH, n_b(, HD)] lists per row; q [B, NH, HD], caches [B, T, NKV, HD]."""
    B, NH, HD = q.shape
    NKV = k.shape[2]
    G = NH // NKV
    s = torch.einsum("bhgd,bthd->bhgt", q.reshape(B, NKV, G, HD).float(), k.float())
    s = s / math.sqrt(HD)
    parts = []
    for b in range(B):
        row = []
        for lo, hi in da.split_tokens(int(lens[b]), S):
            sb = s[b, :, :, lo:hi]
            m = sb.amax(-1) if hi > lo else torch.full(sb.shape[:2], -math.inf)
            p = torch.exp(sb - m[..., None]) if hi > lo else sb
            o = torch.einsum("hgt,thd->hgd", p, v[b, lo:hi].float())
            row.append((o.reshape(NH, HD), m.reshape(NH), p.sum(-1).reshape(NH)))
        parts.append(row)
    return parts


def _merge(row, cur=None):
    """The kernel's merge of one row's partials in split order, then the
    current token (score, value) once, last."""
    o = torch.stack([r[0] for r in row])
    m = torch.stack([r[1] for r in row])
    l = torch.stack([r[2] for r in row])
    M = m.amax(0)
    w = torch.exp(m - torch.where(torch.isinf(M), 0.0, M))
    w = torch.where(torch.isinf(m), 0.0, w)
    L, O = (l * w).sum(0), (o * w[..., None]).sum(0)
    if cur is not None:
        sc, vn = cur
        Mf = torch.maximum(M, sc)
        al, pc = torch.exp(M - Mf), torch.exp(sc - Mf)
        L, O = L * al + pc, O * al[:, None] + pc[:, None] * vn
    return torch.where(L[:, None] > 0, O / L.clamp_min(1e-30)[:, None], 0.0)


def _case(B, NH, NKV, HD, T, seed):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((B, NH, HD)).astype(np.float32))
    # bf16 values held in f32: the merge is checked in f32.
    k = torch.from_numpy(rng.standard_normal((B, T, NKV, HD)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((B, T, NKV, HD)).astype(np.float32))
    return q.bfloat16().float(), k.bfloat16().float(), v.bfloat16().float()


# Lengths 0, 1, a split edge +- 1 and a full cache in one batch, under the
# planner's S for the shape and under a forced S.
_EDGE = [0, 1, 31, 32, 33, 64, 65, 159, 160, 161, 192, 256]


@pytest.mark.parametrize("NH,NKV,HD,S", [
    (8, 2, 16, None),   # the planner's S for B 12, T 256 (8)
    (32, 8, 64, 5),     # Llama-3.2-1B's heads, the bench shape's S
    (8, 8, 8, 33),      # G 1, more splits than most rows take
])
def test_merged_split_partials_equal_the_whole_row(NH, NKV, HD, S):
    B, T = len(_EDGE), 256
    S = S or da.plan_splits(B, NKV, T, SMS)
    assert S > 1
    q, k, v = _case(B, NH, NKV, HD, T, seed=HD + S)
    lens = torch.tensor(_EDGE, dtype=torch.int32)
    parts = _split_partials(q, k, v, lens, S)
    merged = torch.stack([_merge(row) for row in parts])
    whole = da.dense_decode_attention_plain(q, k, v, lens)
    live = lens > 0
    np.testing.assert_allclose(merged[live].numpy(), whole[live].numpy(), rtol=1e-6, atol=1e-6)
    assert torch.equal(merged[~live], torch.zeros_like(merged[~live]))


def test_merged_split_partials_match_jax():
    B, NH, NKV, HD, T = len(_EDGE), 32, 8, 64, 256
    S = da.plan_splits(B, NKV, T, SMS)
    q, k, v = _case(B, NH, NKV, HD, T, seed=3)
    lens = torch.tensor(_EDGE, dtype=torch.int32).clamp_min(1)  # JAX's oracle averages V at 0
    merged = torch.stack([_merge(row) for row in _split_partials(q, k, v, lens, S)])
    want = jda.dense_decode_attention(*(jnp.asarray(t.numpy()) for t in (q, k, v, lens)))
    np.testing.assert_allclose(merged.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def _tables(old, HD, NKV, theta=10000.0):
    d2 = HD // 2
    inv = 1.0 / (theta ** (np.arange(d2, dtype=np.float32) / d2))
    ang = old[:, None].astype(np.float32) * inv[None]
    c2, s2 = np.cos(ang), np.sin(ang)
    cos_t = np.tile(np.concatenate([c2, c2], -1), (1, NKV)).astype(np.float32)
    sin_t = np.tile(np.concatenate([-s2, s2], -1), (1, NKV)).astype(np.float32)
    return torch.from_numpy(cos_t), torch.from_numpy(sin_t)


def test_fused_merge_counts_the_current_token_once():
    # Partials over the old rows only (the kernel's splits never read row
    # old_lens[b]), merged in split order, then the roped current token once:
    # equal to the plain version, which writes the new row and attends over
    # old + 1 rows, and to JAX's fused reference. A row with no cached rows
    # gives the new v.
    B, NH, NKV, HD, T = len(_EDGE), 32, 8, 64, 264
    KD, NQ = NKV * HD, NH * HD
    S = da.plan_splits(B, NKV, T, SMS)
    assert S > 1
    rng = np.random.default_rng(11)
    qkv = torch.from_numpy(rng.standard_normal((B, NQ + 2 * KD)).astype(np.float32))
    _, k, v = _case(B, NH, NKV, HD, T, seed=12)
    old = np.array(_EDGE, np.int32)
    cos_t, sin_t = _tables(old, HD, NKV)
    kp, vp = k.clone(), v.clone()
    att, k_new, _, _ = da.fused_decode_attention_plain(qkv, cos_t, sin_t, kp, vp,
                                                       torch.from_numpy(old), num_heads=NH)
    q = da._rope_flat(qkv[:, :NQ], cos_t[:, :HD].repeat(1, NH), sin_t[:, :HD].repeat(1, NH), HD)
    q = q.reshape(B, NH, HD)
    parts = _split_partials(q, k, v, torch.from_numpy(old), S)
    kn = k_new.reshape(B, NKV, HD)
    vn = qkv[:, NQ + KD:].reshape(B, NKV, HD)
    merged = []
    for b in range(B):
        cur = (torch.einsum("hgd,hd->hg", q[b].reshape(NKV, NH // NKV, HD), kn[b]).reshape(NH)
               / math.sqrt(HD), vn[b].repeat_interleave(NH // NKV, 0))
        merged.append(_merge(parts[b], cur))
    merged = torch.stack(merged)
    np.testing.assert_allclose(merged.numpy(), att.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(merged[0].numpy(), vn[0].repeat_interleave(NH // NKV, 0))
    want = jda.fused_decode_attention(
        jnp.asarray(qkv.numpy()), None, jnp.asarray(cos_t.numpy()), jnp.asarray(sin_t.numpy()),
        jnp.asarray(k.numpy()), jnp.asarray(v.numpy()), jnp.asarray(old), num_heads=NH)
    np.testing.assert_allclose(merged.numpy(), np.asarray(want[0]), rtol=2e-5, atol=2e-5)
