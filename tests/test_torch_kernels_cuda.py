"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``requires_cuda``: without a CUDA device these tests skip (decided in
a fixture, never at import). Run them on a GPU machine with
``python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q``
(``tests/conftest.py`` imports JAX, which a GPU machine need not have).
``chip_smoke.py`` repeats these checks at the served shapes.

Tolerances: both sides see the same bf16-rounded operands and accumulate
in f32, in different orders. Outputs rounded to bf16 may then differ by one
bf16 step (2^-8 relative); we allow 2e-2 of the output's max magnitude.
The layer tail's plain version is the JAX package's reference, which
rounds more often than the kernel (see ``kernels/layer_fused.py``): the
same 2e-2, and so for the per-layer megakernel (``_mega_ref``) and the
MLP-block stream. The argmax head's token must carry a plain logit within
1e-3 of the row's largest (f32 sums in another order may swap near-ties).
The whole-step giga kernel keeps the residual in f32 where its plain
version (``_giga_ref``) rounds it to bf16 at every layer, so it is held to
the JAX package's own gate for it (``benchmarks/r5_giga.py``): greedy
tokens agree on at least 7/8 of the rows, logits within 5e-2 * max(1, L/4)
+ 5e-2 relative, the written K/V rows within 2e-2 of their largest value.
"""

import ctypes

import numpy as np
import pytest
import torch

from mila_tpu_torch.inference.quantize import quantize, unit_qtensor
from mila_tpu_torch.kernels import decode_fused as df
from mila_tpu_torch.kernels import decode_giga as dg
from mila_tpu_torch.kernels import decode_mlp as dm
from mila_tpu_torch.kernels import dense_attention as da
from mila_tpu_torch.kernels import layer_fused as lf
from mila_tpu_torch.kernels import layer_mega as lm
from mila_tpu_torch.kernels import layer_stream as ls
from mila_tpu_torch.kernels import paged_attention as pa
from mila_tpu_torch.kernels import quant_matmul as qm

pytestmark = pytest.mark.requires_cuda


@pytest.fixture(autouse=True)
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the port's kernels run only on the GPU")
    return torch.device("cuda")


def _close(got, want, rel=2e-2):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    err = (got - want).abs().max().item()
    ref = want.abs().max().item() + 1e-6
    assert err <= rel * ref, f"max abs err {err} vs max |ref| {ref}"


def _rand(shape, seed, scale=1.0, dtype=torch.bfloat16, device="cuda"):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * scale).to(
        device=device, dtype=dtype)


# Ragged M (1, 17, 33, 1000, 4096 rows) against N 136 (the cp.async weight
# route: N % 16 == 8), 3072 and 16384; per-channel, 128- and 16-row scale
# blocks; bias with GELU or SiLU; bf16 and f32 out.
_QL_GRID = [(M, 1024, N, 0, ("gelu", "silu", None)[i % 3], (torch.bfloat16, torch.float32)[i % 2])
            for i, (M, N) in enumerate((M, N) for M in (1, 17, 33, 1000, 4096)
                                       for N in (136, 3072, 16384))]
_QL_BLOCKS = [(M, 512, N, bs, act, dtype) for M, N, bs, act, dtype in (
    (1, 3072, 128, None, torch.bfloat16), (17, 136, 16, "silu", torch.float32),
    (33, 16384, 128, "gelu", torch.bfloat16), (1000, 3072, 16, None, torch.bfloat16),
    (4096, 136, 128, "silu", torch.float32), (1000, 16384, 128, "gelu", torch.float32))]


@pytest.mark.parametrize("M,K,N,bs,act,dtype", [
    (64, 256, 384, 0, None, torch.bfloat16),
    (100, 512, 520, 128, "gelu", torch.bfloat16),
    (1024, 2048, 3072, 0, None, torch.bfloat16),
    (37, 256, 128, 64, "silu", torch.float32),
    (200, 96, 264, 32, "gelu", torch.bfloat16),  # K % 64 == 32: a half last K step
] + _QL_GRID + _QL_BLOCKS)
def test_quant_linear_kernel(cuda, M, K, N, bs, act, dtype):
    x = _rand((M, K), 0, dtype=dtype)
    qt = quantize(_rand((K, N), 1, 0.05, torch.float32), "int8", bs)
    bias = _rand((N,), 2, 0.1, torch.float32) if act else None
    before = qm.quant_linear.launches
    got = qm.quant_linear(x, qt, bias, activation=act)
    torch.cuda.synchronize()
    assert qm.quant_linear.launches == before + 1
    y = qm.scaled_partials(x.to(torch.bfloat16), qt)
    if bias is not None:
        y = y + bias
    _close(got, qm.activate(y, act).to(dtype))


@pytest.mark.parametrize("M,K,N,bs,dtype", [
    (1, 256, 512, 0, torch.bfloat16),
    (8, 2048, 3072, 0, torch.bfloat16),
    (8, 8192, 2048, 0, torch.bfloat16),
    (20, 512, 384, 128, torch.float32),
    (5, 384, 520, 0, torch.bfloat16),  # ragged last column tile, 192-row K slices
])
def test_decode_kernels(cuda, M, K, N, bs, dtype):
    x = _rand((M, K), 3, dtype=dtype)
    gamma = 1.0 + _rand((K,), 4, 0.1, torch.float32)
    qt = quantize(_rand((K, N), 5, 0.05, torch.float32), "int8", bs)
    res = _rand((M, N), 6, dtype=dtype)
    _close(df.rms_quant_linear(x, gamma, qt), df.rms_quant_linear_plain(x, gamma, qt))
    _close(df.quant_linear_residual(x, qt, res), df.quant_linear_residual_plain(x, qt, res))
    _close(df.rms_quant_linear_swiglu(x, gamma, qt),
           df.rms_quant_linear_swiglu_plain(x, gamma, qt))
    torch.cuda.synchronize()


def test_kernels_refuse_other_weight_types(cuda):
    # The one-byte kernels take int8 and fp8 (tested below): bf16 weights
    # raise. The per-layer megakernel takes fp8 packs too (tested below);
    # the whole-step kernel takes no fp8 stream (the giga pack requantizes
    # fp8 to int8, as the JAX package does): an fp8 giga stream raises.
    x = _rand((8, 256), 7)
    qt = unit_qtensor(_rand((256, 256), 8, 0.05))
    with pytest.raises(NotImplementedError):
        qm.quant_linear(x, qt)
    with pytest.raises(NotImplementedError):
        df.rms_quant_linear(x, torch.ones(256, device="cuda"), qt)
    gp = _giga_case(2, 512, 1024, 8, 2, 64, 128, 1024, 1000, 70)
    f8 = gp._replace(w=gp.w.to(torch.float8_e4m3fn))
    kpool = _rand((2, 2, 32, 128), 71)
    with pytest.raises(NotImplementedError):
        dg.giga_decode_step(_rand((1000, 512), 72), None, None,
                            torch.tensor([1, 2], device="cuda"), f8, kpool, kpool.clone(),
                            tokens=torch.tensor([1, 2], device="cuda"))


def _paged_lens(rng, B, NKV, W, ps):
    """Batches of B lengths: 1, ps - 1, ps, ps + 1, W ps and every split end
    +- 1 under the kernel's plan for this card, the other rows random. (A
    length of 0 gives zeros where the plain version averages V: held apart
    in test_paged_attention_zero_length.)"""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    S = pa.plan_splits(B, NKV, W, ps, sms)
    ends = [hi * ps for _, hi in pa.split_pages(W, S)]
    edge = sorted({x for x in [1, ps - 1, ps, ps + 1, W * ps]
                   + [e + d for e in ends for d in (-1, 0, 1)] if 1 <= x <= W * ps})
    out = []
    for i in range(0, len(edge), B):
        chunk = np.asarray(edge[i:i + B], np.int64)
        chunk = np.concatenate([chunk, rng.integers(1, W * ps + 1, B - len(chunk))])
        out.append(torch.from_numpy(chunk.astype(np.int32)).cuda())
    return out


def _paged_inputs(rng, B, NH, NKV, HD, ps, W, dtype, int8, seed):
    P = B * W + 1
    table = torch.from_numpy((1 + rng.permutation(P - 1)[: B * W].reshape(B, W)).astype(np.int32))
    q = _rand((B, 1, NH, HD), seed, dtype=dtype)
    if not int8:
        return q, _rand((P, NKV, HD, ps), seed + 1, dtype=dtype), \
            _rand((P, NKV, HD, ps), seed + 2, dtype=dtype), {}, table.cuda()
    kp = torch.from_numpy(rng.integers(-127, 128, (P, NKV, HD, ps)).astype(np.int8)).cuda()
    vp = torch.from_numpy(rng.integers(-127, 128, (P, NKV, HD, ps)).astype(np.int8)).cuda()
    ks = torch.from_numpy(rng.uniform(0.002, 0.02, (P, NKV, ps)).astype(np.float32)).cuda()
    vs = torch.from_numpy(rng.uniform(0.002, 0.02, (P, NKV, ps)).astype(np.float32)).cuda()
    return q, kp, vp, {"k_scale": ks, "v_scale": vs}, table.cuda()


@pytest.mark.parametrize("B,NH,NKV,HD,ps,W,dtype", [
    (8, 32, 8, 64, 128, 4, torch.bfloat16),
    (3, 8, 2, 32, 16, 4, torch.float32),
    (2, 16, 2, 128, 8, 4, torch.bfloat16),
    (5, 3, 1, 16, 24, 4, torch.float32),
    (8, 8, 8, 64, 128, 12, torch.bfloat16),    # G 1, split rows
    (4, 32, 8, 128, 16, 40, torch.bfloat16),   # G 4, HD 128, 8 pages a split
    (2, 64, 8, 64, 128, 20, torch.bfloat16),   # G 8
    (3, 16, 2, 128, 32, 24, torch.float32),    # f32 pages in 64-token chunks
    (1, 32, 8, 64, 128, 32, torch.bfloat16),   # one row of 4096 tokens
])
def test_paged_attention_kernel(cuda, B, NH, NKV, HD, ps, W, dtype):
    rng = np.random.default_rng(9)
    q, kp, vp, _, t = _paged_inputs(rng, B, NH, NKV, HD, ps, W, dtype, False, 10)
    for ln in _paged_lens(rng, B, NKV, W, ps):
        got = pa.paged_decode_attention(q, kp, vp, t, ln)
        want = pa.paged_decode_attention_plain(q, kp, vp, t, ln)
        torch.cuda.synchronize()
        _close(got, want)


@pytest.mark.parametrize("int8", [False, True])
def test_paged_attention_zero_length(cuda, int8):
    # A row of length 0 gives zeros (the TPU kernel's l == 0 branch); its
    # neighbours are unaffected.
    rng = np.random.default_rng(13)
    q, kp, vp, sc, t = _paged_inputs(rng, 4, 32, 8, 64, 128, 8, torch.bfloat16, int8, 14)
    ln = torch.tensor([0, 5, 1024, 0], dtype=torch.int32, device="cuda")
    got = pa.paged_decode_attention(q, kp, vp, t, ln, **sc)
    torch.cuda.synchronize()
    assert torch.equal(got[0], torch.zeros_like(got[0])) and torch.equal(got[3], got[0])
    _close(got[1:3], pa.paged_decode_attention_plain(q, kp, vp, t, ln, **sc)[1:3])


@pytest.mark.parametrize("int8", [False, True])
def test_paged_attention_graph_reads_lengths_on_the_card(cuda, int8):
    # One call captured in a CUDA graph, replayed after seq_lens is rewritten
    # in place, equals an eager call at the new lengths: no host read of the
    # lengths (the split plan depends on shapes only).
    rng = np.random.default_rng(15)
    B, W, ps = 8, 32, 128
    q, kp, vp, sc, t = _paged_inputs(rng, B, 32, 8, 64, ps, W, torch.bfloat16, int8, 16)
    ln = torch.from_numpy(rng.integers(1, 257, B).astype(np.int32)).cuda()
    pa.paged_decode_attention(q, kp, vp, t, ln, **sc)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = pa.paged_decode_attention(q, kp, vp, t, ln, **sc)
    new = rng.integers(1, W * ps + 1, B).astype(np.int32)
    new[0] = W * ps
    ln.copy_(torch.from_numpy(new))
    g.replay()
    torch.cuda.synchronize()
    want = pa.paged_decode_attention(q, kp, vp, t, ln, **sc)
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    _close(out, pa.paged_decode_attention_plain(q, kp, vp, t, ln, **sc))


@pytest.mark.parametrize("M,K,N,vocab,bs,dtype", [
    (1, 256, 1024, 1000, 0, torch.bfloat16),
    (8, 2048, 129024, 128256, 0, torch.bfloat16),  # Llama-3.2-1B's padded head
    (32, 512, 2048, 2000, 0, torch.bfloat16),  # split K: the argmax in the finish pass
    (5, 512, 384, 384, 128, torch.float32),
])
def test_argmax_head_kernel(cuda, M, K, N, vocab, bs, dtype):
    x = _rand((M, K), 13, dtype=dtype)
    gamma = 1.0 + _rand((K,), 14, 0.1, torch.float32)
    qt = quantize(_rand((K, N), 15, 0.05, torch.float32), "int8", bs)
    before = df.rms_quant_linear_argmax.launches
    got = df.rms_quant_linear_argmax(x, gamma, qt, vocab_size=vocab)
    torch.cuda.synchronize()
    assert df.rms_quant_linear_argmax.launches == before + 1
    assert got.shape == (M, 1) and got.dtype == torch.int32
    logits = qm.scaled_partials(df._rms_scaled(x, gamma, 1e-5), qt)[:, :vocab]
    tok = got[:, 0].long()
    assert int(tok.max()) < vocab and int(tok.min()) >= 0
    picked = logits.gather(1, tok[:, None])[:, 0]
    gap = (logits.max(dim=-1).values - picked).abs().max().item()
    assert gap <= 1e-3 * logits.abs().max().item()


@pytest.mark.parametrize("B,NH,NKV,HD,T,dtype", [
    (8, 32, 8, 64, 512, torch.bfloat16),
    (3, 8, 2, 32, 64, torch.float32),
    (2, 16, 2, 128, 40, torch.bfloat16),
    (5, 3, 1, 16, 24, torch.float32),
    (1, 32, 8, 64, 4096, torch.bfloat16),   # one long request: S 33
    (64, 32, 8, 64, 512, torch.bfloat16),   # enough rows to fill the card: S 1
    (2, 16, 2, 128, 1024, torch.float32),   # f32 at HD 128, 3-stage rings
])
def test_dense_attention_kernel(cuda, B, NH, NKV, HD, T, dtype):
    rng = np.random.default_rng(16)
    lens = rng.integers(1, T + 1, B).astype(np.int32)
    lens[0], lens[-1] = T, 1
    q = _rand((B, 1, NH, HD), 17, dtype=dtype)
    k = _rand((B, T, NKV, HD), 18, dtype=dtype)
    v = _rand((B, T, NKV, HD), 19, dtype=dtype)
    ln = torch.from_numpy(lens).cuda()
    got = da.dense_decode_attention(q, k, v, ln)
    want = da.dense_decode_attention_plain(q, k, v, ln)
    torch.cuda.synchronize()
    _close(got, want)


@pytest.mark.parametrize("B,NH,NKV,HD,T,dtype", [
    (8, 32, 8, 64, 512, torch.bfloat16),
    (3, 8, 2, 32, 64, torch.float32),
    (1, 32, 8, 64, 4096, torch.bfloat16),   # S 33
    (64, 32, 8, 64, 512, torch.bfloat16),   # S 1
])
def test_fused_attention_kernel(cuda, B, NH, NKV, HD, T, dtype):
    rng = np.random.default_rng(20)
    KD, NQ = NKV * HD, NH * HD
    old = rng.integers(0, T, B).astype(np.int32)
    old[0], old[-1] = 0, T - 1
    qkv = _rand((B, NQ + 2 * KD), 21, dtype=dtype)
    ang = torch.from_numpy(rng.uniform(0, 6.3, (B, HD // 2)).astype(np.float32)).cuda()
    c2, s2 = torch.cos(ang), torch.sin(ang)
    cos_t = torch.cat([c2, c2], -1).repeat(1, NKV)
    sin_t = torch.cat([-s2, s2], -1).repeat(1, NKV)
    k = _rand((B, T, NKV, HD), 22, dtype=dtype)
    v = _rand((B, T, NKV, HD), 23, dtype=dtype)
    kp, vp = k.clone(), v.clone()
    ln = torch.from_numpy(old).cuda()
    att, k_new, k2, v2 = da.fused_decode_attention(qkv, None, cos_t, sin_t, k, v, ln,
                                                   num_heads=NH)
    watt, wk_new, _, _ = da.fused_decode_attention_plain(qkv, cos_t, sin_t, kp, vp, ln,
                                                         num_heads=NH)
    torch.cuda.synchronize()
    assert k2 is k and v2 is v
    _close(att, watt)
    _close(k_new, wk_new)
    _close(k, kp)
    assert torch.equal(v, vp)  # raw v rows are copied, not computed
    rows = torch.arange(B, device="cuda")
    _close(k[rows, ln.long()].reshape(B, KD), k_new)


# The mixed (q, cache) pairs the JAX kernels take and the card kernels
# instantiate: an f32 q over bf16 pages or caches (GPT-2 served with f32
# params over bf16 pages; an f32 draft over its bf16 cache) and a bf16 q over
# f32 ones. Each side is read in its own dtype: the plain version widens both
# to f32, as the kernel does, and rounds nothing of q.
_MIXED = [(torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32)]


@pytest.mark.parametrize("qd,pd", _MIXED)
@pytest.mark.parametrize("B,NH,NKV,HD,ps,W", [
    (8, 12, 12, 64, 128, 4),    # GPT-2 124M at G 1, bf16 pages of 128 tokens
    (3, 8, 2, 32, 16, 4),
    (4, 32, 8, 128, 16, 40),    # G 4, HD 128, split rows
    (1, 32, 8, 64, 128, 32),    # one row of 4096 tokens
])
def test_paged_attention_mixed_dtypes(cuda, qd, pd, B, NH, NKV, HD, ps, W):
    rng = np.random.default_rng(110)
    q, kp, vp, _, t = _paged_inputs(rng, B, NH, NKV, HD, ps, W, pd, False, 111)
    q = _rand(tuple(q.shape), 112, dtype=qd)
    for ln in _paged_lens(rng, B, NKV, W, ps):
        got = pa.paged_decode_attention(q, kp, vp, t, ln)
        want = pa.paged_decode_attention_plain(q, kp, vp, t, ln)
        torch.cuda.synchronize()
        assert got.dtype == qd
        _close(got, want)


@pytest.mark.parametrize("qd,pd", _MIXED)
def test_paged_attention_mixed_dtypes_graph_replay(cuda, qd, pd):
    # A mixed-pair call captured in a graph, replayed after seq_lens changes,
    # equals an eager call at the new lengths.
    rng = np.random.default_rng(113)
    B, W, ps = 8, 8, 128
    q, kp, vp, _, t = _paged_inputs(rng, B, 12, 12, 64, ps, W, pd, False, 114)
    q = q.to(qd)
    ln = torch.from_numpy(rng.integers(1, 129, B).astype(np.int32)).cuda()
    pa.paged_decode_attention(q, kp, vp, t, ln)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = pa.paged_decode_attention(q, kp, vp, t, ln)
    ln.copy_(torch.from_numpy(rng.integers(1, W * ps + 1, B).astype(np.int32)))
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, pa.paged_decode_attention(q, kp, vp, t, ln))
    _close(out, pa.paged_decode_attention_plain(q, kp, vp, t, ln))


@pytest.mark.parametrize("B,t,dtype", [(8, 5, torch.bfloat16), (8, 4, torch.bfloat16),
                                       (3, 5, torch.float32)])
def test_paged_attention_flattened_verify_rows(cuda, B, t, dtype):
    # The speculative verify (Llama.forward_paged_chunk): B*t query rows, each
    # row's table repeated t times, lengths pos + 1 .. pos + t, at Llama-3.2-1B's
    # heads (the split planner sees B*t rows over one table width).
    NH, NKV, HD, ps, W = 32, 8, 64, 128, 4
    rng = np.random.default_rng(115)
    P = B * W + 1
    table = torch.from_numpy((1 + rng.permutation(P - 1)[: B * W].reshape(B, W))
                             .astype(np.int32)).cuda()
    kp = _rand((P, NKV, HD, ps), 116, dtype=dtype)
    vp = _rand((P, NKV, HD, ps), 117, dtype=dtype)
    q = _rand((B * t, 1, NH, HD), 118, dtype=dtype)
    pos = rng.integers(0, W * ps - t + 1, B)
    pos[0] = W * ps - t
    lens = torch.from_numpy((pos[:, None] + 1 + np.arange(t)[None]).reshape(-1)
                            .astype(np.int32)).cuda()
    flat = table.repeat_interleave(t, dim=0)
    got = pa.paged_decode_attention(q, kp, vp, flat, lens)
    want = pa.paged_decode_attention_plain(q, kp, vp, flat, lens)
    torch.cuda.synchronize()
    _close(got, want)


@pytest.mark.parametrize("qd,cd", _MIXED)
@pytest.mark.parametrize("B,NH,NKV,HD,T", [
    (8, 4, 2, 32, 512),     # the tiny draft (LlamaConfig.tiny) at the engine's cache
    (8, 32, 8, 64, 512),
    (1, 32, 8, 64, 4096),   # S 33
    (2, 16, 2, 128, 1024),
])
def test_dense_attention_mixed_dtypes(cuda, qd, cd, B, NH, NKV, HD, T):
    rng = np.random.default_rng(120)
    lens = rng.integers(1, T + 1, B).astype(np.int32)
    lens[0], lens[-1] = T, 1
    q = _rand((B, 1, NH, HD), 121, dtype=qd)
    k = _rand((B, T, NKV, HD), 122, dtype=cd)
    v = _rand((B, T, NKV, HD), 123, dtype=cd)
    ln = torch.from_numpy(lens).cuda()
    got = da.dense_decode_attention(q, k, v, ln)
    want = da.dense_decode_attention_plain(q, k, v, ln)
    torch.cuda.synchronize()
    assert got.dtype == qd
    _close(got, want)


@pytest.mark.parametrize("qd,cd", _MIXED)
@pytest.mark.parametrize("B,NH,NKV,HD,T", [(8, 4, 2, 32, 512), (1, 32, 8, 64, 4096)])
def test_fused_attention_mixed_dtypes(cuda, qd, cd, B, NH, NKV, HD, T):
    # The fused entry takes the same pairs: the row it writes is rounded to
    # the caches' dtype, k_new and the output keep qkv's.
    qkv, cos_t, sin_t, k, v = _fused_case(B, NH, NKV, HD, T, qd, 124)
    k, v = k.to(cd), v.to(cd)
    kp, vp = k.clone(), v.clone()
    rng = np.random.default_rng(125)
    old = rng.integers(0, T, B).astype(np.int32)
    old[0] = T - 1
    ln = torch.from_numpy(old).cuda()
    att, k_new, _, _ = da.fused_decode_attention(qkv, None, cos_t, sin_t, k, v, ln,
                                                 num_heads=NH)
    watt, wk_new, _, _ = da.fused_decode_attention_plain(qkv, cos_t, sin_t, kp, vp, ln,
                                                         num_heads=NH)
    torch.cuda.synchronize()
    assert att.dtype == qd and k_new.dtype == qd and k.dtype == cd
    _close(att, watt)
    _close(k_new, wk_new)
    _close(k, kp)
    assert torch.equal(v, vp)


@pytest.mark.parametrize("qd,cd", _MIXED)
def test_dense_attention_mixed_dtypes_graph_replay(cuda, qd, cd):
    # Two calls bit-equal; a graph replayed after the lengths change equals an
    # eager call (B 1 over 4096 rows: the merging split counts arrivals).
    B, NH, NKV, HD, T = 1, 32, 8, 64, 4096
    rng = np.random.default_rng(126)
    q = _rand((B, 1, NH, HD), 127, dtype=qd)
    k, v = _rand((B, T, NKV, HD), 128, dtype=cd), _rand((B, T, NKV, HD), 129, dtype=cd)
    ln = torch.from_numpy(rng.integers(1, 65, B).astype(np.int32)).cuda()
    first, second = (da.dense_decode_attention(q, k, v, ln) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = da.dense_decode_attention(q, k, v, ln)
    ln.fill_(T - 3)
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, da.dense_decode_attention(q, k, v, ln))
    _close(out, da.dense_decode_attention_plain(q, k, v, ln))


@pytest.mark.parametrize("K,N", [(2048, 3072), (2048, 2048), (2048, 16384), (8192, 2048)])
def test_quant_linear_at_verify_rows(cuda, K, N):
    # K1 at M 40: the speculative engine's verify at B 8, k 4 (B * (k + 1)
    # rows past the fused decode entries' 32) at Llama-3.2-1B's projections.
    M = 40
    x = _rand((M, K), 130)
    qt = quantize(_rand((K, N), 131, 0.05, torch.float32), "int8", 0)
    before = qm.quant_linear.launches
    got = qm.quant_linear(x, qt)
    torch.cuda.synchronize()
    assert qm.quant_linear.launches == before + 1
    _close(got, qm.quant_linear_plain(x, qt))


def _split_edges(T, S):
    """Lengths 1, T and every split edge +- 1 of a full row under S splits."""
    ends = [hi for _, hi in da.split_tokens(T, S)]
    return sorted({x for x in [1, 2, da.SPLIT_MIN_TOKENS - 1, da.SPLIT_MIN_TOKENS,
                               da.SPLIT_MIN_TOKENS + 1, T - 1, T]
                   + [e + d for e in ends for d in (-1, 0, 1)] if 1 <= x <= T})


def _fused_case(B, NH, NKV, HD, T, dtype, seed):
    rng = np.random.default_rng(seed)
    KD, NQ = NKV * HD, NH * HD
    qkv = _rand((B, NQ + 2 * KD), seed, dtype=dtype)
    ang = torch.from_numpy(rng.uniform(0, 6.3, (B, HD // 2)).astype(np.float32)).cuda()
    c2, s2 = torch.cos(ang), torch.sin(ang)
    cos_t = torch.cat([c2, c2], -1).repeat(1, NKV)
    sin_t = torch.cat([-s2, s2], -1).repeat(1, NKV)
    return (qkv, cos_t, sin_t, _rand((B, T, NKV, HD), seed + 1, dtype=dtype),
            _rand((B, T, NKV, HD), seed + 2, dtype=dtype))


@pytest.mark.parametrize("fused", [False, True])
def test_dense_attention_at_every_split_edge(cuda, fused):
    # One row of a 4096-row cache (S 33) at lengths 0, 1, T and every split
    # edge +- 1; the fused call at the same numbers of old rows (at T no row
    # is written).
    B, NH, NKV, HD, T = 1, 32, 8, 64, 4096
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    S = da.plan_splits(B, NKV, T, sms)
    assert S > 1
    q = _rand((B, 1, NH, HD), 24)
    qkv, cos_t, sin_t, k, v = _fused_case(B, NH, NKV, HD, T, torch.bfloat16, 25)
    for n in _split_edges(T, S) + [0]:
        ln = torch.tensor([n], dtype=torch.int32, device="cuda")
        if not fused:
            got = da.dense_decode_attention(q, k, v, ln)
            want = (torch.zeros_like(q) if n == 0
                    else da.dense_decode_attention_plain(q, k, v, ln))
            torch.cuda.synchronize()
            _close(got, want)
            continue
        kg, vg, kp, vp = k.clone(), v.clone(), k.clone(), v.clone()
        att, k_new, _, _ = da.fused_decode_attention(qkv, None, cos_t, sin_t, kg, vg, ln,
                                                     num_heads=NH)
        if n == T:  # a full cache: nothing written (the current token still attended, C.2)
            torch.cuda.synchronize()
            assert torch.isfinite(att.float()).all()
            assert torch.equal(kg, k) and torch.equal(vg, v)
            continue
        watt, wk_new, _, _ = da.fused_decode_attention_plain(qkv, cos_t, sin_t, kp, vp, ln,
                                                             num_heads=NH)
        torch.cuda.synchronize()
        _close(att, watt)
        _close(k_new, wk_new)
        _close(kg, kp)
        assert torch.equal(vg, vp)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("B,T", [(1, 4096), (8, 512)])
def test_dense_attention_graph_reads_lengths_on_the_card(cuda, fused, B, T):
    # Two calls are bit-equal (the splits merge in a fixed order); one call
    # captured in a CUDA graph, replayed after the lengths are rewritten in
    # place, equals an eager call at the new lengths (the split plan depends
    # on shapes only; the merge leaves its counters at 0 for the replay).
    NH, NKV, HD = 32, 8, 64
    rng = np.random.default_rng(26)
    q = _rand((B, 1, NH, HD), 27)
    qkv, cos_t, sin_t, k, v = _fused_case(B, NH, NKV, HD, T, torch.bfloat16, 28)
    ln = torch.from_numpy(rng.integers(1, 65, B).astype(np.int32)).cuda()

    def call():
        if fused:
            return da.fused_decode_attention(qkv, None, cos_t, sin_t, k, v, ln, num_heads=NH)[0]
        return da.dense_decode_attention(q, k, v, ln)

    first, second = call(), call()
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = call()
    new = rng.integers(T // 2, T, B).astype(np.int32)
    new[0] = T - 1
    ln.copy_(torch.from_numpy(new))
    for _ in range(2):
        g.replay()
        torch.cuda.synchronize()
        want = call()
        torch.cuda.synchronize()
        assert torch.equal(out, want)
    if not fused:
        _close(out, da.dense_decode_attention_plain(q, k, v, ln))


def _two_stream_case(fused, seed):
    # B 2 at T 4096 (S 17: the merging splits count arrivals), own inputs.
    B, NH, NKV, HD, T = 2, 32, 8, 64, 4096
    rng = np.random.default_rng(seed)
    q = _rand((B, 1, NH, HD), seed)
    qkv, cos_t, sin_t, k, v = _fused_case(B, NH, NKV, HD, T, torch.bfloat16, seed + 1)
    ln = torch.from_numpy(rng.integers(T // 2, T, B).astype(np.int32)).cuda()
    if not fused:
        return (lambda: da.dense_decode_attention(q, k, v, ln),
                da.dense_decode_attention_plain(q, k, v, ln))
    # The plain call writes row ln[b] as every kernel call does again.
    want = da.fused_decode_attention_plain(qkv, cos_t, sin_t, k, v, ln, num_heads=NH)[0]
    return (lambda: da.fused_decode_attention(qkv, None, cos_t, sin_t, k, v, ln,
                                              num_heads=NH)[0], want)


def test_dense_attention_counters_across_streams_and_graphs(cuda):
    # Dense and fused calls on two streams at once, eagerly and as two
    # graphs replayed at once, each on its own inputs: every result equals
    # its own plain one (no two launches that may overlap share a counter).
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert da.plan_splits(2, 8, 4096, sms) > 1
    cases = [_two_stream_case(False, 90), _two_stream_case(True, 93)]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    outs = [[], []]
    for _ in range(20):
        for i, (call, _) in enumerate(cases):
            with torch.cuda.stream(streams[i]):
                outs[i].append(call())
    torch.cuda.synchronize()
    for (_, want), got in zip(cases, outs):
        for o in got:
            _close(o, want)
    graphs, gouts = [], []
    for call, _ in cases:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            gouts.append([call() for _ in range(4)])
        graphs.append(g)
    torch.cuda.synchronize()
    for _ in range(10):
        for g, st in zip(graphs, streams):
            with torch.cuda.stream(st):
                g.replay()
        torch.cuda.synchronize()
        for (_, want), got in zip(cases, gouts):
            for o in got:
                _close(o, want)


def test_dense_attention_graph_outlives_counter_growth(cuda):
    # A graph captured first still replays correctly after an eager call
    # with B * NKV > 4096 and after the eager counters grow.
    B, NH, NKV, HD, T = 8, 32, 8, 64, 512
    rng = np.random.default_rng(96)
    q = _rand((B, 1, NH, HD), 97)
    k, v = _rand((B, T, NKV, HD), 98), _rand((B, T, NKV, HD), 99)
    ln = torch.from_numpy(rng.integers(T // 2, T, B).astype(np.int32)).cuda()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = da.dense_decode_attention(q, k, v, ln)
    big_b, big_t = 520, 64  # 4160 (row, KV head) pairs
    qb = _rand((big_b, 1, NH, HD), 100)
    kb, vb = _rand((big_b, big_t, NKV, HD), 101), _rand((big_b, big_t, NKV, HD), 102)
    lb = torch.full((big_b,), big_t, dtype=torch.int32, device="cuda")
    _close(da.dense_decode_attention(qb, kb, vb, lb),
           da.dense_decode_attention_plain(qb, kb, vb, lb))
    assert da._counters(q.device, 8192).numel() >= 8192
    want = da.dense_decode_attention_plain(q, k, v, ln)
    for _ in range(3):
        g.replay()
        torch.cuda.synchronize()
        _close(out, want)
        assert torch.equal(out, da.dense_decode_attention(q, k, v, ln))


def _decode_case(M, K, N, bs, dtype, seed):
    x = _rand((M, K), seed, dtype=dtype)
    gamma = 1.0 + _rand((K,), seed + 1, 0.1, torch.float32)
    qt = quantize(_rand((K, N), seed + 2, 0.05, torch.float32), "int8", bs)
    res = _rand((M, N), seed + 3, dtype=dtype)
    return x, gamma, qt, res


def _argmax_gap(tok, x, gamma, qt, vocab):
    logits = qm.scaled_partials(df._rms_scaled(x, gamma, 1e-5), qt)[:, :vocab]
    t = tok[:, 0].long()
    assert int(t.max()) < vocab and int(t.min()) >= 0
    gap = (logits.max(dim=-1).values - logits.gather(1, t[:, None])[:, 0]).abs().max().item()
    assert gap <= 1e-3 * logits.abs().max().item()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bs", [0, 128])
@pytest.mark.parametrize("M", [1, 8, 9, 32])
def test_qgemv_int8_kernel(cuda, M, bs, dtype):
    # wqkv's shape (K slices of 256 rows in clusters of 8 at M 8: two
    # 128-row scale blocks a slice when blocked), every epilogue.
    K, N = 2048, 3072
    x, gamma, qt, res = _decode_case(M, K, N, bs, dtype, 110)
    entries = (df.rms_quant_linear, df.quant_linear_residual, df.rms_quant_linear_swiglu,
               df.rms_quant_linear_argmax)
    before = [f.launches for f in entries]
    _close(df.rms_quant_linear(x, gamma, qt), df.rms_quant_linear_plain(x, gamma, qt))
    _close(df.quant_linear_residual(x, qt, res), df.quant_linear_residual_plain(x, qt, res))
    _close(df.rms_quant_linear_swiglu(x, gamma, qt),
           df.rms_quant_linear_swiglu_plain(x, gamma, qt))
    vocab = N - 100
    _argmax_gap(df.rms_quant_linear_argmax(x, gamma, qt, vocab_size=vocab), x, gamma, qt, vocab)
    torch.cuda.synchronize()
    assert [f.launches for f in entries] == [b + 1 for b in before]


@pytest.mark.parametrize("mode", ["store", "residual", "swiglu", "argmax"])
@pytest.mark.parametrize("M,K,N", [(8, 2048, 3072), (8, 8192, 2048), (32, 2048, 4096)])
def test_qgemv_int8_graph_replay_and_determinism(cuda, mode, M, K, N):
    # Two calls are bit-equal (the K slices add in slice order in one
    # cluster); a captured call replayed after x is rewritten in place
    # equals an eager call on the new x.
    x, gamma, qt, res = _decode_case(M, K, N, 0, torch.bfloat16, 120)
    _replay_equals_eager(_decode_call(mode, x, gamma, qt, res, N - 7),
                         lambda seed: x.copy_(_rand((M, K), seed)), (121, 122))


def _decode_call(mode, x, gamma, qt, res, vocab):
    """A closure calling the decode entry of ``mode`` on these inputs."""
    if mode == "store":
        return lambda: df.rms_quant_linear(x, gamma, qt)
    if mode == "residual":
        return lambda: df.quant_linear_residual(x, qt, res)
    if mode == "swiglu":
        return lambda: df.rms_quant_linear_swiglu(x, gamma, qt)
    return lambda: df.rms_quant_linear_argmax(x, gamma, qt, vocab_size=vocab)


def _replay_equals_eager(call, refill, seeds):
    """Two eager calls bit-equal; a CUDA graph of one call, replayed after
    refill(seed) rewrites its inputs in place, equal to an eager call."""
    flat = lambda o: o if isinstance(o, tuple) else (o,)  # noqa: E731
    first, second = call(), call()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(flat(first), flat(second)))
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = call()
    for seed in seeds:
        refill(seed)
        g.replay()
        torch.cuda.synchronize()
        want = call()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(flat(out), flat(want)))


def test_qgemv_int8_one_launch_a_call(cuda):
    # One kernel a call (no finishing pass, no workspace): the profiler sees
    # the GEMV kernel once per call and, for the argmax, only the key reset
    # and the index pass beside it. This test once saw two of the three
    # records. tools/qgemv_launch_loop.py runs these three calls for 300
    # rounds, a profiler window each: every round's launch counters and
    # outputs were right, and in two rounds the profiler recorded fewer
    # kernels (0, then 2 of 3): records the profiler dropped, not missing
    # launches (NVIDIA H100 80GB HBM3, 700 W; PERF.md, PR 16).
    from torch.profiler import ProfilerActivity, profile

    x, gamma, qt, res = _decode_case(8, 8192, 2048, 0, torch.bfloat16, 130)
    xh, gh, qh, _ = _decode_case(8, 2048, 4096, 0, torch.bfloat16, 131)
    calls = (lambda: df.quant_linear_residual(x, qt, res),
             lambda: df.rms_quant_linear_swiglu(xh, gh, qh),
             lambda: df.rms_quant_linear_argmax(xh, gh, qh, vocab_size=4000))
    for call in calls:
        call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for call in calls:
            call()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("qgemv8_kernel" in n for n in names) == 3, names
    assert not any("finish" in n for n in names), names
    others = [n for n in names if "qgemv8_kernel" not in n]
    assert sum("argmax_index" in n for n in others) == 1, names
    assert all("argmax_index" in n or "emset" in n for n in others), names


def _tail_case(H, I, NQ, bn, layers, seed, wdt="int8"):
    rng = np.random.default_rng(seed)

    def w(*shape):
        return quantize(torch.from_numpy((rng.standard_normal(shape) * 0.05).astype(
            np.float32)).cuda(), wdt)

    ws = [(w(H, H), w(H, 2 * I), w(I, H), w(H, NQ)) for _ in range(layers)]
    packs = [lf.pack_layer(wo, wgu, down, ws[i + 1][3] if i + 1 < layers else None, bn=bn)
             for i, (wo, wgu, down, _) in enumerate(ws)]
    return packs, ls.pack_layer_stream(packs)


@pytest.mark.parametrize("H,I,NQ,bn,M,dtype", [
    (256, 512, 384, 128, 4, torch.bfloat16),
    (256, 512, 384, 128, 20, torch.float32),
    (2048, 8192, 3072, 512, 8, torch.bfloat16),  # Llama-3.2-1B's layer tail
    (2048, 8192, 3072, 512, 1, torch.bfloat16),
    (2048, 8192, 3072, 512, 32, torch.float32),  # m_tile 32: four n-tiles of x
])
def test_layer_tail_kernel(cuda, H, I, NQ, bn, M, dtype):
    packs, stream = _tail_case(H, I, NQ, bn, 3, seed=24)
    att, x = _rand((M, H), 25, dtype=dtype), _rand((M, H), 26, dtype=dtype)
    g1, g2 = 1.0 + _rand((H,), 27, 0.1, torch.float32), 1.0 + _rand((H,), 28, 0.1, torch.float32)
    for layer in range(3):
        last = layer == 2
        gn = None if last else g2
        before = ls.layer_tail_stream.launches
        out, qkv = ls.layer_tail_stream(att, x, g1, stream, layer, gn)
        torch.cuda.synchronize()
        assert ls.layer_tail_stream.launches == before + 1
        wout, wqkv = lf.tail_plain(att, x, g1, packs[layer], g2 if gn is None else gn, eps=1e-5)
        _close(out, wout)
        if last:
            assert qkv is None
        else:
            _close(qkv, wqkv)
    out, qkv = lf.mlp_qkv_fused(att, x, g1, packs[0], g2)
    wout, wqkv = lf.tail_plain(att, x, g1, packs[0], g2, eps=1e-5)
    torch.cuda.synchronize()
    _close(out, wout)
    _close(qkv, wqkv)


@pytest.mark.parametrize("M", [1, 8, 32])
def test_layer_tail_graph_replay_and_determinism(cuda, M):
    # Two calls are bit-equal (partials added in slice order, no atomics);
    # a captured call replayed after att and x are rewritten in place equals
    # an eager call on the new inputs.
    H, I, NQ, bn = 2048, 8192, 3072, 512
    _, stream = _tail_case(H, I, NQ, bn, 2, seed=140)
    att, x = _rand((M, H), 141), _rand((M, H), 142)
    g1, g2 = 1.0 + _rand((H,), 143, 0.1, torch.float32), 1.0 + _rand((H,), 144, 0.1, torch.float32)
    _replay_equals_eager(lambda: ls.layer_tail_stream(att, x, g1, stream, 0, g2),
                         _tail_refill(att, x), (145, 146))


def _tail_refill(att, x):
    def refill(seed):
        att.copy_(_rand(tuple(att.shape), seed))
        x.copy_(_rand(tuple(x.shape), seed + 10))
    return refill


def test_layer_tail_smallest_slice(cuda):
    # H 512: the plan cuts wo, gate|up and down into one-stage slices (the
    # smallest K slice), two 256-column units a tile.
    H, I, NQ, bn, M = 512, 2048, 1024, 512, 8
    packs, stream = _tail_case(H, I, NQ, bn, 2, seed=150)
    _, _, plan = lf.tail_launch_plan(M, H, I, bn, 2, 0, 0)
    assert H // plan["wo"][1] == lf._STAGE_ROWS
    att, x = _rand((M, H), 151), _rand((M, H), 152)
    g1, g2 = 1.0 + _rand((H,), 153, 0.1, torch.float32), 1.0 + _rand((H,), 154, 0.1, torch.float32)
    out, qkv = ls.layer_tail_stream(att, x, g1, stream, 0, g2)
    torch.cuda.synchronize()
    wout, wqkv = lf.tail_plain(att, x, g1, packs[0], g2, eps=1e-5)
    _close(out, wout)
    _close(qkv, wqkv)


def test_tail_entries_refuse_a_grid_over_the_row_sum_limit(cuda):
    # The rstd pass reads the row sums of at most _MAX_GRID blocks: both C
    # entry points return cudaErrorInvalidValue (1) for a larger grid, before
    # they read an argument or launch.
    grid = lf._MAX_GRID + 1
    lib = lf._lib()
    assert lib.layer_tail_int8(*[None] * 17, *[0] * 14, 1e-5, grid, 8, 0, 0, None) == 1
    mlib = lm._lib()
    ptrs = (ctypes.c_void_p * len(lm._PTRS))()
    ints = (ctypes.c_int * len(lm._INTS))()
    floats = (ctypes.c_float * 2)()
    assert mlib.decode_step_int8(ptrs, len(lm._PTRS), ints, len(lm._INTS), floats, 2, grid, 8,
                                 1, None) == 1


@pytest.mark.parametrize("H,I,bn,M,dtype", [
    (256, 512, 128, 4, torch.bfloat16),
    (256, 512, 256, 20, torch.float32),
    (2048, 8192, 2048, 8, torch.bfloat16),  # Llama-3.2-1B's MLP block
])
def test_mlp_block_kernel(cuda, H, I, bn, M, dtype):
    rng = np.random.default_rng(30)

    def w(*shape):
        return quantize(torch.from_numpy((rng.standard_normal(shape) * 0.05).astype(
            np.float32)).cuda(), "int8")

    pack = dm.pack_mlp(w(H, H), w(H, 2 * I), w(I, H), bn=bn)
    att, x = _rand((M, H), 31, dtype=dtype), _rand((M, H), 32, dtype=dtype)
    g = 1.0 + _rand((H,), 33, 0.1, torch.float32)
    before = dm.mlp_block_fused.launches
    got = dm.mlp_block_fused(att, x, g, pack)
    torch.cuda.synchronize()
    assert dm.mlp_block_fused.launches == before + 1 and got.dtype == dtype
    _close(got, dm.mlp_block_plain(att, x, g, pack, eps=1e-5))
    dm.mlp_block_fused(att.cpu(), x.cpu(), g.cpu(), dm.MLPPack(pack.w.cpu(), pack.s.cpu(),
                                                               *pack[2:]))
    assert dm.mlp_block_fused.launches == before + 1  # a CPU tensor takes the plain version


# fp8 weights (e4m3fn, e5m2). Each kernel converts them exactly to bf16
# operands (gemv.cuh: F8Pair), so they are held to the kernels' arithmetic as
# the int8 cases are: scaled_partials (bf16 operands, f32 sums times the
# scale rows) with each entry's prologue and epilogue, and for the tails and
# the MLP block their plain versions. Scale blocks of 64 rows send JAX's
# decode entries to their unfused route, so the decode references here are
# the kernels' own arithmetic (the plain versions' kernel branch).
_FP8 = ("fp8_e4m3", "fp8_e5m2")
_SUBNORMAL_CODES = (1, 2, 3, 4, 5, 6, 7, 0x81, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87)


def _fp8_qt(K, N, wdt, bs, seed):
    return quantize(_rand((K, N), seed, 0.05, torch.float32), wdt, bs)


def _plant_subnormals(q, cols):
    """Every byte of q's first ``cols`` columns an fp8 subnormal code (for
    e5m2 the codes past 0x03 / 0x83 are its smallest normals)."""
    K = q.shape[0]
    codes = torch.tensor(_SUBNORMAL_CODES, dtype=torch.uint8, device=q.device)
    idx = (torch.arange(K, device=q.device)[:, None] + torch.arange(cols, device=q.device)) % 14
    q.view(torch.uint8)[:, :cols] = codes[idx]


def _decode_refs(x, gamma, qt, res):
    """The decode entries' arithmetic: store, residual and SwiGLU outputs."""
    xs = df._rms_scaled(x, gamma, 1e-5)
    store = qm.scaled_partials(xs, qt).to(x.dtype)
    resid = (qm.scaled_partials(x.to(torch.bfloat16), qt) + res.float()).to(x.dtype)
    gu = qm.scaled_partials(xs, qt)
    g, u = gu.chunk(2, dim=-1)
    return store, resid, (g * torch.sigmoid(g) * u).to(x.dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bs", [0, 64])
@pytest.mark.parametrize("M", [1, 8, 32, 1000])
@pytest.mark.parametrize("wdt", _FP8)
def test_fp8_quant_linear_kernel(cuda, wdt, M, bs, dtype):
    K, N = 1024, 3072
    x = _rand((M, K), 200, dtype=dtype)
    qt = _fp8_qt(K, N, wdt, bs, 201)
    bias = _rand((N,), 202, 0.1, torch.float32) if bs else None
    act = "gelu" if bs else None
    before = qm.quant_linear.launches
    got = qm.quant_linear(x, qt, bias, activation=act)
    torch.cuda.synchronize()
    assert qm.quant_linear.launches == before + 1
    y = qm.scaled_partials(x.to(torch.bfloat16), qt)
    if bias is not None:
        y = y + bias
    _close(got, qm.activate(y, act).to(dtype))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bs", [0, 64])
@pytest.mark.parametrize("M", [1, 8, 32])
@pytest.mark.parametrize("wdt", _FP8)
def test_fp8_qgemv_kernel(cuda, wdt, M, bs, dtype):
    # wqkv's shape, every epilogue (K2's three modes and K4's argmax).
    K, N = 2048, 3072
    x, gamma, _, res = _decode_case(M, K, N, bs, dtype, 210)
    qt = _fp8_qt(K, N, wdt, bs, 214)
    entries = (df.rms_quant_linear, df.quant_linear_residual, df.rms_quant_linear_swiglu,
               df.rms_quant_linear_argmax)
    before = [f.launches for f in entries]
    store, resid, swig = _decode_refs(x, gamma, qt, res)
    _close(df.rms_quant_linear(x, gamma, qt), store)
    _close(df.quant_linear_residual(x, qt, res), resid)
    _close(df.rms_quant_linear_swiglu(x, gamma, qt), swig)
    vocab = N - 100
    tok = df.rms_quant_linear_argmax(x, gamma, qt, vocab_size=vocab)
    if bs:  # 64-row blocks: JAX's argmax entry refuses them and returns None; so does ours
        assert tok is None
    else:
        _close(df.rms_quant_linear(x, gamma, qt), df.rms_quant_linear_plain(x, gamma, qt))
        _argmax_gap(tok, x, gamma, qt, vocab)
    torch.cuda.synchronize()
    want = [b + 1 for b in before]
    want[0] += bs == 0
    want[3] -= bs != 0
    assert [f.launches for f in entries] == want


@pytest.mark.parametrize("wdt", _FP8)
def test_fp8_argmax_head_kernel(cuda, wdt):
    # Llama-3.2-1B's padded head in fp8 at M 8.
    M, K, N, vocab = 8, 2048, 129024, 128256
    x = _rand((M, K), 216)
    gamma = 1.0 + _rand((K,), 217, 0.1, torch.float32)
    qt = _fp8_qt(K, N, wdt, 0, 218)
    before = df.rms_quant_linear_argmax.launches
    tok = df.rms_quant_linear_argmax(x, gamma, qt, vocab_size=vocab)
    torch.cuda.synchronize()
    assert df.rms_quant_linear_argmax.launches == before + 1
    _argmax_gap(tok, x, gamma, qt, vocab)


@pytest.mark.parametrize("wdt", _FP8)
def test_fp8_subnormal_codes(cuda, wdt):
    # Columns whose every weight is an fp8 subnormal code: a conversion that
    # flushed them (as bf16 subnormals, the TPU kernels' bit decode) would
    # give zeros there. Those columns are held to their own largest output.
    M, K, N, C = 8, 2048, 3072, 256
    x, gamma, _, res = _decode_case(M, K, N, 0, torch.bfloat16, 220)
    qt = _fp8_qt(K, N, wdt, 0, 224)
    _plant_subnormals(qt.q, C)
    store, resid, swig = _decode_refs(x, gamma, qt, torch.zeros_like(res))
    assert store[:, :C].abs().max() > 0
    _close(qm.quant_linear(x, qt)[:, :C],
           qm.scaled_partials(x.to(torch.bfloat16), qt)[:, :C].to(x.dtype))
    _close(df.rms_quant_linear(x, gamma, qt)[:, :C], store[:, :C])
    _close(df.quant_linear_residual(x, qt, torch.zeros_like(res))[:, :C], resid[:, :C])
    _close(df.rms_quant_linear_swiglu(x, gamma, qt)[:, :C], swig[:, :C])
    # K7: the next layer's wqkv all subnormal codes in its first C columns.
    H, I, NQ, bn = 2048, 8192, 3072, 512
    _, stream = _tail_case(H, I, NQ, bn, 2, seed=225, wdt=wdt)
    _plant_subnormals(stream.w[stream.n_wo + stream.n_gu + stream.n_down], C)
    att, xa = _rand((M, H), 226), _rand((M, H), 227)
    g1, g2 = 1.0 + _rand((H,), 228, 0.1, torch.float32), 1.0 + _rand((H,), 229, 0.1, torch.float32)
    _, qkv = ls.layer_tail_stream(att, xa, g1, stream, 0, g2)
    _, wqkv = lf.tail_plain(att, xa, g1, ls._pack_view(stream, 0, False), g2, eps=1e-5)
    torch.cuda.synchronize()
    _close(qkv[:, :C], wqkv[:, :C])


@pytest.mark.parametrize("wdt", _FP8)
def test_fp8_tiny_activations(cuda, wdt):
    # Row 0 of x scaled by 2^-16: with the TPU kernels' decode (an operand
    # of the fp8 value times 2^-120 or 2^-112) its products would fall under
    # f32's smallest normal, 2^-126. Row 0 is held to its own largest value.
    M, K, N = 8, 2048, 3072
    x, _, _, res = _decode_case(M, K, N, 0, torch.bfloat16, 230)
    x[0] *= 2.0 ** -16
    res[0] = 0
    qt = _fp8_qt(K, N, wdt, 0, 234)
    y = qm.scaled_partials(x.to(torch.bfloat16), qt)
    _close(qm.quant_linear(x, qt)[0], y[0].to(x.dtype))
    _close(df.quant_linear_residual(x, qt, res)[0], (y + res.float())[0].to(x.dtype))
    # K7: att's row 0 tiny and x's row 0 zero, so x1's row 0 is the tiny wo
    # product alone; were it flushed, the whole row of the output would be 0.
    H, I, NQ, bn = 2048, 8192, 3072, 512
    packs, stream = _tail_case(H, I, NQ, bn, 2, seed=235, wdt=wdt)
    att, xa = _rand((M, H), 236), _rand((M, H), 237)
    att[0] *= 2.0 ** -16
    xa[0] = 0
    g1, g2 = 1.0 + _rand((H,), 238, 0.1, torch.float32), 1.0 + _rand((H,), 239, 0.1, torch.float32)
    out, qkv = ls.layer_tail_stream(att, xa, g1, stream, 0, g2)
    wout, wqkv = lf.tail_plain(att, xa, g1, packs[0], g2, eps=1e-5)
    torch.cuda.synchronize()
    assert wout[0].abs().max() > 0
    _close(out[0], wout[0])
    _close(qkv[0], wqkv[0])


@pytest.mark.parametrize("mode", ["store", "residual", "swiglu", "argmax"])
@pytest.mark.parametrize("wdt", _FP8)
def test_fp8_qgemv_graph_replay_and_determinism(cuda, mode, wdt):
    # As the int8 test: two calls bit-equal; a captured call replayed after
    # x is rewritten in place equals an eager call on the new x.
    M, K, N = 8, 2048, 4096
    x, gamma, _, res = _decode_case(M, K, N, 0, torch.bfloat16, 240)
    qt = _fp8_qt(K, N, wdt, 0, 244)
    _replay_equals_eager(_decode_call(mode, x, gamma, qt, res, N - 7),
                         lambda seed: x.copy_(_rand((M, K), seed)), (245, 246))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M", [1, 8, 32])
@pytest.mark.parametrize("wdt", _FP8)
def test_fp8_layer_tail_kernel(cuda, wdt, M, dtype):
    # Llama-3.2-1B's layer tail over fp8 packs (scale rows with JAX's fixup
    # folded in): three layers of the stream and mlp_qkv_fused.
    H, I, NQ, bn = 2048, 8192, 3072, 512
    packs, stream = _tail_case(H, I, NQ, bn, 3, seed=250, wdt=wdt)
    assert stream.w.dtype != torch.int8
    att, x = _rand((M, H), 251, dtype=dtype), _rand((M, H), 252, dtype=dtype)
    g1, g2 = 1.0 + _rand((H,), 253, 0.1, torch.float32), 1.0 + _rand((H,), 254, 0.1, torch.float32)
    for layer in range(3):
        last = layer == 2
        before = ls.layer_tail_stream.launches
        out, qkv = ls.layer_tail_stream(att, x, g1, stream, layer, None if last else g2)
        torch.cuda.synchronize()
        assert ls.layer_tail_stream.launches == before + 1
        wout, wqkv = lf.tail_plain(att, x, g1, packs[layer], g2, eps=1e-5)
        _close(out, wout)
        if last:
            assert qkv is None
        else:
            _close(qkv, wqkv)
    before = lf.mlp_qkv_fused.launches
    out, qkv = lf.mlp_qkv_fused(att, x, g1, packs[0], g2)
    wout, wqkv = lf.tail_plain(att, x, g1, packs[0], g2, eps=1e-5)
    torch.cuda.synchronize()
    assert lf.mlp_qkv_fused.launches == before + 1
    _close(out, wout)
    _close(qkv, wqkv)


@pytest.mark.parametrize("wdt", _FP8)
def test_fp8_layer_tail_graph_replay_and_determinism(cuda, wdt):
    M, H, I, NQ, bn = 8, 2048, 8192, 3072, 512
    _, stream = _tail_case(H, I, NQ, bn, 2, seed=260, wdt=wdt)
    att, x = _rand((M, H), 261), _rand((M, H), 262)
    g1, g2 = 1.0 + _rand((H,), 263, 0.1, torch.float32), 1.0 + _rand((H,), 264, 0.1, torch.float32)
    _replay_equals_eager(lambda: ls.layer_tail_stream(att, x, g1, stream, 0, g2),
                         _tail_refill(att, x), (265, 266))


@pytest.mark.parametrize("M,dtype", [(1, torch.bfloat16), (8, torch.bfloat16),
                                     (32, torch.float32)])
@pytest.mark.parametrize("wdt", _FP8)
def test_fp8_mlp_block_kernel(cuda, wdt, M, dtype):
    H, I, bn = 2048, 8192, 2048  # Llama-3.2-1B's MLP block
    rng = np.random.default_rng(270)

    def w(*shape):
        return quantize(torch.from_numpy((rng.standard_normal(shape) * 0.05).astype(
            np.float32)).cuda(), wdt)

    pack = dm.pack_mlp(w(H, H), w(H, 2 * I), w(I, H), bn=bn)
    att, x = _rand((M, H), 271, dtype=dtype), _rand((M, H), 272, dtype=dtype)
    g = 1.0 + _rand((H,), 273, 0.1, torch.float32)
    before = dm.mlp_block_fused.launches
    got = dm.mlp_block_fused(att, x, g, pack)
    torch.cuda.synchronize()
    assert dm.mlp_block_fused.launches == before + 1 and got.dtype == dtype
    _close(got, dm.mlp_block_plain(att, x, g, pack, eps=1e-5))


def _tables(rng, lens, NKV, HD):
    ang = torch.from_numpy(lens[:, None].astype(np.float32) * rng.uniform(
        0.001, 1.0, (1, HD // 2)).astype(np.float32)).cuda()
    c2, s2 = torch.cos(ang), torch.sin(ang)
    return torch.cat([c2, c2], -1).repeat(1, NKV), torch.cat([-s2, s2], -1).repeat(1, NKV)


def _mega_case(H, I, NH, NKV, HD, bn, seed, with_qkv=True, wdt="int8"):
    rng = np.random.default_rng(seed)

    def w(*shape):
        return quantize(torch.from_numpy((rng.standard_normal(shape) * 0.05).astype(
            np.float32)).cuda(), wdt)

    KD = NKV * HD
    return lm.pack_mega_layer(w(NH * HD, H), w(H, 2 * I), w(I, H),
                              w(H, NH * HD + 2 * KD) if with_qkv else None, nh=NH, nkv=NKV,
                              hd=HD, bn=bn)


@pytest.mark.parametrize("H,I,NH,NKV,HD,bn,B,T,dtype,with_qkv", [
    (512, 1024, 8, 2, 64, 128, 5, 64, torch.bfloat16, True),   # G = 4
    (512, 1024, 8, 8, 64, 512, 3, 32, torch.float32, False),   # G = 1
    (2048, 8192, 32, 8, 64, 512, 8, 512, torch.bfloat16, True),  # Llama-3.2-1B
])
def test_layer_megakernel_kernel(cuda, H, I, NH, NKV, HD, bn, B, T, dtype, with_qkv):
    _mega_check(H, I, NH, NKV, HD, bn, B, T, dtype, with_qkv)


def _mega_inputs(H, NH, NKV, HD, B, T, dtype):
    rng = np.random.default_rng(41)
    KD = NKV * HD
    lens = rng.integers(1, T, B).astype(np.int32)
    lens[0] = T - 1
    cos_t, sin_t = _tables(rng, lens, NKV, HD)
    qkv = _rand((B, NH * HD + 2 * KD), 42, dtype=dtype)
    x = _rand((B, H), 43, dtype=dtype)
    g1, g2 = 1.0 + _rand((H,), 44, 0.1, torch.float32), 1.0 + _rand((H,), 45, 0.1, torch.float32)
    k, v = _rand((B, T, NKV, HD), 46), _rand((B, T, NKV, HD), 47)
    return qkv, x, g1, g2, k, v, torch.from_numpy(lens).cuda(), cos_t, sin_t


def _mega_check(H, I, NH, NKV, HD, bn, B, T, dtype, with_qkv, wdt="int8"):
    pack = _mega_case(H, I, NH, NKV, HD, bn, 40, with_qkv, wdt)
    qkv, x, g1, g2, k, v, ln, cos_t, sin_t = _mega_inputs(H, NH, NKV, HD, B, T, dtype)
    kp, vp = k.clone(), v.clone()
    gn = g2 if with_qkv else None
    before = lm.layer_megakernel.launches
    out, qkv_n, k2, v2 = lm.layer_megakernel(qkv, x, g1, pack, k, v, ln, cos_t, sin_t, gn,
                                             num_heads=NH)
    torch.cuda.synchronize()
    assert lm.layer_megakernel.launches == before + 1 and k2 is k and v2 is v
    wout, wqkv, _, _ = lm.layer_megakernel_plain(qkv, x, g1, pack, kp, vp, ln, cos_t, sin_t,
                                                 g2, num_heads=NH, eps=1e-5,
                                                 scale=HD ** -0.5)
    _close(out, wout)
    if with_qkv:
        _close(qkv_n, wqkv)
    else:
        assert qkv_n is None
    rows = torch.arange(B, device="cuda")
    _close(k[rows, ln.long()], kp[rows, ln.long()])
    _close(v[rows, ln.long()], vp[rows, ln.long()])
    keep = torch.ones(B, T, dtype=torch.bool, device="cuda")
    keep[rows, ln.long()] = False
    assert torch.equal(k[keep], kp[keep]) and torch.equal(v[keep], vp[keep])


@pytest.mark.parametrize("B,shape,dtype", [
    (1, (512, 1024, 8, 2, 64, 128, 64), torch.bfloat16),
    (8, (2048, 8192, 32, 8, 64, 512, 512), torch.bfloat16),  # Llama-3.2-1B
    (32, (512, 1024, 8, 2, 64, 128, 64), torch.float32),
])
@pytest.mark.parametrize("wdt", _FP8)
def test_layer_megakernel_fp8_kernel(cuda, wdt, B, shape, dtype):
    # fp8 tile streams (pack_decode_megalayers over fp8 params) at M 1, 8
    # and 32, against the plain version on the same pack; held as int8.
    H, I, NH, NKV, HD, bn, T = shape
    _mega_check(H, I, NH, NKV, HD, bn, B, T, dtype, True, wdt)


@pytest.mark.parametrize("wdt", ["int8", *_FP8])
def test_layer_megakernel_graph_replay_and_determinism(cuda, wdt):
    # Two calls on the same inputs write the same row and give the same
    # bits; a captured call replayed after x and qkv change in place equals
    # an eager call on them.
    H, I, NH, NKV, HD, bn, B, T = 512, 1024, 8, 2, 64, 128, 5, 64
    pack = _mega_case(H, I, NH, NKV, HD, bn, 48, True, wdt)
    qkv, x, g1, g2, k, v, ln, cos_t, sin_t = _mega_inputs(H, NH, NKV, HD, B, T, torch.bfloat16)

    def call():
        return lm.layer_megakernel(qkv, x, g1, pack, k, v, ln, cos_t, sin_t, g2, num_heads=NH)

    first = [t.clone() for t in call()[:2]]
    second = call()
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = call()
    for seed in (49, 50):
        x.copy_(_rand((B, H), seed))
        qkv.copy_(_rand(tuple(qkv.shape), seed + 10))
        g.replay()
        torch.cuda.synchronize()
        want = call()
        torch.cuda.synchronize()
        assert torch.equal(out[0], want[0]) and torch.equal(out[1], want[1])


def _giga_case(L, H, I, NH, NKV, HD, bn, VP, vocab, seed, bf16=False, std=0.05):
    # bf16: unit-scale bf16 tiles (pack_decode_giga(bf16_stream=True)'s).
    rng = np.random.default_rng(seed)

    def w(*shape):
        raw = torch.from_numpy((rng.standard_normal(shape) * std).astype(np.float32)).cuda()
        return unit_qtensor(raw.to(torch.bfloat16)) if bf16 else quantize(raw, "int8")

    KD = NKV * HD
    layers = [(w(NH * HD, H), w(H, 2 * I), w(I, H), w(H, NH * HD + 2 * KD)) for _ in range(L)]
    g = lambda *s: 1.0 + _rand(s, seed + len(s), 0.1, torch.float32)  # noqa: E731
    inv = (1.0 / 10000.0 ** (np.arange(0, HD, 2) / HD)).astype(np.float32)
    return dg.pack_giga(layers, w(H, VP), g(L, H), g(L, H) * 0.9, g(H), nh=NH, nkv=NKV, hd=HD,
                        vocab=vocab, bn=bn, rope_inv_freq=inv)


def _giga_gate(got, want, L, B):
    tok, logits = got[0].reshape(-1), got[1].float()
    wtok, wlogits = want[0].reshape(-1), want[1].float()
    assert int((tok == wtok).sum()) >= (B * 7) // 8, (tok, wtok)
    assert torch.isfinite(logits).all()
    torch.testing.assert_close(logits, wlogits, rtol=5e-2, atol=5e-2 * max(1.0, L / 4))


@pytest.mark.parametrize("mode", ["x", "tokens"])
@pytest.mark.parametrize("L,H,I,NH,NKV,HD,bn,VP,vocab,B,T", [
    (2, 512, 1024, 8, 2, 64, 128, 1024, 1000, 5, 64),  # G = 4
    (2, 512, 1024, 8, 8, 64, 512, 1024, 1000, 3, 32),  # G = 1 (the JAX tests' shape)
])
def test_giga_kernel(cuda, mode, L, H, I, NH, NKV, HD, bn, VP, vocab, B, T):
    _giga_check(mode, L, H, I, NH, NKV, HD, bn, VP, vocab, B, T)


@pytest.mark.parametrize("B", [1, 8, 32])
@pytest.mark.parametrize("L,H,I,NH,NKV,HD,bn,VP,vocab,T,std", [
    (2, 512, 1024, 8, 2, 64, 128, 1024, 1000, 64, 0.05),  # 128-column units, G = 4
    # Llama-3.2-1B's layer widths at its init scale, as the gate's own bench
    # (benchmarks/r5_giga.py) runs it: wider layers at std 0.05 grow the
    # activations until the kernel's f32 residual and the plain version's
    # bf16 one part by more than the gate's absolute term, int8 or bf16.
    (2, 2048, 8192, 32, 8, 64, 512, 2560, 2000, 64, 0.02),
])
def test_giga_bf16_stream_kernel(cuda, L, H, I, NH, NKV, HD, bn, VP, vocab, B, T, std):
    # pack_decode_giga(bf16_stream=True)'s stream at M 1, 8 and 32 against
    # the plain version, with the giga gate.
    _giga_check("tokens", L, H, I, NH, NKV, HD, bn, VP, vocab, B, T, bf16=True, std=std)


def _giga_check(mode, L, H, I, NH, NKV, HD, bn, VP, vocab, B, T, bf16=False, std=0.05):
    pack = _giga_case(L, H, I, NH, NKV, HD, bn, VP, vocab, 50, bf16, std)
    assert pack.w.dtype == (torch.bfloat16 if bf16 else torch.int8)
    rng = np.random.default_rng(51)
    KD = NKV * HD
    lens = rng.integers(1, T, B).astype(np.int32)
    lens[0] = T - 1
    ln = torch.from_numpy(lens).cuda()
    kpool, vpool = _rand((L, B, T, KD), 52), _rand((L, B, T, KD), 53)
    k0, v0 = kpool.clone(), vpool.clone()
    kw, vw = kpool.clone(), vpool.clone()
    if mode == "x":
        x = _rand((B, H), 54)
        cos_t, sin_t = _tables(rng, lens, NKV, HD)
        args, kwargs = (x, cos_t, sin_t), {}
        plain_in = (x, cos_t, sin_t)
    else:
        wte = _rand((1000, H), 55)
        tokens = torch.from_numpy(rng.integers(0, 1000, B).astype(np.int32)).cuda()
        args, kwargs = (wte, None, None), {"tokens": tokens}
        plain_in = dg._embed_rope(wte, tokens, ln, pack)
    before = dg.giga_decode_step.launches
    got = dg.giga_decode_step(*args, ln, pack, kpool, vpool, **kwargs)
    torch.cuda.synchronize()
    assert dg.giga_decode_step.launches == before + 1
    assert got[2] is kpool and got[3] is vpool
    assert got[0].dtype == torch.int32 and got[1].shape == (B, pack.n_head * bn)
    want = dg.giga_decode_plain(*plain_in, ln, pack, kw, vw, sm_scale=HD ** -0.5)
    _giga_gate(got, want, L, B)
    assert int(got[0].max()) < vocab
    assert not got[1][:, -(pack.n_head * bn - VP):].float().any()  # the zero pad tiles
    rows = torch.arange(B, device="cuda")
    for pool, ref, orig in ((kpool, kw, k0), (vpool, vw, v0)):
        for l in range(L):
            _close(pool[l][rows, ln.long()], ref[l][rows, ln.long()])
        pool[:, rows, ln.long()] = orig[:, rows, ln.long()]
        assert torch.equal(pool, orig)  # no other row was touched


@pytest.mark.parametrize("L,H,I,NH,NKV,HD,bn,VP,vocab,B,T", [
    (2, 512, 1024, 8, 2, 64, 128, 1024, 1000, 5, 64),  # 128-column units
    (2, 512, 1024, 8, 8, 64, 512, 1024, 1000, 3, 32),  # 256-column units
])
def test_giga_kernel_graph_replay_and_determinism(cuda, L, H, I, NH, NKV, HD, bn, VP, vocab, B,
                                                  T):
    _giga_replay(L, H, I, NH, NKV, HD, bn, VP, vocab, B, T)


@pytest.mark.parametrize("L,H,I,NH,NKV,HD,bn,VP,vocab,B,T", [
    (2, 512, 1024, 8, 2, 64, 128, 1024, 1000, 5, 64),  # 128-column units
    (2, 512, 1024, 8, 8, 64, 512, 1024, 1000, 3, 32),  # 256-column units
])
def test_giga_bf16_stream_graph_replay_and_determinism(cuda, L, H, I, NH, NKV, HD, bn, VP,
                                                       vocab, B, T):
    _giga_replay(L, H, I, NH, NKV, HD, bn, VP, vocab, B, T, bf16=True)


def _giga_replay(L, H, I, NH, NKV, HD, bn, VP, vocab, B, T, bf16=False):
    # Two steps on the same inputs are bit-equal (the rows they write are
    # not among the rows they read); a captured step replayed after the
    # tokens are rewritten in place equals an eager step on the new tokens.
    pack = _giga_case(L, H, I, NH, NKV, HD, bn, VP, vocab, 160, bf16)
    rng = np.random.default_rng(161)
    lens = torch.from_numpy(rng.integers(1, T - 1, B).astype(np.int32)).cuda()
    kpool, vpool = _rand((L, B, T, NKV * HD), 162), _rand((L, B, T, NKV * HD), 163)
    wte = _rand((1000, H), 164)
    tokens = torch.from_numpy(rng.integers(0, 1000, B).astype(np.int32)).cuda()

    def call():
        return dg.giga_decode_step(wte, None, None, lens, pack, kpool, vpool, tokens=tokens)

    first, second = call(), call()
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = call()
    for seed in (165, 166):
        tokens.copy_(torch.from_numpy(
            np.random.default_rng(seed).integers(0, 1000, B).astype(np.int32)))
        g.replay()
        torch.cuda.synchronize()
        want = call()
        torch.cuda.synchronize()
        assert torch.equal(out[0], want[0]) and torch.equal(out[1], want[1])


def test_giga_kernel_leaves_a_full_cache_alone(cuda):
    """At lens[b] == T nothing is written (the token is still attended)."""
    L, H, I, NH, NKV, HD, bn, B, T = 2, 512, 1024, 8, 2, 64, 128, 3, 32
    pack = _giga_case(L, H, I, NH, NKV, HD, bn, 1024, 1000, 60)
    lens = np.array([T, 4, T - 1], np.int32)
    ln = torch.from_numpy(lens).cuda()
    kpool, vpool = _rand((L, B, T, NKV * HD), 61), _rand((L, B, T, NKV * HD), 62)
    k0, v0 = kpool.clone(), vpool.clone()
    wte = _rand((1000, H), 63)
    tok, logits, _, _ = dg.giga_decode_step(wte, None, None, ln, pack, kpool, vpool,
                                            tokens=torch.tensor([1, 2, 3], device="cuda"))
    torch.cuda.synchronize()
    assert torch.isfinite(logits.float()).all() and 0 <= int(tok.min()) <= int(tok.max()) < 1000
    assert torch.equal(kpool[:, 0], k0[:, 0]) and torch.equal(vpool[:, 0], v0[:, 0])
    assert not torch.equal(kpool[:, 1, 4], k0[:, 1, 4])


def test_giga_and_mega_refuse_other_streams(cuda):
    # The whole-step kernel takes int8 and bf16 streams (tested above); the
    # per-layer one takes no bf16 pack (JAX's pack_decode_megalayers packs
    # quantized params only) and raises on one.
    pack = _giga_case(2, 512, 1024, 8, 2, 64, 128, 1024, 1000, 70)
    kpool = _rand((2, 2, 32, 128), 71)
    H, NH, NKV, HD, B, T = 512, 8, 2, 64, 2, 32
    mega = _mega_case(H, 1024, NH, NKV, HD, 128, 40)
    bf = mega._replace(w=mega.w.to(torch.bfloat16))
    qkv, x, g1, g2, k, v, ln, cos_t, sin_t = _mega_inputs(H, NH, NKV, HD, B, T, torch.bfloat16)
    with pytest.raises(NotImplementedError):
        lm.layer_megakernel(qkv, x, g1, bf, k, v, ln, cos_t, sin_t, g2, num_heads=NH)
    before = dg.giga_decode_step.launches
    cpu = dg.GigaPack(*(v.cpu() if isinstance(v, torch.Tensor) else v for v in pack))
    dg.giga_decode_step(_rand((1000, 512), 72).cpu(), None, None, torch.tensor([1, 2]), cpu,
                        kpool.cpu(), kpool.cpu(), tokens=torch.tensor([1, 2]))
    assert dg.giga_decode_step.launches == before  # a CPU tensor takes the plain version


@pytest.mark.parametrize("M,K,N,bs,dtype", [
    (1, 2048, 3072, 0, torch.bfloat16),
    (8, 2048, 3072, 0, torch.bfloat16),
    (32, 2048, 3072, 0, torch.bfloat16),
    (8, 8192, 2048, 0, torch.bfloat16),
    (8, 2048, 128256, 0, torch.bfloat16),  # the unpadded vocab: N divides by 256 only
    (32, 2048, 128256, 0, torch.bfloat16),  # M 32 on the vocab head: four n-tiles, K slices
    (1, 2048, 2048, 128, torch.bfloat16),  # blocked: the halves read different scale rows
    (8, 2048, 2048, 128, torch.bfloat16),
    (32, 2048, 2048, 128, torch.bfloat16),
    (20, 512, 1024, 128, torch.float32),
    (3, 1024, 768, 0, torch.float32),
])
def test_int4_kernel(cuda, M, K, N, bs, dtype):
    x = _rand((M, K), 40, dtype=dtype)
    w = _rand((K, N), 41, 0.05, torch.float32)
    w[K // 2:] *= 4.0  # the high half's scales differ from the low half's
    qt = quantize(w, "int4", bs)
    assert qm._int4_blocks(M, K, N, qt.block_size)[0]
    before = qm.quant_linear_int4.launches
    got = qm.quant_linear(x, qt)
    torch.cuda.synchronize()
    assert qm.quant_linear_int4.launches == before + 1
    _close(got, qm.quant_linear_int4_plain(x, qt))


@pytest.mark.parametrize("M,K,N,bs", [
    (8, 2048, 3072, 0),      # K slices merged by the last block of a column tile
    (8, 2048, 128256, 0),    # one slice
    (32, 2048, 2048, 128),   # blocked scales, four n-tiles
])
def test_int4_kernel_graph_replay_and_determinism(cuda, M, K, N, bs):
    # Two calls are bit-equal (the K slices add in a fixed order); one call
    # captured in a CUDA graph, replayed after x is rewritten in place,
    # equals an eager call on the new x (the arrival counters are back at 0
    # after every launch).
    x = _rand((M, K), 48)
    qt = quantize(_rand((K, N), 49, 0.05, torch.float32), "int4", bs)
    first, second = qm.quant_linear_int4(x, qt), qm.quant_linear_int4(x, qt)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = qm.quant_linear_int4(x, qt)
    for seed in (50, 51):
        x.copy_(_rand((M, K), seed))
        g.replay()
        torch.cuda.synchronize()
        want = qm.quant_linear_int4(x, qt)
        torch.cuda.synchronize()
        assert torch.equal(out, want)
    _close(out, qm.quant_linear_int4_plain(x, qt))


def test_int4_prefill_unpacks_to_the_int8_kernel(cuda):
    x = _rand((64, 2048), 42)
    qt = quantize(_rand((2048, 2048), 43, 0.05, torch.float32), "int4")
    before = (qm.quant_linear.launches, qm.quant_linear_int4.launches)
    got = qm.quant_linear(x, qt)
    torch.cuda.synchronize()
    assert (qm.quant_linear.launches, qm.quant_linear_int4.launches) == (before[0] + 1,
                                                                          before[1])
    _close(got, qm.quant_linear_plain(x, qt))


def test_int4_decode_entries_route_to_the_int4_kernel(cuda):
    M, K, N = 8, 2048, 4096
    x = _rand((M, K), 44)
    gamma = 1.0 + _rand((K,), 45, 0.1, torch.float32)
    qt = quantize(_rand((K, N), 46, 0.05, torch.float32), "int4")
    res = _rand((M, N), 47)
    before = qm.quant_linear_int4.launches
    _close(df.rms_quant_linear(x, gamma, qt), df.rms_quant_linear_plain(x, gamma, qt))
    _close(df.quant_linear_residual(x, qt, res), df.quant_linear_residual_plain(x, qt, res))
    _close(df.rms_quant_linear_swiglu(x, gamma, qt),
           df.rms_quant_linear_swiglu_plain(x, gamma, qt))
    assert df.rms_quant_linear_argmax(x, gamma, qt, vocab_size=N) is None
    torch.cuda.synchronize()
    assert qm.quant_linear_int4.launches == before + 3


@pytest.mark.parametrize("B,Tq,Tkv,NH,NKV,D,off,causal", [
    (1, 512, 512, 4, 1, 64, 0, True),
    (2, 256, 256, 8, 2, 64, 0, True),  # G 4
    (1, 512, 512, 4, 4, 128, 0, True),  # D 128, G 1
    (2, 256, 256, 8, 2, 128, 0, True),
    (1, 128, 512, 8, 2, 64, 384, True),  # kv_offset window
    (2, 80, 256, 4, 1, 64, 176, True),  # a ragged last q tile
    (2, 256, 384, 8, 2, 64, 0, False),  # not causal
    (2, 208, 384, 8, 2, 128, 0, False),
    (1, 512, 512, 24, 8, 128, 0, True),  # G 3 at D 128
    (2, 128, 128, 4, 2, 64, 0, True),  # one key tile
    (3, 208, 384, 4, 2, 64, 176, True),  # a ragged q tile in a middle batch row
    (3, 208, 384, 4, 2, 128, 176, True),
    (8, 1024, 1024, 12, 12, 64, 0, True),  # GPT-2's training shape
    (1, 512, 512, 4, 2, 192, 0, True),  # D 192 and 256: 384 threads, setmaxnreg
    (2, 208, 384, 8, 2, 256, 176, True),  # ragged q tiles, kv_offset
    (2, 256, 384, 8, 2, 192, 0, False),
    (1, 1024, 1024, 16, 8, 256, 0, True),  # 2 ring stages over 16 key tiles
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_kernel(cuda, B, Tq, Tkv, NH, NKV, D, off, causal, dtype):
    from mila_tpu_torch.kernels import flash_attention as fa

    assert fa.routes(dtype, D)[0] == "wgmma"
    q = _rand((B, Tq, NH, D), 48, dtype=dtype)
    k = _rand((B, Tkv, NKV, D), 49, dtype=dtype)
    v = _rand((B, Tkv, NKV, D), 50, dtype=dtype)
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, causal=causal, kv_offset=off)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    # Each (b, t, head) row against its own largest value: a row that
    # attends to n keys holds values of about sqrt(e / n), far under |v|.
    got, want = got.float(), fa.flash_attention_plain(q, k, v, causal=causal,
                                                      kv_offset=off).float()
    assert torch.isfinite(got).all()
    row_err = (got - want).abs().amax(-1) / want.abs().amax(-1)
    assert row_err.max().item() <= 2e-2, f"worst row's relative err {row_err.max().item()}"


@pytest.mark.parametrize("B,T,NH,NKV,D,off,causal", [
    (8, 1024, 12, 12, 64, 0, True),  # GPT-2's training shape
    (2, 1024, 32, 8, 64, 0, True),  # Llama-3.2-1B's GQA heads
    (1, 1024, 24, 8, 128, 0, True),  # D 128
    (3, 208, 4, 2, 64, 176, True),  # ragged q tiles, kv_offset (Tkv 384)
    (2, 256, 8, 2, 128, 0, False),
    (1, 1024, 16, 8, 192, 0, True),  # D 192 and 256 (chip_smoke's heads)
    (3, 208, 4, 2, 256, 176, True),
    (2, 256, 8, 2, 256, 0, False),
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_stats_kernel(cuda, B, T, NH, NKV, D, off, causal, dtype):
    # The statistics launch's l and m against the plain version's at
    # chip_smoke's limits: l within 1e-4 relative (f32 sums in another
    # order), m within 1e-3 absolute (the max of the scaled scores, m in
    # natural units though the kernel works in base 2).
    from mila_tpu_torch.kernels import flash_attention as fa

    q = _rand((B, T, NH, D), 100, dtype=dtype)
    k = _rand((B, T + off, NKV, D), 101, dtype=dtype)
    v = _rand((B, T + off, NKV, D), 102, dtype=dtype)
    sm = D ** -0.5
    o, l, m = fa.flash_attention_forward(q, k, v, causal=causal, sm_scale=sm, kv_offset=off)
    o_ref, l_ref, m_ref = fa.flash_attention_plain(q, k, v, causal=causal, scale=sm,
                                                   kv_offset=off, save_stats=True)
    assert l.shape == l_ref.shape == m.shape == (B, NH, T)
    assert _row_err(o, o_ref) <= 2e-2
    assert ((l - l_ref).abs() / l_ref).max().item() <= 1e-4
    assert (m - m_ref).abs().max().item() <= 1e-3


@pytest.mark.parametrize("dtype,D", [(torch.bfloat16, 128), (torch.float16, 64),
                                     (torch.float16, 128), (torch.bfloat16, 192),
                                     (torch.bfloat16, 256), (torch.float16, 192),
                                     (torch.float16, 256)])
def test_flash_kernel_graph_replay_and_determinism(cuda, dtype, D):
    # One call captured in a CUDA graph (the TMA descriptors are kernel
    # parameters, encoded at capture); q, k, v rewritten in place, then the
    # replay equals an eager call on the new values bit for bit. Two eager
    # launches on the same inputs are bit-equal (no atomics, a fixed order).
    from mila_tpu_torch.kernels import flash_attention as fa

    shape_q, shape_kv = (2, 384, 8, D), (2, 512, 2, D)
    q, k, v = (_rand(sh, s, dtype=dtype) for sh, s in ((shape_q, 103), (shape_kv, 104),
                                                      (shape_kv, 105)))
    sm = D ** -0.5
    first = fa.flash_attention_forward(q, k, v, causal=True, sm_scale=sm, kv_offset=128)
    again = fa.flash_attention_forward(q, k, v, causal=True, sm_scale=sm, kv_offset=128)
    for a, b in zip(first, again):
        assert torch.equal(a, b)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        graphed = fa.flash_attention(q, k, v, kv_offset=128)
    q.copy_(_rand(shape_q, 106, dtype=dtype))
    k.copy_(_rand(shape_kv, 107, dtype=dtype))
    v.copy_(_rand(shape_kv, 108, dtype=dtype))
    g.replay()
    torch.cuda.synchronize()
    eager = fa.flash_attention(q, k, v, kv_offset=128)
    assert torch.equal(graphed, eager)
    assert _row_err(eager, fa.flash_attention_plain(q, k, v, kv_offset=128)) <= 2e-2


def test_flash_kernel_copies_an_unaligned_view(cuda):
    # q as a contiguous view whose base sits 2 bytes past a 16-byte
    # boundary: TMA cannot read it, so the wrapper copies it and computes.
    from mila_tpu_torch.kernels import flash_attention as fa

    B, T, NH, NKV, D = 1, 256, 4, 2, 64
    flat = _rand((B * T * NH * D + 1,), 109)
    q = flat[1:].view(B, T, NH, D)
    assert q.is_contiguous() and q.data_ptr() % 16 != 0
    k, v = _rand((B, T, NKV, D), 110), _rand((B, T, NKV, D), 111)
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    assert _row_err(got, fa.flash_attention_plain(q, k, v)) <= 2e-2


def test_flash_kernel_refuses_grad_and_f32(cuda):
    # A call under grad no longer raises: it takes the launch with
    # statistics and the backward kernel (row 16). f32 inputs run too (the
    # mma.sync family, tested below), and head sizes past 256; what still
    # raises: f64 inputs, and a head size the tiling gate refuses when the
    # launch is reached past the gate.
    from mila_tpu_torch.kernels import flash_attention as fa
    from mila_tpu_torch.kernels import flash_attention_bwd as fb

    q, k, v = (_rand((1, 128, 4, 64), s) for s in (51, 52, 53))
    before = (fa.flash_attention_forward.launches, fb.flash_attention_bwd.launches)
    out = fa.flash_attention(q.requires_grad_(), k, v)
    out.float().sum().backward()
    torch.cuda.synchronize()
    assert (fa.flash_attention_forward.launches, fb.flash_attention_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    assert q.grad is not None and torch.isfinite(q.grad.float()).all()
    f32 = fa.flash_attention(q.detach().float(), k.float(), v.float())
    assert f32.dtype == torch.float32 and _row_err(f32, fa.flash_attention_plain(
        q.detach().float(), k.float(), v.float())) <= 2e-2
    with pytest.raises(NotImplementedError):
        fa.flash_attention(q.detach().double(), k.double(), v.double())
    q3, k3 = _rand((1, 128, 4, 320), 54), _rand((1, 128, 4, 320), 55)
    assert _row_err(fa.flash_attention(q3, k3, k3), fa.flash_attention_plain(q3, k3, k3)) <= 2e-2
    q4, k4 = _rand((1, 128, 4, 96), 56), _rand((1, 128, 4, 96), 57)
    with pytest.raises(NotImplementedError, match="D % 64"):
        fa.flash_attention_forward(q4, k4, k4, sm_scale=96 ** -0.5)


def test_flash_gate_routes_before_the_kernel(cuda):
    # A shape JAX's tiling gate refuses (Tq % 16) never reaches the kernel
    # wrapper: attention(impl="flash") takes the plain product, and the
    # wrapper itself raises rather than run it.
    from mila_tpu_torch.kernels import flash_attention as fa
    from mila_tpu_torch.ops.attention import attention, dot_product_attention

    q, k, v = _rand((1, 200, 4, 64), 56), _rand((1, 256, 2, 64), 57), _rand((1, 256, 2, 64), 58)
    before = fa.flash_attention.launches
    got = attention(q, k, v, causal=True, kv_offset=56, impl="flash")
    assert fa.flash_attention.launches == before
    _close(got, dot_product_attention(q, k, v, causal=True, kv_offset=56))
    with pytest.raises(ValueError, match="gate"):
        fa.flash_attention(q, k, v, kv_offset=56)


@pytest.mark.parametrize("B,NH,NKV,HD,ps,W,dtype", [
    (8, 32, 8, 64, 128, 8, torch.bfloat16),
    (3, 8, 2, 32, 16, 6, torch.float32),
    (4, 16, 2, 128, 16, 9, torch.bfloat16),
    (8, 8, 8, 64, 128, 32, torch.bfloat16),    # G 1, B 8 up to 4096 tokens
    (8, 32, 8, 64, 128, 32, torch.bfloat16),   # serve long's shape
    (2, 64, 8, 128, 16, 40, torch.bfloat16),   # G 8, HD 128
    (1, 32, 8, 64, 128, 32, torch.bfloat16),   # one row of 4096 tokens
    (1, 32, 8, 128, 128, 32, torch.float32),
])
def test_paged_attention_int8_pages(cuda, B, NH, NKV, HD, ps, W, dtype):
    rng = np.random.default_rng(54)
    q, kp, vp, sc, t = _paged_inputs(rng, B, NH, NKV, HD, ps, W, dtype, True, 55)
    for ln in _paged_lens(rng, B, NKV, W, ps):
        before = pa.paged_decode_attention.launches
        got = pa.paged_decode_attention(q, kp, vp, t, ln, **sc)
        torch.cuda.synchronize()
        assert pa.paged_decode_attention.launches == before + 1
        # The plain version dequantizes the pages to q's dtype first (the JAX
        # CPU path); the kernel folds the scales in f32: one bf16 step apart.
        _close(got, pa.paged_decode_attention_plain(q, kp, vp, t, ln, **sc))


def _row_err(got, want, floor=1e-3):
    """max over (.., row) of max |got - want| / max |want| in that row, the
    row's scale floored at ``floor`` x the tensor's max |want|: a row whose
    exact value is 0 (dq of query 0 under the causal mask, whose one key
    gives ds = p (do.v - do.o) = 0) holds rounding noise on both sides."""
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    d = (got - want).abs().amax(-1)
    scale = want.abs().amax(-1).clamp_min(floor * want.abs().max().item() + 1e-30)
    return (d / scale).max().item()


@pytest.mark.parametrize("B,Tq,Tkv,NH,NKV,D,off,causal", [
    (2, 256, 256, 4, 4, 64, 0, True),
    (1, 512, 512, 8, 2, 64, 0, True),  # G 4
    (2, 256, 256, 4, 2, 128, 0, True),  # D 128
    (1, 128, 512, 8, 2, 64, 384, True),  # kv_offset window
    (2, 80, 256, 4, 1, 64, 176, True),  # a ragged last q tile
    (1, 192, 256, 4, 2, 64, 0, False),  # not causal
    (2, 320, 320, 8, 2, 64, 0, True),  # Tkv not a multiple of the forward's 128
    (1, 1024, 1024, 32, 8, 64, 0, True),  # Llama-3.2-1B's GQA heads
    (1, 256, 768, 24, 8, 128, 512, True),  # D 128 GQA, a kv_offset window
    (2, 192, 320, 4, 2, 128, 128, True),  # a dQ tile half past Tq, Tkv 320
    (4, 1088, 1088, 12, 12, 64, 0, True),  # 192-key dK/dV blocks, the last one 2/3 full
    (2, 448, 1088, 16, 16, 128, 640, True),  # 128-key blocks at D 128, a kv_offset window
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_bwd_kernel(cuda, B, Tq, Tkv, NH, NKV, D, off, causal, dtype):
    # The statistics launch against the plain forward, then the backward
    # kernel against its plain version on the same (q, k, v, o, l, m, do).
    # Gate: each (b, t, head) row within 2e-2 of its own largest value (a
    # row of dk/dv over few queries is far smaller than the first rows').
    # The forward kernel takes Tkv % 128 == 0 only; at other key counts the
    # backward runs on the plain forward's o, l and m.
    from mila_tpu_torch.kernels import flash_attention as fa
    from mila_tpu_torch.kernels import flash_attention_bwd as fb

    assert fa.routes(dtype, D) == ("wgmma", "wgmma")
    q, k, v = (_rand(sh, s, dtype=dtype) for sh, s in (((B, Tq, NH, D), 60),
                                                      ((B, Tkv, NKV, D), 61),
                                                      ((B, Tkv, NKV, D), 62)))
    do = _rand((B, Tq, NH, D), 63, dtype=dtype)
    sm = D ** -0.5
    o_ref, l_ref, m_ref = fa.flash_attention_plain(q, k, v, causal=causal, scale=sm,
                                                   kv_offset=off, save_stats=True)
    if Tkv % 128:
        o, l, m = o_ref, l_ref, m_ref
    else:
        before = fa.flash_attention_forward.launches
        o, l, m = fa.flash_attention_forward(q, k, v, causal=causal, sm_scale=sm, kv_offset=off)
        torch.cuda.synchronize()
        assert fa.flash_attention_forward.launches == before + 1
        assert _row_err(o, o_ref) <= 2e-2
        torch.testing.assert_close(m, m_ref, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(l, l_ref, rtol=1e-4, atol=1e-5)
    hm = [t.transpose(1, 2) for t in (q, k, v, o, do)]
    before = fb.flash_attention_bwd.launches
    got = fb.flash_attention_bwd(*hm[:4], l, m, hm[4], causal=causal, sm_scale=sm, kv_offset=off)
    torch.cuda.synchronize()
    assert fb.flash_attention_bwd.launches == before + 1
    want = fb.flash_attention_bwd_plain(*hm[:4], l, m, hm[4], causal=causal, sm_scale=sm,
                                        kv_offset=off)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        err = _row_err(a.transpose(1, 2), b.transpose(1, 2))
        assert err <= 2e-2, f"{name}: worst row's relative err {err}"


_SYNC_CASES = [  # (dtype, D, B, Tq, Tkv, NH, NKV, kv_offset, causal)
    (torch.float32, 64, 8, 1024, 1024, 12, 12, 0, True),  # GPT-2 in f32
    (torch.float32, 128, 2, 256, 384, 8, 2, 128, True),
    (torch.float32, 192, 1, 208, 256, 4, 2, 48, True),  # a ragged q tile
    (torch.float32, 256, 2, 256, 256, 4, 1, 0, False),
    # Past D 256 (the forward's column parts of up to 512 columns on tf32
    # wgmma), ragged q tiles, kv_offset windows, not causal, and D 1024 on a
    # small T.
    (torch.float32, 320, 1, 256, 256, 4, 2, 0, True),
    (torch.float32, 512, 1, 208, 384, 4, 2, 176, True),
    (torch.float32, 1024, 1, 128, 128, 2, 1, 0, True),
    # f32 backward past D 256 (flash_sync_bwd.cu: split): ragged q tiles
    # under a kv_offset window, a 512-column part with 384 columns, two
    # parts (320 + 256 columns), and chip_smoke's D 320 row.
    (torch.float32, 320, 2, 208, 384, 4, 2, 176, True),
    (torch.float32, 384, 1, 256, 256, 4, 2, 0, False),
    (torch.float32, 576, 1, 128, 256, 4, 1, 128, True),
    (torch.float32, 320, 1, 2048, 2048, 16, 8, 0, True),
    # f32 on the tf32 family (_family): GQA 32/8, NH = NKV, kv_offset > 0
    # with Tq < Tkv, not causal, Tq % 64 != 0, chip_smoke's f32 shapes; at D
    # 192 and 256 the mma.sync backward on the tf32 forward's l and m.
    (torch.float32, 64, 1, 1024, 1024, 32, 8, 0, True),
    (torch.float32, 64, 2, 80, 256, 4, 1, 176, True),
    (torch.float32, 64, 1, 128, 512, 8, 2, 384, True),
    (torch.float32, 64, 1, 192, 256, 4, 2, 0, False),
    (torch.float32, 64, 2, 336, 384, 8, 8, 48, True),
    (torch.float32, 128, 1, 1024, 1024, 32, 8, 0, True),
    (torch.float32, 128, 2, 208, 384, 4, 4, 176, True),
    (torch.float32, 128, 1, 256, 256, 4, 1, 0, False),
    (torch.float32, 128, 1, 2048, 2048, 16, 8, 0, True),
    (torch.float32, 192, 1, 2048, 2048, 16, 8, 0, True),
    (torch.float32, 256, 2, 256, 384, 4, 2, 128, True),
    (torch.float32, 256, 2, 80, 256, 4, 4, 176, True),
    (torch.float32, 256, 1, 2048, 2048, 16, 8, 0, True),
]
# bf16 and fp16 at D 192 and 256: the wgmma forward (384 threads,
# setmaxnreg) with its statistics, the wgmma backward on them.
_SYNC_FWD_CASES = [
    (torch.bfloat16, 192, 1, 512, 512, 8, 2, 0, True),
    (torch.bfloat16, 256, 2, 208, 384, 4, 2, 176, True),
    (torch.bfloat16, 256, 1, 2048, 2048, 16, 8, 0, True),  # chip_smoke's D 256 row
    (torch.float16, 192, 1, 128, 512, 4, 1, 384, True),
    (torch.float16, 256, 2, 256, 384, 4, 2, 128, True),
    (torch.float16, 256, 2, 256, 256, 8, 2, 0, False),
]


def _sync_forward_then_backward(dtype, D, B, Tq, Tkv, NH, NKV, off, causal,
                                plain_entry=False):
    # The forward with its statistics against the plain version, then the
    # backward on them against its plain version. Gate: each (b, t, head)
    # row within 2e-2 of its own largest value, 5e-3 for f32 (its products
    # run on tf32 operands, 10 mantissa bits, about 2^-11 of each product;
    # bf16 operands would miss it). l and m as test_flash_stats_kernel holds
    # them (1e-4 relative, 1e-3 absolute), but 1e-2 both for f32.
    # plain_entry: also flash_attention (the launch without statistics),
    # held to the same row gate.
    from mila_tpu_torch.kernels import flash_attention as fa
    from mila_tpu_torch.kernels import flash_attention_bwd as fb

    q = _rand((B, Tq, NH, D), 170, dtype=dtype)
    k, v = _rand((B, Tkv, NKV, D), 171, dtype=dtype), _rand((B, Tkv, NKV, D), 172, dtype=dtype)
    do = _rand((B, Tq, NH, D), 173, dtype=dtype)
    sm = D ** -0.5
    before = (fa.flash_attention_forward.launches, fb.flash_attention_bwd.launches)
    o, l, m = fa.flash_attention_forward(q, k, v, causal=causal, sm_scale=sm, kv_offset=off)
    o_ref, l_ref, m_ref = fa.flash_attention_plain(q, k, v, causal=causal, scale=sm,
                                                   kv_offset=off, save_stats=True)
    row_tol = 5e-3 if dtype == torch.float32 else 2e-2
    assert o.dtype == dtype and _row_err(o, o_ref, floor=0.0) <= row_tol
    if plain_entry:
        n = fa.flash_attention.launches
        o2 = fa.flash_attention(q, k, v, causal=causal, scale=sm, kv_offset=off)
        torch.cuda.synchronize()
        assert fa.flash_attention.launches == n + 1
        assert o2.dtype == dtype and _row_err(o2, o_ref, floor=0.0) <= row_tol
    tol = 1e-2 if dtype == torch.float32 else None
    assert ((l - l_ref).abs() / l_ref).max().item() <= (tol or 1e-4)
    assert (m - m_ref).abs().max().item() <= (tol or 1e-3)
    hm = [t.transpose(1, 2) for t in (q, k, v, o, do)]
    got = fb.flash_attention_bwd(*hm[:4], l, m, hm[4], causal=causal, sm_scale=sm, kv_offset=off)
    torch.cuda.synchronize()
    assert (fa.flash_attention_forward.launches, fb.flash_attention_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    want = fb.flash_attention_bwd_plain(*hm[:4], l, m, hm[4], causal=causal, sm_scale=sm,
                                        kv_offset=off)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == b.shape and a.dtype == b.dtype == dtype
        err = _row_err(a.transpose(1, 2), b.transpose(1, 2))
        assert err <= row_tol, f"{name}: worst row's relative err {err}"


# The forward runs on TMA + wgmma at every D: f32 on the tf32 family
# (csrc/flash_tf32_fwd.cu), bf16 and fp16 on csrc/flash_fwd.cu. So does the
# 16-bit backward (csrc/flash_bwd.cu) at every D; the tf32 backward takes f32
# at D 64 and 128, the "sync" family (csrc/flash_sync_bwd.cu) f32's past 128.
def _family(dtype, D):
    if dtype != torch.float32:
        return ("wgmma", "wgmma")
    return ("tf32", "tf32" if D <= 128 else "sync")


@pytest.mark.parametrize("dtype,D,B,Tq,Tkv,NH,NKV,off,causal", _SYNC_CASES)
def test_flash_sync_kernels(cuda, dtype, D, B, Tq, Tkv, NH, NKV, off, causal):
    # Both ways, the forward with and without statistics: f32 at every D
    # (the tf32 forward, its backward on the tf32 or 8-warp "sync" family;
    # _family).
    from mila_tpu_torch.kernels import flash_attention as fa

    assert fa.routes(dtype, D) == _family(dtype, D)
    _sync_forward_then_backward(dtype, D, B, Tq, Tkv, NH, NKV, off, causal, plain_entry=True)


_WIDE_BWD_CASES = [  # (dtype, D, B, Tq, Tkv, NH, NKV, kv_offset, causal)
    # The 16-bit backward past D 256 (csrc/flash_bwd.cu, plan_bwd): dK/dV
    # parts of 256 columns with a partial last one (D 320: 256 + 64; D 384
    # and 448: + 128, + 192), one dQ part to D 512, the block's own operands
    # resident to D 512; ragged q tiles under kv_offset windows, G 1, 2 and
    # 4, not causal.
    (torch.bfloat16, 320, 2, 208, 384, 4, 2, 176, True),
    (torch.float16, 320, 1, 128, 512, 4, 1, 384, True),
    (torch.bfloat16, 512, 1, 512, 512, 8, 2, 0, True),
    (torch.float16, 512, 2, 256, 256, 4, 2, 0, False),
    (torch.bfloat16, 384, 1, 256, 256, 4, 4, 0, True),
    (torch.float16, 384, 2, 208, 384, 8, 2, 176, True),
    (torch.bfloat16, 448, 2, 80, 256, 4, 1, 176, True),
    # two dQ parts (320 + 256), operands streamed
    (torch.bfloat16, 576, 1, 128, 256, 4, 1, 128, True),
    (torch.float16, 576, 2, 192, 256, 2, 2, 0, False),
    # streamed, dQ parts of 512 (+ 64 at D 1088), dK/dV's last part 64 wide
    (torch.bfloat16, 1024, 1, 208, 384, 4, 1, 176, True),
    (torch.float16, 1024, 1, 128, 256, 4, 4, 0, False),
    (torch.bfloat16, 1088, 1, 96, 256, 4, 2, 160, True),
    (torch.float16, 1088, 1, 144, 256, 8, 2, 112, True),
    # chip_smoke.py's rows
    (torch.bfloat16, 320, 1, 2048, 2048, 16, 8, 0, True),
    (torch.float16, 512, 1, 2048, 2048, 16, 8, 0, True),
]


@pytest.mark.parametrize("dtype,D,B,Tq,Tkv,NH,NKV,off,causal", _WIDE_BWD_CASES)
def test_flash_wgmma_bwd_past_256(cuda, dtype, D, B, Tq, Tkv, NH, NKV, off, causal):
    # bf16 and fp16 past D 256 both ways, the forward with and without
    # statistics, the backward on TMA + wgmma (flash_bwd.cu's part kernels).
    from mila_tpu_torch.kernels import flash_attention as fa

    assert fa.routes(dtype, D) == ("wgmma", "wgmma")
    _sync_forward_then_backward(dtype, D, B, Tq, Tkv, NH, NKV, off, causal, plain_entry=True)


_WIDE_FWD_CASES = [  # (D, B, Tq, Tkv, NH, NKV, kv_offset, causal), each type
    (384, 2, 208, 384, 4, 4, 176, True),   # ragged q tiles, a window Tq < Tkv, NH = NKV
    (384, 1, 256, 256, 8, 2, 0, False),    # not causal, G 4
    (576, 1, 80, 256, 8, 2, 176, True),    # two parts (320 + 256), G 4
    (576, 2, 192, 256, 2, 2, 0, False),
    (1024, 1, 208, 384, 4, 1, 176, True),  # two parts of 512; f32 streams Q
    (1024, 1, 128, 256, 4, 4, 0, False),
    (704, 1, 144, 256, 4, 1, 112, True),   # parts 512 + 192; f32 streams Q
    (1088, 1, 96, 256, 4, 2, 160, True),   # 16-bit streams Q; a last part of 64
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("D,B,Tq,Tkv,NH,NKV,off,causal", _WIDE_FWD_CASES)
def test_flash_wide_forward(cuda, dtype, D, B, Tq, Tkv, NH, NKV, off, causal):
    # The forward past D 256 (kernels/flash_attention.py:plan_wide), with
    # and without statistics, against the plain version: each (b, t, head)
    # row within 5e-3 (f32: tf32 products) or 2e-2 of its own max, l and m
    # at chip_smoke.py:flash_rows' limits (1e-4 relative and 1e-3 absolute,
    # 1e-2 both in f32), one counted launch each.
    from mila_tpu_torch.kernels import flash_attention as fa

    assert fa.routes(dtype, D)[0] == _family(dtype, D)[0]
    q = _rand((B, Tq, NH, D), 190, dtype=dtype)
    k, v = _rand((B, Tkv, NKV, D), 191, dtype=dtype), _rand((B, Tkv, NKV, D), 192, dtype=dtype)
    sm = D ** -0.5
    before = (fa.flash_attention_forward.launches, fa.flash_attention.launches)
    o, l, m = fa.flash_attention_forward(q, k, v, causal=causal, sm_scale=sm, kv_offset=off)
    o2 = fa.flash_attention(q, k, v, causal=causal, scale=sm, kv_offset=off)
    torch.cuda.synchronize()
    assert (fa.flash_attention_forward.launches, fa.flash_attention.launches) == (
        before[0] + 1, before[1] + 1)
    o_ref, l_ref, m_ref = fa.flash_attention_plain(q, k, v, causal=causal, scale=sm,
                                                   kv_offset=off, save_stats=True)
    f32 = dtype == torch.float32
    row_tol = 5e-3 if f32 else 2e-2
    for got in (o, o2):
        assert got.dtype == dtype and _row_err(got, o_ref, floor=0.0) <= row_tol
    assert ((l - l_ref).abs() / l_ref).max().item() <= (1e-2 if f32 else 1e-4)
    assert (m - m_ref).abs().max().item() <= (1e-2 if f32 else 1e-3)


@pytest.mark.parametrize("D,B,Tq,Tkv,NH,NKV,off", [
    (64, 2, 192, 320, 8, 2, 128),  # Tkv not a multiple of the forward's 128
    (64, 4, 1088, 1088, 12, 12, 0),  # the last 128-key dK/dV block half full
    (128, 2, 80, 320, 4, 2, 240),  # one ragged q tile, Tkv 320
])
def test_flash_tf32_bwd_on_plain_stats(cuda, D, B, Tq, Tkv, NH, NKV, off):
    # The tf32 backward at key counts the forward does not take, on the
    # plain forward's o, l and m, against its plain version (f32 gate).
    from mila_tpu_torch.kernels import flash_attention as fa
    from mila_tpu_torch.kernels import flash_attention_bwd as fb

    assert fa.routes(torch.float32, D)[1] == "tf32"
    q = _rand((B, Tq, NH, D), 174, dtype=torch.float32)
    k, v = (_rand((B, Tkv, NKV, D), s, dtype=torch.float32) for s in (175, 176))
    do = _rand((B, Tq, NH, D), 177, dtype=torch.float32)
    sm = D ** -0.5
    o, l, m = fa.flash_attention_plain(q, k, v, causal=True, scale=sm, kv_offset=off,
                                       save_stats=True)
    hm = [t.transpose(1, 2) for t in (q, k, v, o, do)]
    before = fb.flash_attention_bwd.launches
    got = fb.flash_attention_bwd(*hm[:4], l, m, hm[4], causal=True, sm_scale=sm, kv_offset=off)
    torch.cuda.synchronize()
    assert fb.flash_attention_bwd.launches == before + 1
    want = fb.flash_attention_bwd_plain(*hm[:4], l, m, hm[4], causal=True, sm_scale=sm,
                                        kv_offset=off)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        err = _row_err(a.transpose(1, 2), b.transpose(1, 2))
        assert err <= 5e-3, f"{name}: worst row's relative err {err}"


@pytest.mark.parametrize("dtype,D,B,Tq,Tkv,NH,NKV,off,causal", _SYNC_FWD_CASES)
def test_flash_wgmma_bwd_on_sync_stats(cuda, dtype, D, B, Tq, Tkv, NH, NKV, off, causal):
    # The wgmma backward at D 192 and 256 reads the forward's l and m, which
    # K10 (flash_fwd.cu) now writes at those head sizes as the mma.sync
    # family did (m of the scaled scores, l the f32 sum against the running
    # max): forward and backward each against their plain versions.
    from mila_tpu_torch.kernels import flash_attention as fa

    assert fa.routes(dtype, D) == ("wgmma", "wgmma")
    _sync_forward_then_backward(dtype, D, B, Tq, Tkv, NH, NKV, off, causal)


@pytest.mark.parametrize("dtype,D", [(torch.float32, 64), (torch.float32, 320),
                                     (torch.bfloat16, 320), (torch.float16, 512),
                                     (torch.float32, 512), (torch.float32, 1024),
                                     (torch.float32, 128), (torch.float32, 256),
                                     (torch.bfloat16, 512), (torch.float16, 320),
                                     (torch.bfloat16, 1088), (torch.float32, 704),
                                     (torch.bfloat16, 576), (torch.float16, 1088)])
def test_flash_sync_graph_replay_and_determinism(cuda, dtype, D):
    # f32's tf32 family (its operand copies in scratch from the graph's
    # pool) at every D, bf16 and fp16 at D 320 on K10's wide kernel and at
    # D 512 and 576 on the part kernel (512- and 320-column parts; Q
    # streamed at 16-bit D 1088 and f32 D 704 and 1024), each before its
    # backward (16-bit: flash_bwd.cu's part kernels, the operands streamed
    # at D 576 and 1088):
    # two forward + backward calls on the same inputs are bit-equal (no
    # atomics), and a captured forward + backward replayed after q, k, v and
    # do change in place equals eager calls.
    from mila_tpu_torch.kernels import flash_attention as fa
    from mila_tpu_torch.kernels import flash_attention_bwd as fb

    assert fa.routes(dtype, D) == _family(dtype, D)
    sq, skv = (2, 384, 8, D), (2, 512, 2, D)
    q, k, v, do = (_rand(sh, s, dtype=dtype) for sh, s in ((sq, 180), (skv, 181), (skv, 182),
                                                          (sq, 183)))
    sm = D ** -0.5

    def call():
        o, l, m = fa.flash_attention_forward(q, k, v, causal=True, sm_scale=sm, kv_offset=128)
        hm = [t.transpose(1, 2) for t in (q, k, v, o, do)]
        return (o, l, m) + fb.flash_attention_bwd(*hm[:4], l, m, hm[4], causal=True,
                                                  sm_scale=sm, kv_offset=128)

    first, again = call(), call()
    for a, b in zip(first, again):
        assert torch.equal(a, b)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        graphed = call()
    for t, seed in zip((q, k, v, do), (184, 185, 186, 187)):
        t.copy_(_rand(tuple(t.shape), seed, dtype=dtype))
    g.replay()
    torch.cuda.synchronize()
    for a, b in zip(graphed, call()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype,D", [(torch.bfloat16, 128), (torch.float16, 64),
                                     (torch.float16, 128), (torch.bfloat16, 192),
                                     (torch.bfloat16, 256), (torch.float16, 192),
                                     (torch.float16, 256)])
def test_flash_bwd_kernel_graph_replay_and_determinism(cuda, dtype, D):
    # Two calls on the same inputs are bit-equal (no atomics: every sum is
    # taken in a fixed order inside one block). One call captured in a CUDA
    # graph (the TMA descriptors are kernel parameters, the statistics
    # scratch comes from the graph's pool); q, k, v, o, do, l, m rewritten
    # in place, then the replay equals an eager call on the new values bit
    # for bit. Every wgmma instantiation: bf16 and fp16 at D 64-256.
    from mila_tpu_torch.kernels import flash_attention as fa
    from mila_tpu_torch.kernels import flash_attention_bwd as fb

    B, T, Tkv, NH, NKV, off = 2, 192, 320, 8, 2, 128
    sm = D ** -0.5
    assert fa.routes(dtype, D)[1] == "wgmma"

    def inputs(seed):  # o, l, m from the plain forward: the kernel's takes Tkv % 128 only
        q, do = _rand((B, T, NH, D), seed, dtype=dtype), _rand((B, T, NH, D), seed + 1, dtype=dtype)
        k = _rand((B, Tkv, NKV, D), seed + 2, dtype=dtype)
        v = _rand((B, Tkv, NKV, D), seed + 3, dtype=dtype)
        o, l, m = fa.flash_attention_plain(q, k, v, causal=True, scale=sm, kv_offset=off,
                                           save_stats=True)
        return q, k, v, o, l, m, do

    def bwd(q, k, v, o, l, m, do):
        hm = [t.transpose(1, 2) for t in (q, k, v, o, do)]
        return fb.flash_attention_bwd(*hm[:4], l, m, hm[4], causal=True, sm_scale=sm,
                                      kv_offset=off)

    first = inputs(112)
    for a, b in zip(bwd(*first), bwd(*first)):
        assert torch.equal(a, b)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        graphed = bwd(*first)
    for dst, src in zip(first, inputs(120)):
        dst.copy_(src)
    g.replay()
    torch.cuda.synchronize()
    eager = bwd(*first)
    want = fb.flash_attention_bwd_plain(*[t.transpose(1, 2) for t in first[:4]], first[4],
                                        first[5], first[6].transpose(1, 2), causal=True,
                                        sm_scale=sm, kv_offset=off)
    for a, b, c in zip(graphed, eager, want):
        assert torch.equal(a, b)
        assert _row_err(b.transpose(1, 2), c.transpose(1, 2)) <= 2e-2


def test_flash_bwd_kernel_copies_an_unaligned_view(cuda):
    # do as a view whose base sits 2 bytes past a 16-byte boundary: TMA
    # cannot read it, so the wrapper copies it and computes.
    from mila_tpu_torch.kernels import flash_attention as fa
    from mila_tpu_torch.kernels import flash_attention_bwd as fb

    B, T, NH, NKV, D = 1, 256, 4, 2, 64
    q, k, v = _rand((B, T, NH, D), 121), _rand((B, T, NKV, D), 122), _rand((B, T, NKV, D), 123)
    flat = _rand((B * T * NH * D + 1,), 124)
    do = flat[1:].view(B, T, NH, D)
    assert do.is_contiguous() and do.data_ptr() % 16 != 0
    o, l, m = fa.flash_attention_forward(q, k, v, causal=True, sm_scale=D ** -0.5)
    hm = [t.transpose(1, 2) for t in (q, k, v, o, do)]
    before = fb.flash_attention_bwd.launches
    got = fb.flash_attention_bwd(*hm[:4], l, m, hm[4], causal=True, sm_scale=D ** -0.5)
    torch.cuda.synchronize()
    assert fb.flash_attention_bwd.launches == before + 1
    want = fb.flash_attention_bwd_plain(*hm[:4], l, m, hm[4], causal=True, sm_scale=D ** -0.5)
    for a, b in zip(got, want):
        assert _row_err(a.transpose(1, 2), b.transpose(1, 2)) <= 2e-2


@pytest.mark.parametrize("B,T,NH,NKV,D", [(2, 256, 4, 4, 64), (1, 256, 4, 2, 512)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_autograd_matches_plain_autograd(cuda, dtype, B, T, NH, NKV, D):
    # torch.autograd.grad through the kernels against the same autograd
    # Function on CPU copies (its plain forward and backward: JAX's custom
    # VJP, D = rowsum(o dO) on the saved o in q's dtype), GPT-2's head size
    # and D 512 with GQA (the backward's part kernels); at GPT-2's head size
    # also against autograd through the plain forward (PyTorch
    # differentiating its einsums, D from the unrounded output). Past D 256
    # in bf16 those two references differ themselves, on the CPU, beyond the
    # gate: query 1's dq row, whose dS = p (dP - D) cancels, by about 8.7e-2.
    from mila_tpu_torch.kernels import flash_attention as fa

    q = _rand((B, T, NH, D), 64, dtype=dtype).requires_grad_()
    k, v = (_rand((B, T, NKV, D), s, dtype=dtype).requires_grad_() for s in (65, 66))
    w = _rand((B, T, NH, D), 67, dtype=dtype)
    got = torch.autograd.grad((fa.flash_attention(q, k, v).float() * w.float()).sum(), (q, k, v))
    leaves = [t.detach().cpu().requires_grad_() for t in (q, k, v)]
    vjp = torch.autograd.grad((fa.flash_attention(*leaves).float() * w.cpu().float()).sum(),
                              leaves)
    for a, b in zip(got, vjp):
        assert _row_err(a.cpu(), b) <= 2e-2
    if D == 64:
        want = torch.autograd.grad(
            (fa.flash_attention_plain(q, k, v).float() * w.float()).sum(), (q, k, v))
        for a, b in zip(got, want):
            assert _row_err(a, b) <= 2e-2


@pytest.mark.parametrize("n,dtype,master,scale", [
    (1 << 20, torch.bfloat16, True, 1.0),
    (1000003, torch.bfloat16, True, 0.37),  # a ragged tail, a clipped gradient
    (4099, torch.float32, True, 1.0),  # an f32 leaf with a master: p' = master'
    (65537, torch.float32, False, 1.0),
    (65536, torch.bfloat16, False, 1.0),  # round to nearest without a master
    (1000003, torch.float16, True, 0.37),  # fp16 from its master, to nearest
    (65536, torch.float16, False, 1.0),
])
def test_fused_adamw_kernel(cuda, n, dtype, master, scale):
    # Same operations in the same order, no FMA contraction: every output
    # equal bit for bit to the plain version on the card, the rounded bf16
    # param included, given the same noise.
    from mila_tpu_torch.kernels import fused_adamw as fw

    w = _rand((n,), 70, dtype=torch.float32)
    p = w.to(dtype)
    g = _rand((n,), 71, scale=0.1, dtype=dtype)
    m = _rand((n,), 72, scale=0.01, dtype=torch.float32)
    v = _rand((n,), 73, scale=0.01, dtype=torch.float32).square()
    noise = torch.randint(-2 ** 31, 2 ** 31 - 1, (n,), device="cuda", dtype=torch.int32)
    kw = dict(step=7, lr=3e-4, weight_decay=0.1, noise=noise, grad_scale=scale)
    before = fw.fused_adamw_update.launches
    got = fw.fused_adamw_update(p, g, m, v, w if master else None, **kw)
    torch.cuda.synchronize()
    assert fw.fused_adamw_update.launches == before + 1
    want = fw.fused_adamw_update_plain(p, g, m, v, w if master else None, **kw)
    for a, b in zip(got, want):
        if b is None:
            assert a is None
            continue
        assert a.dtype == b.dtype
        assert torch.equal(a.view(-1), b.view(-1)), (a - b).abs().max()


def test_linear_weight_grad_sums_in_f32(cuda):
    # dw = x^T g reduces over B*T = 8192 rows (GPT-2's train shape). Each
    # element lies within one bf16 step of the f32 product's (plus 1e-5 of
    # the largest, for f32 order): a split-K product that summed its
    # partials in bf16 would miss by ~2^-9 |x| |g| sqrt(K).
    from mila_tpu_torch.ops.linear import linear

    x = _rand((8192, 768), 90).requires_grad_()
    w = _rand((768, 2304), 91, scale=0.02).requires_grad_()
    g = _rand((8192, 2304), 92)
    flags = torch.backends.cuda.matmul
    before = flags.allow_bf16_reduced_precision_reduction
    (dw,) = torch.autograd.grad(linear(x, w), w, g)
    assert flags.allow_bf16_reduced_precision_reduction == before
    want = x.detach().float().t() @ g.float()
    err = (dw.float() - want).abs()
    assert (err <= 2 ** -7 * want.abs() + 1e-5 * want.abs().max()).all(), err.max()


def test_fused_adamw_refuses_fp16(cuda):
    # fp16 params run on the card (test_fused_adamw_kernel); what the
    # kernel still refuses: f64 params, and a 16-bit gradient of another
    # type than the param's.
    from mila_tpu_torch.kernels import fused_adamw as fw

    z = torch.zeros(64, device="cuda")
    p64 = torch.zeros(64, device="cuda", dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="fp16"):
        fw.fused_adamw_update(p64, p64, z, z, z, step=1, lr=1e-3)
    p16 = torch.zeros(64, device="cuda", dtype=torch.float16)
    with pytest.raises(ValueError):
        fw.fused_adamw_update(p16, p16.bfloat16(), z, z, z, step=1, lr=1e-3)
    p2, *_ = fw.fused_adamw_update(p16, p16, z, z, z, step=1, lr=1e-3)
    assert p2.dtype == torch.float16


def _adamw_leaves(sizes, pdtype, gdtype, master, seed):
    ps, gs, ms, vs, ws = [], [], [], [], []
    for i, n in enumerate(sizes):
        w = _rand((n,), seed + 5 * i, dtype=torch.float32)
        ps.append(w.to(pdtype))
        gs.append(_rand((n,), seed + 5 * i + 1, scale=0.1, dtype=gdtype))
        ms.append(_rand((n,), seed + 5 * i + 2, scale=0.01, dtype=torch.float32))
        vs.append(_rand((n,), seed + 5 * i + 3, scale=0.01, dtype=torch.float32).square())
        ws.append(w if master else None)
    return ps, gs, ms, vs, ws


def _assert_lists_equal(got, want):
    for k, (a_list, b_list) in enumerate(zip(got, want)):
        for i, (a, b) in enumerate(zip(a_list, b_list)):
            if b is None:
                assert a is None
                continue
            assert a.dtype == b.dtype and a.shape == b.shape, (k, i)
            assert torch.equal(a, b), (k, i, (a.float() - b.float()).abs().max())


_ADAMW_GROUPS = {
    # (param dtype, grad dtype, master)
    "bf16_master_sr": [(torch.bfloat16, torch.bfloat16, True)],
    "fp16_master": [(torch.float16, torch.float16, True)],
    "f32_no_master": [(torch.float32, torch.float32, False)],
    "mixed": [(torch.bfloat16, torch.bfloat16, True), (torch.float32, torch.float32, True),
              (torch.float16, torch.float16, True), (torch.bfloat16, torch.float32, True)],
}


@pytest.mark.parametrize("groups", sorted(_ADAMW_GROUPS))
@pytest.mark.parametrize("key", ["host", "device"])
def test_fused_adamw_step_kernel(cuda, groups, key):
    # Leaves of 1, 3, 5, 2048 and 1000003 elements (not a multiple of 4:
    # the scalar tail) and one over several chunks, in each dtype group:
    # every output bit-equal to the plain twin given the same clip factor
    # and step key, one launch per group, two calls bit-equal, and a CUDA
    # graph replay equal to an eager call.
    from mila_tpu_torch.kernels import fused_adamw as fw

    sizes = [1, 3, 5, 2048, 1000003, 70001]
    ps, gs, ms, vs, ws, ids = [], [], [], [], [], []
    for k, (pd, gd, master) in enumerate(_ADAMW_GROUPS[groups]):
        leaves = _adamw_leaves(sizes, pd, gd, master, 100 + 40 * k)
        for lst, new in zip((ps, gs, ms, vs, ws), leaves):
            lst += new
    ids = list(range(len(ps)))[::-1]
    scale, _ = fw.grad_clip_scale(gs, 1.0)
    words = torch.tensor([0x12345678, -0x2468ACE], dtype=torch.int32)
    k = words.cuda() if key == "device" else words
    kw = dict(step=7, lr=3e-4, weight_decay=0.1, grad_scale=scale, key=k, leaf_ids=ids)
    before = fw.fused_adamw_step.launches
    got = fw.fused_adamw_step(ps, gs, ms, vs, ws, **kw)
    again = fw.fused_adamw_step(ps, gs, ms, vs, ws, **kw)
    torch.cuda.synchronize()
    assert fw.fused_adamw_step.launches == before + 2 * len(_ADAMW_GROUPS[groups])
    want = fw.fused_adamw_step_plain(ps, gs, ms, vs, ws, **kw)
    _assert_lists_equal(got, want)
    _assert_lists_equal(again, got)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fw.fused_adamw_step(ps, gs, ms, vs, ws, **kw)
    graph.replay()
    torch.cuda.synchronize()
    _assert_lists_equal(out, got)


def test_fused_adamw_step_on_llama_wte(cuda):
    # Llama-3.2-1B's tied wte (262.7M elements, bf16 + f32 master + SR) and
    # an f32 norm leaf in one step: bit-equal to the plain twin.
    from mila_tpu_torch.kernels import fused_adamw as fw

    n = 128256 * 2048
    gen = torch.Generator(device="cuda").manual_seed(7)
    w = torch.randn(n, generator=gen, device="cuda") * 0.02
    g = (torch.randn(n, generator=gen, device="cuda") * 1e-3).bfloat16()
    m = torch.randn(n, generator=gen, device="cuda") * 1e-4
    v = (torch.randn(n, generator=gen, device="cuda") * 1e-4).square()
    ln = _adamw_leaves([2048], torch.float32, torch.float32, True, 300)
    ps, gs, ms, vs, ws = ([w.bfloat16()] + ln[0], [g] + ln[1], [m] + ln[2], [v] + ln[3],
                          [w] + ln[4])
    kw = dict(step=3, lr=1e-3, weight_decay=0.1, grad_scale=torch.tensor(0.5, device="cuda"),
              key=None, leaf_ids=[145, 3])
    got = fw.fused_adamw_step(ps, gs, ms, vs, ws, **kw)
    want = fw.fused_adamw_step_plain(ps, gs, ms, vs, ws, **kw)
    _assert_lists_equal(got, want)


def test_fused_adamw_keeps_derived_inputs_alive(cuda):
    # Inputs the wrapper derives (a bf16 master cast to f32 on every leaf,
    # equal sizes so the allocator would hand one leaf's freed cast to the
    # next; a transposed noise copied contiguous, the size of m') live until
    # the launch: every output equals the plain twin's bit for bit.
    from mila_tpu_torch.kernels import fused_adamw as fw

    ps, gs, ms, vs, ws = _adamw_leaves([65536] * 4 + [1000003, 5], torch.bfloat16,
                                       torch.bfloat16, True, 500)
    ws = [w.bfloat16() for w in ws]
    kw = dict(step=5, lr=1e-3, weight_decay=0.1, key=(7, 11))
    for _ in range(2):
        got = fw.fused_adamw_step(ps, gs, ms, vs, ws, **kw)
        _assert_lists_equal(got, fw.fused_adamw_step_plain(ps, gs, ms, vs, ws, **kw))
    p, g, m, v, w = (x[0].reshape(300, 500) for x in _adamw_leaves(
        [300 * 500], torch.bfloat16, torch.bfloat16, True, 520))
    noise = torch.randint(-2 ** 31, 2 ** 31 - 1, (500, 300), device="cuda",
                          dtype=torch.int32).t()
    kw = dict(step=3, lr=1e-3, noise=noise)
    got = fw.fused_adamw_update(p, g, m, v, w, **kw)
    want = fw.fused_adamw_update_plain(p, g, m, v, w, **kw)
    _assert_lists_equal([[t] for t in got], [[t] for t in want])


def test_fused_adamw_counts_only_launches(cuda):
    # Each wrapper counts the launches it makes: none for a group of empty
    # leaves, a norm over empty leaves only, or an empty per-leaf update.
    from mila_tpu_torch.kernels import fused_adamw as fw

    ps, gs, ms, vs, ws = _adamw_leaves([0, 0, 5, 0], torch.bfloat16, torch.bfloat16, True, 540)
    ps[2], gs[2] = ps[2].float(), gs[2].float()
    counts = lambda: (fw.fused_adamw_step.launches, fw.grad_clip_scale.launches,  # noqa: E731
                      fw.fused_adamw_update.launches)
    before = counts()
    fw.fused_adamw_step(ps, gs, ms, vs, ws, step=1, lr=1e-3)  # f32: one launch; bf16: none
    fw.fused_adamw_step(ps[:2], gs[:2], ms[:2], vs[:2], ws[:2], step=1, lr=1e-3)
    factor, norm = fw.grad_clip_scale([gs[0], gs[1]], 1.0)
    fw.grad_clip_scale(gs, 1.0)
    fw.fused_adamw_update(ps[0], gs[0], ms[0], vs[0], ws[0], step=1, lr=1e-3, seed=3)
    fw.fused_adamw_update(ps[2], gs[2], ms[2], vs[2], ws[2], step=1, lr=1e-3)
    torch.cuda.synchronize()
    assert factor.item() == 1.0 and norm.item() == 0.0
    assert tuple(a - b for a, b in zip(counts(), before)) == (1, 1, 1)


def test_grad_clip_scale_kernel(cuda):
    # One launch over f32, bf16 and fp16 leaves (1 to 5M elements): the
    # norm within 1e-6 relative of the plain one, the factor too, two calls
    # bit-equal, a graph replay equal; a small norm gives the factor 1.
    from mila_tpu_torch.kernels import fused_adamw as fw

    gs = [_rand((n,), 400 + i, dtype=dt) for i, (n, dt) in enumerate(
        [(1, torch.float32), (3, torch.bfloat16), (2048, torch.float16), (5_000_003,
                                                                          torch.bfloat16),
         (70001, torch.float32)])]
    before = fw.grad_clip_scale.launches
    f1, n1 = fw.grad_clip_scale(gs, 1.0)
    f2, n2 = fw.grad_clip_scale(gs, 1.0)
    torch.cuda.synchronize()
    assert fw.grad_clip_scale.launches == before + 2
    wf, wn = fw.grad_clip_scale_plain(gs, 1.0)
    assert abs(n1.item() - wn.item()) <= 1e-6 * wn.item()
    assert abs(f1.item() - wf.item()) <= 1e-6 * wf.item() and f1.item() < 1
    assert torch.equal(n1, n2) and torch.equal(f1, f2)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        f3, n3 = fw.grad_clip_scale(gs, 1.0)
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(n3, n1) and torch.equal(f3, f1)
    f4, _ = fw.grad_clip_scale(gs, 1e9)
    assert f4.item() == 1.0


@pytest.mark.parametrize("V", [2, 3, 10, 16, 17, 33, 100, 256, 257, 1000, 1024])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_softmax_ce_short_rows(cuda, V, dtype):
    # The short-row forward (a warp a row, several rows a warp up to V 16)
    # against the plain version at V 2-1024, every 5th row ignored; the
    # wrapper takes it up to CE_SHORT_MAX_V, one launch a call, and a graph
    # replay equals an eager call.
    from mila_tpu_torch.kernels import softmax_ce as ce

    chosen = ce.ce_fwd_variant(V, torch.tensor([], dtype=dtype).element_size())
    assert chosen == ("short" if V <= ce.CE_SHORT_MAX_V else "row")
    M = 301
    x = _rand((M, V), 89, scale=3.0, dtype=dtype)
    t = torch.from_numpy(np.random.default_rng(90).integers(0, V, M)).cuda()
    t[::5] = -100
    t32 = t.to(torch.int32)
    want = ce.fused_softmax_cross_entropy_plain(x, t32)
    short = ce._fwd(x.contiguous(), t32, -100, "short")
    torch.testing.assert_close(short, want, rtol=1e-5, atol=1e-4)
    assert (short[::5] == 0).all()
    before = ce.fused_softmax_cross_entropy.launches
    loss = ce.fused_softmax_cross_entropy(x, t)
    torch.cuda.synchronize()
    assert ce.fused_softmax_cross_entropy.launches == before + 1
    torch.testing.assert_close(loss, want, rtol=1e-5, atol=1e-4)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ce.fused_softmax_cross_entropy(x, t)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, loss)


def _dlogits_gate(got, want):
    # Each dlogit within one bf16 step (2^-7) of its own size, floored at
    # 1e-8 of the largest, so a wrong small probability fails as a wrong
    # large one; fp16 dlogits also get one step of fp16's subnormal range
    # (2^-24), where two f32 values a few ulps apart round a step apart.
    sub = 2 ** -24 if got.dtype == torch.float16 else 0.0
    got, want = got.float(), want.float()
    floor = 1e-8 * want.abs().max() + sub
    err = (got - want).abs()
    assert (err <= 2 ** -7 * want.abs() + floor).all(), err.max()


@pytest.mark.parametrize("M,V,dtype", [
    (64, 50304, torch.bfloat16),
    (37, 1000, torch.bfloat16),  # V % 8 != 0: the scalar path
    (16, 4096, torch.float32),
    (8, 1027, torch.float32),
    (64, 50304, torch.float16),
    (37, 1000, torch.float16),
])
def test_softmax_ce_kernel(cuda, M, V, dtype):
    from mila_tpu_torch.kernels import softmax_ce as ce

    x = _rand((M, V), 80, scale=3.0, dtype=dtype)
    t = torch.from_numpy(np.random.default_rng(81).integers(0, V, M)).cuda()
    t[::5] = -100
    g = _rand((M,), 82, dtype=torch.float32)
    before = (ce.fused_softmax_cross_entropy.launches, ce.fused_softmax_cross_entropy_bwd.launches)
    xr = x.clone().requires_grad_()
    loss = ce.fused_softmax_cross_entropy(xr, t)
    (dx,) = torch.autograd.grad(loss, xr, g)
    torch.cuda.synchronize()
    assert (ce.fused_softmax_cross_entropy.launches,
            ce.fused_softmax_cross_entropy_bwd.launches) == (before[0] + 1, before[1] + 1)
    t32 = t.to(torch.int32)
    torch.testing.assert_close(loss, ce.fused_softmax_cross_entropy_plain(x, t32),
                               rtol=1e-5, atol=1e-4)
    assert (loss[::5] == 0).all() and (dx[::5] == 0).all()
    assert dx.dtype == dtype
    _dlogits_gate(dx, ce.fused_softmax_cross_entropy_bwd_plain(x, t32, g))


@pytest.mark.parametrize("M,V,dtype,variant", [
    (32, 50304, torch.bfloat16, "resident"),  # GPT-2's rows held in shared memory
    (8, 50304, torch.float32, "streamed"),    # 201 KB rows: past the budget
    (6, 57352, torch.bfloat16, "streamed"),   # one chunk past it
    (16, 1001, torch.bfloat16, "scalar"),     # 2002-byte rows: not whole 16-byte chunks
    (9, 1027, torch.float32, "scalar"),
    (32, 50304, torch.float16, "resident"),
    (16, 1001, torch.float16, "scalar"),
])
def test_softmax_ce_bwd_variants(cuda, M, V, dtype, variant):
    # Each backward variant against the plain version (each dlogit within
    # one bf16 step of its own size), ignored rows all zero, two calls
    # bit-equal, and a graph replay after the logits change in place.
    from mila_tpu_torch.kernels import softmax_ce as ce

    assert ce.ce_bwd_variant(V, torch.tensor([], dtype=dtype).element_size()) == variant
    x = _rand((M, V), 83, scale=3.0, dtype=dtype)
    t = torch.from_numpy(np.random.default_rng(84).integers(0, V, M).astype(np.int32)).cuda()
    t[::4] = -100
    g = _rand((M,), 85, dtype=torch.float32)
    before = ce.fused_softmax_cross_entropy_bwd.launches
    first = ce.fused_softmax_cross_entropy_bwd(x, t, g)
    second = ce.fused_softmax_cross_entropy_bwd(x, t, g)
    torch.cuda.synchronize()
    assert ce.fused_softmax_cross_entropy_bwd.launches == before + 2
    assert torch.equal(first, second)
    assert (first[::4] == 0).all()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ce.fused_softmax_cross_entropy_bwd(x, t, g)
    x.copy_(_rand((M, V), 86, scale=3.0, dtype=dtype))
    graph.replay()
    torch.cuda.synchronize()
    for got in (out, ce.fused_softmax_cross_entropy_bwd(x, t, g)):
        _dlogits_gate(got, ce.fused_softmax_cross_entropy_bwd_plain(x, t, g))


# --------------------------------------------------------------------------
# The MNIST MLP's path: K13 at V 10, K12 on its f32 leaves, Model on the
# card against the CPU port, a checkpoint resume, the prefetcher.
# --------------------------------------------------------------------------

@pytest.mark.parametrize("M", [2048, 128])
def test_softmax_ce_mnist_rows(cuda, M):
    # V 10 in f32: 40-byte rows, no whole 16-byte chunks, so the forward's
    # and the backward's scalar branches; the same gates as the other rows.
    from mila_tpu_torch.kernels import softmax_ce as ce

    V = 10
    assert ce.ce_bwd_variant(V, 4) == "scalar"
    x = _rand((M, V), 87, scale=3.0, dtype=torch.float32)
    t = torch.from_numpy(np.random.default_rng(88).integers(0, V, M)).cuda()
    g = torch.full((M,), 1.0 / M, device="cuda")
    before = (ce.fused_softmax_cross_entropy.launches, ce.fused_softmax_cross_entropy_bwd.launches)
    xr = x.clone().requires_grad_()
    loss = ce.fused_softmax_cross_entropy(xr, t)
    (dx,) = torch.autograd.grad(loss, xr, g)
    torch.cuda.synchronize()
    assert (ce.fused_softmax_cross_entropy.launches,
            ce.fused_softmax_cross_entropy_bwd.launches) == (before[0] + 1, before[1] + 1)
    t32 = t.to(torch.int32)
    torch.testing.assert_close(loss, ce.fused_softmax_cross_entropy_plain(x, t32), rtol=1e-5,
                               atol=1e-4)
    _dlogits_gate(dx, ce.fused_softmax_cross_entropy_bwd_plain(x, t32, g))


@pytest.mark.parametrize("n", [10, 64, 128, 640, 8192, 100352])
def test_fused_adamw_mnist_leaves(cuda, n):
    # The MLP's f32 leaves without masters (biases of 10 and 64 end in the
    # scalar tail): every output bit-equal to the plain version.
    from mila_tpu_torch.kernels import fused_adamw as fw

    p = _rand((n,), 74, scale=0.05, dtype=torch.float32)
    g = _rand((n,), 75, scale=0.1, dtype=torch.float32)
    m = _rand((n,), 76, scale=0.01, dtype=torch.float32)
    v = _rand((n,), 77, scale=0.01, dtype=torch.float32).square()
    kw = dict(step=3, lr=1e-3, weight_decay=0.01)
    before = fw.fused_adamw_update.launches
    got = fw.fused_adamw_update(p, g, m, v, None, **kw)
    torch.cuda.synchronize()
    assert fw.fused_adamw_update.launches == before + 1
    want = fw.fused_adamw_update_plain(p, g, m, v, None, **kw)
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a, b), (a - b).abs().max()


def _mnist_model(device, epochs, **cfg):
    from mila_tpu_torch.models import MLPClassifier, MLPClassifierConfig, Model, ModelConfig
    from mila_tpu_torch.optim import AdamW, AdamWConfig

    return Model(MLPClassifier(MLPClassifierConfig(name="mnist")),
                 AdamW(AdamWConfig(learning_rate=1e-3)),
                 ModelConfig(name="mnist", epochs=epochs, verbose=False, **cfg), device=device)


def test_mlp_epoch_on_the_card_matches_the_cpu(cuda):
    # One Model epoch (8 steps, prefetch depth 2) from the same params:
    # the per-epoch loss within 1e-4 relative of the CPU port's (f32 on
    # both, cuBLAS without TF32 against the CPU's GEMMs, K13 and K12 against
    # their plain versions), and the card's launches those of its path.
    from mila_tpu_torch import kernels
    from mila_tpu_torch.data import MnistReader
    from mila_tpu_torch.utils.tree import tree_map

    assert not torch.backends.cuda.matmul.allow_tf32
    cpu, card = _mnist_model("cpu", 1), _mnist_model("cuda", 1)
    cpu.build(0, (128, 784))
    card.params = tree_map(lambda p: p.cuda(), cpu.params)
    card.opt_state = card.optimizer.init(card.params)
    card._compile()
    cpu.train(MnistReader(batch_size=128, synthetic_n=1024, seed=0))
    kernels.reset_launches()
    plain = kernels.plain_calls()
    card.train(MnistReader(batch_size=128, synthetic_n=1024, seed=0))
    torch.cuda.synchronize()
    assert kernels.plain_calls() == plain
    counts = {k: v for k, v in kernels.launch_counts().items() if v}
    assert counts == {"fused_softmax_cross_entropy": 8, "fused_softmax_cross_entropy_bwd": 8,
                      "fused_adamw_step": 8}
    np.testing.assert_allclose(card.history.train_losses, cpu.history.train_losses, rtol=1e-4)


def test_mlp_resume_on_the_card_is_bit_equal(cuda, tmp_path):
    from mila_tpu_torch.data import MnistReader
    from mila_tpu_torch.utils.tree import tree_leaves

    def reader():
        return MnistReader(batch_size=128, synthetic_n=1024, seed=0)

    straight = _mnist_model("cuda", 4)
    straight.build(0, (128, 784))
    straight.train(reader())
    first = _mnist_model("cuda", 2, checkpoint_dir=str(tmp_path), checkpoint_frequency=2)
    first.build(0, (128, 784))
    first.train(reader())
    resumed = _mnist_model("cuda", 2, checkpoint_dir=str(tmp_path))
    resumed.build(0, (128, 784))
    resumed.resume_training(reader())
    assert resumed.history.train_losses == straight.history.train_losses
    for part in ("m", "v"):
        for a, b in zip(tree_leaves(getattr(straight.opt_state, part)),
                        tree_leaves(getattr(resumed.opt_state, part))):
            assert torch.equal(a, b)
    for a, b in zip(tree_leaves(straight.params), tree_leaves(resumed.params)):
        assert a.is_cuda and torch.equal(a, b)


def test_prefetch_loader_on_the_card(cuda, monkeypatch):
    # Batches land on the card equal to the reader's, through pinned memory
    # on the worker's stream; each tensor is recorded on the consumer's
    # stream. The step that reads a batch runs after a 20 ms sleep queued
    # on the consumer's stream, and the batch is dropped before the sleep
    # ends: without record_stream the worker's next copies would reuse its
    # memory and the sums would read other batches.
    from mila_tpu_torch.data import ArrayReader, PrefetchLoader

    recorded = []
    real = torch.Tensor.record_stream
    monkeypatch.setattr(torch.Tensor, "record_stream",
                        lambda self, s: (recorded.append(s), real(self, s))[1])
    x = np.random.default_rng(0).standard_normal((64 * 256, 256)).astype(np.float32)
    y = np.arange(64 * 256, dtype=np.int32)
    reader = ArrayReader(x, y, batch_size=256, shuffle=True, seed=1)
    want = [(bx.astype(np.float64).sum(), by.sum()) for bx, by in reader]
    sums = []
    for bx, by in PrefetchLoader(reader, depth=2, device="cuda"):
        assert bx.is_cuda and by.is_cuda
        torch.cuda._sleep(20_000_000)
        sums.append((bx.double().sum(), by.long().sum()))
        del bx, by
    torch.cuda.synchronize()
    assert len(sums) == len(want) == 64
    for (gx, gy), (wx, wy) in zip(sums, want):
        assert abs(gx.item() - wx) <= 1e-6 * abs(wx) + 1e-3 and gy.item() == wy
    consumer = torch.cuda.current_stream()
    assert len(recorded) == 2 * 64 and all(s == consumer for s in recorded)


def test_encoder_backward_is_bit_reproducible(cuda):
    # dwte sums the rows of repeated tokens in a fixed order (sorted
    # indices), so two backward passes over one batch are bit-equal; each
    # bf16 sum within 1e-2 of the largest of a float64 sum (one rounding).
    from mila_tpu_torch.ops.embedding import encoder

    tokens = torch.from_numpy(np.random.default_rng(95).integers(0, 16, (8, 1024))).cuda()
    wte = _rand((50304, 768), 96, scale=0.02).requires_grad_()
    wpe = _rand((1024, 768), 97, scale=0.02).requires_grad_()
    g = _rand((8, 1024, 768), 98, scale=1e-3)
    first, second = (torch.autograd.grad(encoder(tokens, wte, wpe), (wte, wpe), g)
                     for _ in range(2))
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    want = torch.zeros(50304, 768, dtype=torch.float64, device="cuda").index_add_(
        0, tokens.reshape(-1), g.double().reshape(-1, 768))
    err = (first[0].double() - want).abs().max().item()
    assert err <= 1e-2 * want.abs().max().item()
