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
same 2e-2. The argmax head's token must carry a plain logit within 1e-3 of
the row's largest (f32 sums in another order may swap near-ties).
"""

import numpy as np
import pytest
import torch

from mila_tpu_torch.inference.quantize import quantize
from mila_tpu_torch.kernels import decode_fused as df
from mila_tpu_torch.kernels import dense_attention as da
from mila_tpu_torch.kernels import layer_fused as lf
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


@pytest.mark.parametrize("M,K,N,bs,act,dtype", [
    (64, 256, 384, 0, None, torch.bfloat16),
    (100, 512, 520, 128, "gelu", torch.bfloat16),
    (1024, 2048, 3072, 0, None, torch.bfloat16),
    (37, 256, 128, 64, "silu", torch.float32),
])
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
    x = _rand((8, 256), 7)
    qt = quantize(_rand((256, 256), 8, 0.05, torch.float32), "fp8_e4m3")
    with pytest.raises(NotImplementedError):
        qm.quant_linear(x, qt)
    with pytest.raises(NotImplementedError):
        df.rms_quant_linear(x, torch.ones(256, device="cuda"), qt)


@pytest.mark.parametrize("B,NH,NKV,HD,ps,dtype", [
    (8, 32, 8, 64, 128, torch.bfloat16),
    (3, 8, 2, 32, 16, torch.float32),
    (2, 16, 2, 128, 8, torch.bfloat16),
    (5, 3, 1, 16, 24, torch.float32),
])
def test_paged_attention_kernel(cuda, B, NH, NKV, HD, ps, dtype):
    rng = np.random.default_rng(9)
    W, P = 4, 4 * B + 1
    lens = rng.integers(1, W * ps + 1, B).astype(np.int32)
    lens[0] = W * ps
    table = (1 + rng.permutation(P - 1)[: B * W].reshape(B, W)).astype(np.int32)
    q = _rand((B, 1, NH, HD), 10, dtype=dtype)
    kp = _rand((P, NKV, HD, ps), 11, dtype=dtype)
    vp = _rand((P, NKV, HD, ps), 12, dtype=dtype)
    t, ln = torch.from_numpy(table).cuda(), torch.from_numpy(lens).cuda()
    got = pa.paged_decode_attention(q, kp, vp, t, ln)
    want = pa.paged_decode_attention_plain(q, kp, vp, t, ln)
    torch.cuda.synchronize()
    _close(got, want)


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


def _tail_case(H, I, NQ, bn, layers, seed):
    rng = np.random.default_rng(seed)

    def w(*shape):
        return quantize(torch.from_numpy((rng.standard_normal(shape) * 0.05).astype(
            np.float32)).cuda(), "int8")

    ws = [(w(H, H), w(H, 2 * I), w(I, H), w(H, NQ)) for _ in range(layers)]
    packs = [lf.pack_layer(wo, wgu, down, ws[i + 1][3] if i + 1 < layers else None, bn=bn)
             for i, (wo, wgu, down, _) in enumerate(ws)]
    return packs, ls.pack_layer_stream(packs)


@pytest.mark.parametrize("H,I,NQ,bn,M,dtype", [
    (256, 512, 384, 128, 4, torch.bfloat16),
    (256, 512, 384, 128, 20, torch.float32),
    (2048, 8192, 3072, 512, 8, torch.bfloat16),  # Llama-3.2-1B's layer tail
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
