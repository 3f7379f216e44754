"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``requires_cuda``: without a CUDA device these tests skip (decided in
a fixture, never at import). Run them on a GPU machine with
``python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q``
(``tests/conftest.py`` imports JAX, which a GPU machine need not have).
``chip_smoke.py`` repeats these checks at the served shapes.

Tolerances: both sides see the same bf16-rounded operands and accumulate
in f32, in different orders. Outputs rounded to bf16 may then differ by one
bf16 step (2^-8 relative); we allow 2e-2 of the output's max magnitude.
"""

import numpy as np
import pytest
import torch

from mila_tpu_torch.inference.quantize import quantize
from mila_tpu_torch.kernels import decode_fused as df
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
