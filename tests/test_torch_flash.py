"""Flash attention (forward) and the attention dispatcher against the JAX
package.

The port's ``flash_attention`` on CPU tensors runs its plain version (the
kernel's arithmetic in one pass over the keys); JAX's ``flash_attention``
runs its Pallas kernel in interpret mode, tile by tile with the online
softmax. Same seeded numpy inputs on both sides, causal, GQA with NKV 4, 2
and 1 under NH 4, D 64 and 128 (and 192, 256 and 320 at one shape), f32,
bf16 and fp16, a ``kv_offset`` window (Tq 128 over Tkv 512), the gate's
fallback shape, ``flash_mha_qkv``, the routing of
``resolve_attention_impl`` / ``attention``, and the kernel family each
type and head size takes on the card (``routes``).

Tolerances: f32 inputs differ by summation order and by the online
rescaling only (1e-5 of the output's largest value); bf16 inputs also
round p to bf16 against a running max on the JAX side and the final max on
the port's, and the outputs to bf16 (2e-2 of the largest value); fp16 the
same with 8 times finer steps (5e-3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mila_tpu.kernels.flash_attention import flash_attention as j_flash
from mila_tpu.kernels.flash_attention import flash_mha_qkv as j_flash_mha_qkv
from mila_tpu.ops import attention as jatt
from mila_tpu_torch import ops
from mila_tpu_torch.ops.attention import attention
from mila_tpu_torch.kernels import flash_attention as tfa

_TORCH = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32,
          jnp.float16: torch.float16}
_TOL = {jnp.float32: 1e-5, jnp.bfloat16: 2e-2, jnp.float16: 5e-3}


def _qkv(B, Tq, Tkv, NH, NKV, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Tq, NH, D)).astype(np.float32),
            rng.standard_normal((B, Tkv, NKV, D)).astype(np.float32),
            rng.standard_normal((B, Tkv, NKV, D)).astype(np.float32))


def _both(arrays, dt):
    return [jnp.asarray(a, dt) for a in arrays], [torch.from_numpy(a).to(_TORCH[dt])
                                                   for a in arrays]


def _close(got, want, dt):
    want = np.asarray(want.astype(jnp.float32))
    assert got.dtype == _TORCH[dt] and got.shape == want.shape
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=_TOL[dt] * float(np.abs(want).max()))


@pytest.mark.parametrize("T", [256, 512])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("nkv", [4, 2, 1])
@pytest.mark.parametrize("dt", [jnp.float32, jnp.bfloat16, jnp.float16])
def test_flash_attention_matches_jax(T, D, nkv, dt):
    (jq, jk, jv), (q, k, v) = _both(_qkv(2, T, T, 4, nkv, D, seed=T + D + nkv), dt)
    want = j_flash(jq, jk, jv, causal=True, interpret=True)
    before = tfa.flash_attention_plain.calls
    got = tfa.flash_attention(q, k, v, causal=True)
    assert tfa.flash_attention_plain.calls == before + 1  # the kernel's plain version ran
    _close(got, want, dt)


@pytest.mark.parametrize("D", [192, 256, 320])
@pytest.mark.parametrize("dt", [jnp.float32, jnp.bfloat16, jnp.float16])
def test_flash_attention_wide_heads_match_jax(D, dt):
    # The head sizes past 128 that JAX's gate admits: on the card D 192
    # and 256 take the wgmma forwards' wide kernels, D 320 their
    # column-part kernels (plan_wide).
    (jq, jk, jv), (q, k, v) = _both(_qkv(1, 256, 256, 4, 2, D, seed=D), dt)
    want = j_flash(jq, jk, jv, causal=True, interpret=True)
    before = tfa.flash_attention_plain.calls
    got = tfa.flash_attention(q, k, v, causal=True)
    assert tfa.flash_attention_plain.calls == before + 1
    _close(got, want, dt)


@pytest.mark.parametrize("dtype,D,want", [
    (torch.float16, 64, ("wgmma", "wgmma")),
    (torch.float16, 128, ("wgmma", "wgmma")),
    (torch.bfloat16, 64, ("wgmma", "wgmma")),
    (torch.bfloat16, 192, ("wgmma", "wgmma")),
    (torch.bfloat16, 256, ("wgmma", "wgmma")),
    (torch.float16, 192, ("wgmma", "wgmma")),
    (torch.float16, 256, ("wgmma", "wgmma")),
    (torch.float32, 64, ("tf32", "tf32")),
    (torch.float32, 128, ("tf32", "tf32")),
    (torch.float32, 192, ("tf32", "sync")),
    (torch.float32, 256, ("tf32", "sync")),
    (torch.float32, 320, ("tf32", "sync")),
    (torch.float32, 512, ("tf32", "sync")),
    (torch.bfloat16, 320, ("wgmma", "wgmma")),
    (torch.float32, 1024, ("tf32", "sync")),
    (torch.float32, 384, ("tf32", "sync")),
    (torch.float32, 576, ("tf32", "sync")),
    (torch.bfloat16, 384, ("wgmma", "wgmma")),
    (torch.bfloat16, 576, ("wgmma", "wgmma")),
    (torch.bfloat16, 1024, ("wgmma", "wgmma")),
    (torch.float16, 384, ("wgmma", "wgmma")),
    (torch.float16, 576, ("wgmma", "wgmma")),
    (torch.float16, 1024, ("wgmma", "wgmma")),
])
def test_routes_by_type_and_head_size(dtype, D, want):
    # The card's kernel family of the forward and of the backward: the
    # forward runs on wgmma at every D, bf16 and fp16 on the wgmma kernels,
    # f32 on the tf32 ones; the backward takes the wgmma kernels for bf16
    # and fp16 at every D (past 256 on plan_bwd's column parts) and the tf32
    # ones for f32 up to 128, f32's 8-warp "sync" kernels past it.
    assert tfa.routes(dtype, D) == want


@pytest.mark.parametrize("elem_bytes", [2, 4])
@pytest.mark.parametrize("D", range(320, 1025, 64))
def test_wide_forward_plan(D, elem_bytes):
    # csrc/flash_part.cuh's plan past D 256, through its Python mirror: the
    # column parts and each part's two warpgroup halves cover every column
    # of the head exactly once (16-bit halves in whole 64-column panels, f32
    # halves of 32-column multiples), the block's shared memory fits the
    # H100's 232,448 bytes, and O takes at most 128 f32 registers a thread.
    p = tfa.plan_wide(D, elem_bytes)
    owned = [c for part in p["cols"] for c0, n in part for c in range(c0, c0 + n)]
    assert sorted(owned) == list(range(D))
    assert [c0 for c0, _ in p["parts"]] == [c0 for (c0, _), _ in p["cols"]]
    for (c0, nc), ((a0, na), (b0, nb)) in zip(p["parts"], p["cols"]):
        assert nc <= p["dc"] <= p["dcmax"] <= 512 and a0 == c0 and b0 == c0 + na
        assert na >= nb and na % (64 if elem_bytes == 2 else 32) == 0
    assert p["smem"] <= 232448 and p["o_regs"] <= 128
    assert p["nk"] >= p["nv"] >= 1 and p["chunk"] * elem_bytes in (128, D * elem_bytes)
    assert D % p["chunk"] == 0 and 128 % p["bk"] == 0


@pytest.mark.parametrize("elem_bytes,D,want", [
    (2, 512, (1, 32, True, 3, 2)),
    (2, 576, (2, 64, True, 1, 1)),
    (4, 320, (1, 16, True, 3, 3)),
    (4, 512, (1, 16, True, 2, 1)),
    (4, 1024, (2, 16, False, 4, 2)),
    (2, 1088, (3, 32, False, 4, 2)),
])
def test_wide_forward_plan_at_timed_shapes(elem_bytes, D, want):
    # chip_smoke.py's rows (D 512; f32 D 320; 16-bit D 320 runs K10's wide
    # kernel) keep Q resident with two or more K stages; 16-bit D 576 takes
    # two 320-column parts; f32 D 1024 and 16-bit past D 1024 stream Q
    # beside K.
    p = tfa.plan_wide(D, elem_bytes)
    assert (len(p["parts"]), p["bk"], p["q_res"], p["nk"], p["nv"]) == want


@pytest.mark.parametrize("D", range(320, 1089, 64))
def test_wide_backward_plan(D):
    # csrc/flash_part.cuh's plan_bwd, through its Python mirror: the dQ
    # parts and the dK/dV parts, with each part's two warpgroup halves, cover
    # every column of the head exactly once in whole 64-column panels; both
    # kernels' shared memory fits the H100's 232,448 bytes beside a ring of
    # at least 4 jobs (every accumulating product's jobs at once); dK and dV
    # take 128 f32 registers a thread, dQ at most 128.
    p = tfa.plan_bwd(D)
    for parts, cols, most in ((p["dq_parts"], p["dq_cols"], 512),
                              (p["kv_parts"], p["kv_cols"], 256)):
        owned = [c for part in cols for c0, n in part for c in range(c0, c0 + n)]
        assert sorted(owned) == list(range(D))
        for (c0, nc), ((a0, na), (b0, nb)) in zip(parts, cols):
            assert 0 < nc <= most and a0 == c0 and b0 == c0 + na
            assert na >= nb and na % 64 == 0 and nb % 64 == 0
    assert all(na <= 64 * p["dq_op"] for (_, na), _ in p["dq_cols"])
    assert p["smem"] <= 232448 and 4 <= p["ring"] <= 8
    assert p["kv_regs"] <= 128 and p["dq_regs"] <= 128
    assert p["res_bytes"] == (2 * 64 * D * 2 if p["res"] else 0)


@pytest.mark.parametrize("D,want", [
    (320, (1, 2, True, 7)),
    (512, (1, 2, True, 4)),
    (576, (2, 3, False, 8)),
    (1024, (2, 4, False, 8)),
    (1088, (3, 5, False, 8)),
])
def test_wide_backward_plan_at_timed_shapes(D, want):
    # chip_smoke.py's rows (D 320 and 512) keep the block's own operands
    # resident (Q and dO, or K and V) with four or more jobs in the ring;
    # from D 576 they stream, and dQ takes two or three parts.
    p = tfa.plan_bwd(D)
    assert (len(p["dq_parts"]), len(p["kv_parts"]), p["res"], p["ring"]) == want


@pytest.mark.parametrize("dtype,D", [(torch.float64, 64), (torch.bfloat16, 96),
                                     (torch.float32, 0)])
def test_routes_refuse_what_no_kernel_takes(dtype, D):
    with pytest.raises(NotImplementedError):
        tfa.routes(dtype, D)


@pytest.mark.parametrize("dt", [jnp.float32, jnp.bfloat16])
def test_flash_attention_kv_offset(dt):
    (jq, jk, jv), (q, k, v) = _both(_qkv(2, 128, 512, 4, 2, 64, seed=3), dt)
    want = j_flash(jq, jk, jv, causal=True, kv_offset=384, interpret=True)
    _close(tfa.flash_attention(q, k, v, causal=True, kv_offset=384), want, dt)


def test_flash_attention_small_tiles_match_one_pass():
    """JAX with 128-row tiles (four key tiles, the online rescaling) against
    the port's one-pass arithmetic."""
    (jq, jk, jv), (q, k, v) = _both(_qkv(1, 512, 512, 4, 1, 64, seed=4), jnp.float32)
    want = j_flash(jq, jk, jv, causal=True, block_q=128, block_k=128, interpret=True)
    _close(tfa.flash_attention(q, k, v, causal=True), want, jnp.float32)


def test_gate_fallback_shape():
    """Tq % 16 != 0: both wrappers take the plain product."""
    (jq, jk, jv), (q, k, v) = _both(_qkv(2, 200, 200, 4, 2, 64, seed=5), jnp.float32)
    assert not ops.flash_tiles_ok(200, 200, 64)
    before = tfa.flash_attention_plain.calls
    got = tfa.flash_attention(q, k, v, causal=True)
    assert tfa.flash_attention_plain.calls == before
    _close(got, j_flash(jq, jk, jv, causal=True, interpret=True), jnp.float32)


def test_flash_mha_qkv_matches_jax():
    qkv = np.random.default_rng(6).standard_normal((2, 256, 3 * 4 * 64)).astype(np.float32)
    want = j_flash_mha_qkv(jnp.asarray(qkv), 4, causal=True)
    _close(tfa.flash_mha_qkv(torch.from_numpy(qkv), 4, causal=True), want, jnp.float32)


def test_resolve_attention_impl_routes():
    assert ops.FLASH_MIN_SEQ == jatt.FLASH_MIN_SEQ == 2048
    # CPU tensors: the plain product, as JAX on its CPU backend.
    assert ops.resolve_attention_impl("auto", 4096, "cpu") == "xla"
    assert jatt.resolve_attention_impl("auto", 4096) == "xla"  # the tests' JAX backend is the CPU
    # CUDA tensors: flash from FLASH_MIN_SEQ keys (and for an unknown length).
    assert ops.resolve_attention_impl("auto", 2047, "cuda") == "xla"
    assert ops.resolve_attention_impl("auto", 2048, "cuda") == "flash"
    assert ops.resolve_attention_impl("auto", 0, torch.device("cuda")) == "flash"
    for impl in ("xla", "flash"):
        assert ops.resolve_attention_impl(impl, 16, "cpu") == impl
    with pytest.raises(ValueError):
        ops.resolve_attention_impl("pallas")


def test_attention_dispatch_on_cpu():
    _, (q, k, v) = _both(_qkv(1, 256, 256, 4, 2, 64, seed=7), jnp.float32)
    plain = ops.dot_product_attention(q, k, v, causal=True)
    before = tfa.flash_attention_plain.calls
    torch.testing.assert_close(attention(q, k, v, causal=True), plain, rtol=0, atol=0)
    assert tfa.flash_attention_plain.calls == before  # "auto" on the CPU: plain product
    flash = attention(q, k, v, causal=True, impl="flash")
    assert tfa.flash_attention_plain.calls == before + 1
    torch.testing.assert_close(flash, plain, rtol=0, atol=1e-5)


@pytest.mark.parametrize("Tq,Tkv,D", [(200, 256, 64), (128, 320, 64), (128, 256, 32)])
def test_attention_routes_refused_shapes_to_plain(Tq, Tkv, D):
    """impl="flash" at a shape the tiling gate refuses: the dispatcher takes
    the plain product without entering the flash wrapper; JAX's dispatcher
    reaches the same product through its wrapper's fallback."""
    assert not ops.flash_tiles_ok(Tq, Tkv, D)
    (jq, jk, jv), (q, k, v) = _both(_qkv(1, Tq, Tkv, 4, 2, D, seed=8), jnp.float32)
    off = Tkv - Tq
    before = tfa.flash_attention_plain.calls
    got = attention(q, k, v, causal=True, kv_offset=off, impl="flash")
    assert tfa.flash_attention_plain.calls == before
    _close(got, jatt.attention(jq, jk, jv, causal=True, kv_offset=off, impl="flash"),
           jnp.float32)
