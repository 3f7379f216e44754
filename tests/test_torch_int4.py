"""Packed int4 weights in the port against the JAX package.

``quant_linear`` on int4 weights (plain path) is held to JAX's
``_quant_linear_int4`` with its Pallas nibble kernel in interpret mode: at
M 1, 8 and 32 the gate passes and both sides compute ``_qmm4_kernel``'s
arithmetic (per K window, low and high halves times their own scale rows);
at M 64 both unpack to int8 rows and take the int8 path. Per-channel and
blocked scales (the halves then read different scale rows). The four
decode entries take JAX's int4 routes (unfused norm, ``quant_linear``,
residual or SwiGLU outside; the argmax head returns None). Last, the tiny
Llama quantized to int4 (``quantize_model_params`` +
``add_quantized_lm_head``) through ``apply``, ``forward_paged_prefill`` and
``forward_paged_ragged``.

Tolerances: both sides multiply the same bf16-exact operands and sum in
f32 in another order, so f32 outputs agree to 1e-5 and bf16 outputs to one
bf16 step (1e-2); the int4 Llama's logits to 1e-2 of the largest logit (a
last-ulp f32 difference can flip one bf16 rounding of an activation).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mila_tpu.inference import kv_cache as jkv
from mila_tpu.inference import quantize as jq
from mila_tpu.inference.quantize import quantize_model_params as j_qmp
from mila_tpu.kernels import decode_fused as jdf
from mila_tpu.kernels.quant_matmul import quant_linear as j_quant_linear
from mila_tpu.models import llama as jl
from mila_tpu_torch.bridge import params_from_jax
from mila_tpu_torch.inference import quantize as tq
from mila_tpu_torch.inference.quantize import quantize_model_params as t_qmp
from mila_tpu_torch.kernels import decode_fused as tdf
from mila_tpu_torch.kernels import quant_matmul as tqm
from mila_tpu_torch.models import llama as tl

_TORCH = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}
K, N = 512, 512


def _data(M, seed=0, n=N):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = (rng.standard_normal((K, n)) * 0.05).astype(np.float32)
    g = (1.0 + 0.1 * rng.standard_normal(K)).astype(np.float32)
    r = rng.standard_normal((M, n)).astype(np.float32)
    return x, w, g, r


def _check(got, want, xdt):
    assert got.dtype == _TORCH[xdt]
    tol = 1e-5 if xdt == jnp.float32 else 1e-2
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("M,route", [(1, True), (8, True), (32, True), (64, False)])
@pytest.mark.parametrize("bs", [0, 128])
@pytest.mark.parametrize("xdt", [jnp.float32, jnp.bfloat16])
def test_quant_linear_int4_matches_jax(M, route, bs, xdt):
    x, w, _, _ = _data(M, seed=M + bs)
    jw, tw = jq.quantize(jnp.asarray(w), "int4", bs), tq.quantize(torch.from_numpy(w), "int4", bs)
    assert tw.packed_rows == K and tqm._int4_blocks(M, K, N, tw.block_size)[0] == route
    want = j_quant_linear(jnp.asarray(x, xdt), jw, interpret=True)
    got = tqm.quant_linear(torch.from_numpy(x).to(_TORCH[xdt]), tw)
    _check(got, want, xdt)


def test_blocked_scales_read_both_halves():
    """With 128-row scale blocks, the high half's rows read scale rows
    K/2/128 on: a kernel that read the low half's rows would differ."""
    x, w, _, _ = _data(8, seed=1)
    w[K // 2:] *= 8.0  # the high half's scales differ from the low half's
    tw = tq.quantize(torch.from_numpy(w), "int4", 128)
    got = tqm.quant_linear_int4_plain(torch.from_numpy(x), tw)
    want = torch.from_numpy(x).bfloat16().float() @ tq.dequantize(tw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("act,bias", [("gelu", True), ("silu", False)])
def test_quant_linear_int4_epilogue_matches_jax(act, bias):
    x, w, _, r = _data(8, seed=5)
    b = r[0] * 0.1 if bias else None
    want = j_quant_linear(jnp.asarray(x), jq.quantize(jnp.asarray(w), "int4"),
                          None if b is None else jnp.asarray(b), activation=act, interpret=True)
    got = tqm.quant_linear(torch.from_numpy(x), tq.quantize(torch.from_numpy(w), "int4"),
                           None if b is None else torch.from_numpy(b), activation=act)
    _check(got, want, jnp.float32)


@pytest.mark.parametrize("xdt", [jnp.float32, jnp.bfloat16])
def test_decode_entries_take_the_int4_routes(xdt):
    x, w, g, r = _data(8, seed=7)
    jw, tw = jq.quantize(jnp.asarray(w), "int4"), tq.quantize(torch.from_numpy(w), "int4")
    jx, tx = jnp.asarray(x, xdt), torch.from_numpy(x).to(_TORCH[xdt])
    jr, tr = jnp.asarray(r, xdt), torch.from_numpy(r).to(_TORCH[xdt])
    jg, tg = jnp.asarray(g), torch.from_numpy(g)
    _check(tdf.rms_quant_linear(tx, tg, tw, eps=1e-5),
           jdf.rms_quant_linear(jx, jg, jw, eps=1e-5, interpret=True), xdt)
    _check(tdf.quant_linear_residual(tx, tw, tr),
           jdf.quant_linear_residual(jx, jw, jr, interpret=True), xdt)
    _check(tdf.rms_quant_linear_swiglu(tx, tg, tw, eps=1e-5),
           jdf.rms_quant_linear_swiglu(jx, jg, jw, eps=1e-5, interpret=True), xdt)
    assert jdf.rms_quant_linear_argmax(jx, jg, jw, vocab_size=N, interpret=True) is None
    assert tdf.rms_quant_linear_argmax(tx, tg, tw, vocab_size=N) is None


# ---------------------------------------------------------------------------
# The tiny Llama quantized to int4
# ---------------------------------------------------------------------------

V, B, BUCKET, PS, STEPS = 61, 3, 16, 8, 4
LENS = np.array([5, 16, 9], np.int32)


@pytest.fixture(scope="module")
def int4_models():
    cfg = jl.LlamaConfig.tiny(vocab_size=V)
    jmodel = jl.Llama(cfg)
    raw = jmodel.init(jax.random.key(0), (1, 16))
    jparams = jl.add_quantized_lm_head(j_qmp(jl.fuse_llama_projections(raw), "int4"), "int4")
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    traw = params_from_jax(jax.tree_util.tree_map(np.asarray, raw), "cpu")
    return jmodel, jparams, tl.Llama(tl.LlamaConfig.tiny(vocab_size=V), device="cpu"), \
        tparams, traw


def _tol(ref):
    return 1e-2 * float(np.abs(ref).max())


def test_bridge_carries_int4_qtensors(int4_models):
    _, jp, _, tp, traw = int4_models
    for path in (("h0", "wqkv", "weight"), ("h1", "down", "weight"), ("lm_head_q",)):
        j, t = jp, tp
        for p in path:
            j, t = j[p], t[p]
        assert (t.block_size, t.packed_rows) == (j.block_size, j.packed_rows) != (0, 0)
        assert t.q.dtype == torch.int8 and t.q.shape[0] == t.packed_rows // 2
        np.testing.assert_array_equal(t.q.numpy(), np.asarray(j.q))
        np.testing.assert_array_equal(t.scale.numpy(), np.asarray(j.scale))
    # The port's own fuse -> int4 quantize -> int4 head gives the same bytes.
    own = tl.add_quantized_lm_head(t_qmp(tl.fuse_llama_projections(traw), "int4",
                                         device="cpu"), "int4")
    for path in (("h1", "wgu", "weight"), ("h0", "wo", "weight"), ("lm_head_q",)):
        j, t = jp, own
        for p in path:
            j, t = j[p], t[p]
        np.testing.assert_array_equal(t.q.numpy(), np.asarray(j.q))
        np.testing.assert_array_equal(t.scale.numpy(), np.asarray(j.scale))


def test_bridge_carries_int8_pools(int4_models):
    """JAX's int8 pools after a paged scatter bridge unchanged: int8 pages
    and f32 scale planes, bytes equal."""
    jmodel = int4_models[0]
    pools = jmodel.init_paged_cache(num_pages=4, page_size=PS, dtype=jnp.int8)
    rng = np.random.default_rng(2)
    k, v = (jnp.asarray(rng.standard_normal((2, 3, 2, 32)).astype(np.float32)) for _ in "kv")
    pools = jkv.paged_scatter(pools, 1, jnp.asarray([[1, 1, 2], [3, 3, 3]]),
                              jnp.asarray([[0, 7, 2], [1, 4, 5]]), k, v)
    bridged = params_from_jax(jax.tree_util.tree_map(np.asarray, pools), "cpu")
    assert set(bridged) == {"k", "v", "k_scale", "v_scale"}
    for name, arr in pools.items():
        want = np.asarray(arr)
        assert str(bridged[name].dtype) == f"torch.{want.dtype}"
        np.testing.assert_array_equal(bridged[name].numpy(), want)
    assert np.abs(np.asarray(pools["k"])).max() > 0


def test_int4_apply_matches_jax(int4_models):
    jmodel, jp, tmodel, tp, _ = int4_models
    toks = np.random.default_rng(0).integers(0, V, (2, 12)).astype(np.int32)
    want = np.asarray(jmodel.apply(jp, jnp.asarray(toks)))
    got = tmodel.apply(tp, torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, atol=_tol(want), rtol=0)


@pytest.mark.parametrize("cache", ["float32", "int8"])
def test_int4_paged_prefill_and_decode_match_jax(int4_models, cache):
    jmodel, jp, tmodel, tp, _ = int4_models
    rng = np.random.default_rng(1)
    tokens = np.zeros((B, BUCKET), np.int32)
    for i, n in enumerate(LENS):
        tokens[i, :n] = rng.integers(0, V, n)
    table = (1 + np.arange(B * 4)).reshape(B, 4).astype(np.int32)
    jpools = jmodel.init_paged_cache(num_pages=16, page_size=PS, dtype=jnp.dtype(cache))
    tpools = tmodel.init_paged_cache(num_pages=16, page_size=PS,
                                     dtype=getattr(torch, cache))
    assert ("k_scale" in tpools) == (cache == "int8")
    jlog, jpools = jmodel.forward_paged_prefill(jp, jnp.asarray(tokens), jpools,
                                                jnp.asarray(table), jnp.asarray(LENS))
    tlog, tpools = tmodel.forward_paged_prefill(tp, torch.from_numpy(tokens), tpools,
                                                torch.from_numpy(table), torch.from_numpy(LENS))
    want = np.asarray(jlog)
    np.testing.assert_allclose(tlog.numpy(), want, atol=_tol(want), rtol=0)
    pos = LENS.copy()
    for step in range(STEPS):
        nxt = rng.integers(0, V, (B, 1)).astype(np.int32)
        jlog, jpools = jmodel.forward_paged_ragged(jp, jnp.asarray(nxt), jpools,
                                                   jnp.asarray(table), jnp.asarray(pos))
        tlog, tpools = tmodel.forward_paged_ragged(tp, torch.from_numpy(nxt), tpools,
                                                   torch.from_numpy(table), torch.from_numpy(pos))
        want = np.asarray(jlog)
        np.testing.assert_allclose(tlog.numpy(), want, atol=_tol(want), rtol=0,
                                   err_msg=f"decode step {step}")
        pos = pos + 1


# The int4 kernel's plan (``_plan_int4``) at serve long's shapes (Llama-3.2-1B:
# wqkv, wo, wgu, down and the unpadded vocab head), M 1, 8 and 32, per-channel
# and 128-row scale blocks, on the H100 SXM's 132 SMs.
_SERVE_LONG_INT4 = {"wqkv": (2048, 3072), "wo": (2048, 2048), "wgu": (2048, 16384),
                    "down": (8192, 2048), "head": (2048, 128256)}


@pytest.mark.parametrize("bs", [0, 128])
@pytest.mark.parametrize("M", [1, 8, 32])
@pytest.mark.parametrize("name", list(_SERVE_LONG_INT4))
def test_plan_int4_contract(name, M, bs):
    import inspect

    K, N = _SERVE_LONG_INT4[name]
    sms = 132
    block = bs or K
    assert tqm._int4_blocks(M, K, N, block)[0]  # the gate sends these shapes to the kernel
    assert list(inspect.signature(tqm._plan_int4).parameters) == ["M", "K", "N", "block_size",
                                                                  "sms"]
    ks, win = tqm._plan_int4(M, K, N, block, sms)
    Kp, tiles = K // 2, N // tqm.INT4_COLS
    kc = Kp // ks
    # Slices of whole stages cover the packed rows once; the scale windows are
    # the JAX gate's, inside one scale block for both halves.
    assert 1 <= ks <= tqm.INT4_MAX_SLICES and Kp % ks == 0 and kc % tqm.INT4_STAGE_ROWS == 0
    assert win == tqm._int4_blocks(M, K, N, block)[1]
    assert win % tqm.INT4_STAGE_ROWS == 0 and Kp % win == 0 and block % win == 0
    assert N % tqm.INT4_COLS == 0
    # x's staged slice fits beside the ring.
    assert tqm._int4_x_bytes(M, kc) <= tqm.INT4_X_BYTES
    assert tqm.INT4_RING_BYTES + tqm.INT4_X_BYTES + tqm.INT4_RECV_BYTES <= 227 * 1024
    # The grid stays within one block per SM unless x's stage forces more
    # slices; and it takes every slice that keeps it there (halving again
    # would not be needed, doubling would overfill the card or the cluster).
    fits = tqm._int4_x_bytes(M, 2 * kc) <= tqm.INT4_X_BYTES
    assert tiles * ks <= sms or ks == 1 or not fits
    assert (tiles * 2 * ks > sms or ks == tqm.INT4_MAX_SLICES or kc // 2 < tqm.INT4_MIN_ROWS
            or (kc // 2) % tqm.INT4_STAGE_ROWS)
    if name == "wgu" and M == 8:
        assert ks == 2  # 64 tiles: 128 blocks on 132 SMs


def test_plan_int4_refuses_what_the_kernel_cannot_tile():
    with pytest.raises(ValueError):
        tqm._plan_int4(8, 2048, 3000, 2048, 132)  # N not a multiple of 128 columns
    with pytest.raises(ValueError):
        tqm._plan_int4(64, 2048, 3072, 2048, 132)  # M past the decode kernel
