"""The per-layer megakernel (``kernels/layer_mega.py``,
``pack_decode_megalayers`` and ``Llama._backbone_mega_decode``) against
the JAX package.

The slot head order is where a port goes wrong silently, so the kernel is
held at G = 1 (NH = NKV, where the order is the identity) and at G = 4
(NH 8, NKV 2: slot n holds head (n % 2) * 4 + n // 2 and attends KV head
n % 2). Weights are made with numpy from a seed and quantized on each
side; the packs must hold the same bytes. JAX runs ``layer_megakernel`` as
its own tests run it on the CPU (``_mega_ref``), the port its plain
version.

Tolerances: the same reference arithmetic on both sides, so only the
summation order differs (and JAX's CPU attention keeps the probabilities
in f32 where the port's rounds them to bf16, one bf16 step per
probability); both round activations to bf16 before every int8 product,
so outputs are held to 1e-2 of their largest value, as the int8 model
tests are. The written cache rows are held to the same; every other row
must be untouched. Greedy tokens of the model path are compared exactly:
at these seeds no row's top-two logit margin comes near the tolerance.
fp8 packs (e4m3fn, e5m2) carry JAX's scale fixup in their scale rows, byte
for byte; their layers are held to the int8 cases' tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mila_tpu.inference import quantize as jq
from mila_tpu.inference.quantize import quantize_model_params as j_qmp
from mila_tpu.kernels import layer_mega as jmg
from mila_tpu.models import llama as jl
from mila_tpu_torch.bridge import params_from_jax
from mila_tpu_torch.inference import quantize as tq
from mila_tpu_torch.kernels import decode_fused as tdf
from mila_tpu_torch.kernels import layer_mega as tmg
from mila_tpu_torch.models import llama as tl

# name: (H, I, NH, NKV, HD, bn)
SHAPES = {"g1": (256, 512, 4, 4, 64, 128), "g4": (256, 512, 8, 2, 32, 128)}
B, T = 3, 24


def _w(rng, *shape):
    return (rng.standard_normal(shape) * 0.05).astype(np.float32)


@pytest.mark.parametrize("nh,nkv", [(4, 4), (8, 2), (32, 8), (6, 3)])
def test_slot_order_equals_jax(nh, nkv):
    got = tmg.slot_order(nh, nkv)
    np.testing.assert_array_equal(got, jmg.slot_order(nh, nkv))
    assert sorted(got) == list(range(nh))


def _layer(name, wdt):
    H, I, NH, NKV, HD, bn = SHAPES[name]
    NQ, KD = NH * HD, NKV * HD
    rng = np.random.default_rng(H + NKV)
    raw = {"wo": _w(rng, NQ, H), "wgu": _w(rng, H, 2 * I), "down": _w(rng, I, H),
           "wqkv": _w(rng, H, NQ + 2 * KD)}
    jw = {k: jq.quantize(jnp.asarray(v), wdt) for k, v in raw.items()}
    tw = {k: tq.quantize(torch.from_numpy(v), wdt) for k, v in raw.items()}
    return name, jw, tw


@pytest.fixture(scope="module", params=list(SHAPES))
def layer(request):
    return _layer(request.param, "int8")


@pytest.fixture(scope="module", params=["fp8_e4m3", "fp8_e5m2"])
def layer_fp8(request):
    return _layer("g4", request.param)


def test_permutations_equal_jax(layer):
    name, jw, tw = layer
    H, I, NH, NKV, HD, bn = SHAPES[name]
    for fn in ("permute_q_columns", "permute_wo_rows"):
        src = "wqkv" if fn == "permute_q_columns" else "wo"
        got = getattr(tmg, fn)(tw[src], NH, NKV, HD)
        want = getattr(jmg, fn)(jw[src], NH, NKV, HD)
        np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
        np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    blocked = tq.quantize(tw["wo"].q.float(), "int8", HD)
    assert tmg.permute_wo_rows(blocked, NH, NKV, HD) is None


@pytest.mark.parametrize("with_qkv", [True, False])
def test_pack_mega_layer_bytes_equal_jax(layer, with_qkv):
    name, jw, tw = layer
    H, I, NH, NKV, HD, bn = SHAPES[name]
    kw = dict(nh=NH, nkv=NKV, hd=HD, bn=bn)
    jp = jmg.pack_mega_layer(jw["wo"], jw["wgu"], jw["down"], jw["wqkv"] if with_qkv else None,
                             **kw)
    tp = tmg.pack_mega_layer(tw["wo"], tw["wgu"], tw["down"], tw["wqkv"] if with_qkv else None,
                             **kw)
    assert isinstance(tp, tmg.MegaPack) and tuple(tp[2:]) == tuple(jp[2:])
    np.testing.assert_array_equal(tp.w.numpy(), np.asarray(jp.w))
    np.testing.assert_array_equal(tp.s.numpy(), np.asarray(jp.s))
    bridged = params_from_jax(jax.tree_util.tree_map(np.asarray, {"p": jp}), "cpu")["p"]
    assert isinstance(bridged, tmg.MegaPack) and torch.equal(bridged.w, tp.w)


@pytest.mark.parametrize("with_qkv", [True, False])
def test_pack_mega_layer_fp8_bytes_equal_jax(layer_fp8, with_qkv):
    name, jw, tw = layer_fp8
    H, I, NH, NKV, HD, bn = SHAPES[name]
    kw = dict(nh=NH, nkv=NKV, hd=HD, bn=bn)
    nxt = (lambda w: w["wqkv"]) if with_qkv else (lambda w: None)
    jp = jmg.pack_mega_layer(jw["wo"], jw["wgu"], jw["down"], nxt(jw), **kw)
    tp = tmg.pack_mega_layer(tw["wo"], tw["wgu"], tw["down"], nxt(tw), **kw)
    assert tuple(tp[2:]) == tuple(jp[2:])
    assert tp.w.dtype == tw["wo"].q.dtype and tp.w.dtype in (torch.float8_e4m3fn,
                                                              torch.float8_e5m2)
    np.testing.assert_array_equal(tp.w.view(torch.uint8).numpy(), np.asarray(jp.w).view(np.uint8))
    np.testing.assert_array_equal(tp.s.numpy(), np.asarray(jp.s))


def _close(got, want, tol=1e-2):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("with_qkv", [True, False])
def test_layer_megakernel_matches_jax(layer, with_qkv):
    _megakernel_case(*layer, with_qkv)


@pytest.mark.parametrize("with_qkv", [True, False])
def test_layer_megakernel_fp8_matches_jax(layer_fp8, with_qkv):
    _megakernel_case(*layer_fp8, with_qkv)


def _megakernel_case(name, jw, tw, with_qkv):
    H, I, NH, NKV, HD, bn = SHAPES[name]
    NQ, KD = NH * HD, NKV * HD
    kw = dict(nh=NH, nkv=NKV, hd=HD, bn=bn)
    nxt = (lambda w: w["wqkv"]) if with_qkv else (lambda w: None)
    jp = jmg.pack_mega_layer(jw["wo"], jw["wgu"], jw["down"], nxt(jw), **kw)
    tp = tmg.pack_mega_layer(tw["wo"], tw["wgu"], tw["down"], nxt(tw), **kw)
    rng = np.random.default_rng(7)
    qkv = rng.standard_normal((B, NQ + 2 * KD)).astype(np.float32)
    x = rng.standard_normal((B, H)).astype(np.float32)
    g1 = (1.0 + 0.1 * rng.standard_normal(H)).astype(np.float32)
    g2 = (1.0 + 0.1 * rng.standard_normal(H)).astype(np.float32)
    kc = rng.standard_normal((B, T, NKV, HD)).astype(np.float32)
    vc = rng.standard_normal((B, T, NKV, HD)).astype(np.float32)
    lens = np.array([3, 11, T - 1], np.int32)
    inv = (1.0 / 10000.0 ** (np.arange(0, HD, 2) / HD)).astype(np.float32)
    ang = lens[:, None].astype(np.float32) * np.tile(np.concatenate([inv, inv]), NKV)[None]
    sign = np.tile(np.concatenate([-np.ones(HD // 2), np.ones(HD // 2)]), NKV)[None]
    cos_t, sin_t = np.cos(ang).astype(np.float32), (sign * np.sin(ang)).astype(np.float32)
    bf = jnp.bfloat16
    jout = jmg.layer_megakernel(
        jnp.asarray(qkv, bf), jnp.asarray(x, bf)[:, None], jnp.asarray(g1), jp,
        jnp.asarray(kc, bf), jnp.asarray(vc, bf), jnp.asarray(lens), jnp.asarray(cos_t),
        jnp.asarray(sin_t), jnp.asarray(g2) if with_qkv else None, num_heads=NH)
    tkc = torch.from_numpy(kc).to(torch.bfloat16)
    tvc = torch.from_numpy(vc).to(torch.bfloat16)
    before = tmg.layer_megakernel_plain.calls
    tout = tmg.layer_megakernel(
        torch.from_numpy(qkv).to(torch.bfloat16), torch.from_numpy(x).to(torch.bfloat16)[:, None],
        torch.from_numpy(g1), tp, tkc, tvc, torch.from_numpy(lens), torch.from_numpy(cos_t),
        torch.from_numpy(sin_t), torch.from_numpy(g2) if with_qkv else None, num_heads=NH)
    assert tmg.layer_megakernel_plain.calls == before + 1
    assert tout[2] is tkc and tout[3] is tvc
    assert tout[0].shape == (B, 1, H) and tout[0].dtype == torch.bfloat16
    _close(tout[0], jout[0])
    if with_qkv:
        _close(tout[1], jout[1])
    else:
        assert tout[1] is None and jout[1] is None
    rows = np.arange(B)
    for got, want in ((tkc, jout[2]), (tvc, jout[3])):
        want = np.asarray(jnp.asarray(want, jnp.float32))
        _close(got[rows, lens], want[rows, lens])
        for b in rows:
            keep = np.arange(T) != lens[b]
            np.testing.assert_array_equal(got[b][keep].float().numpy(), want[b][keep])


# ---------------------------------------------------------------------------
# The model path: pack_decode_megalayers and _backbone_mega_decode
# ---------------------------------------------------------------------------

V = 61


@pytest.fixture(scope="module")
def mega_models():
    cfg = jl.LlamaConfig.tiny(vocab_size=V)  # NH 4, NKV 2: G = 2
    jmodel = jl.Llama(cfg)
    raw = jmodel.init(jax.random.key(8), (1, 16))
    jq_ = jl.add_quantized_lm_head(j_qmp(jl.fuse_llama_projections(raw), "int8"))
    jp = jl.pack_decode_megalayers(jq_, cfg, bn=128)
    assert "mega_pack" in jp["h0"]
    tq_ = params_from_jax(jax.tree_util.tree_map(np.asarray, jq_), "cpu")
    tcfg = tl.LlamaConfig.tiny(vocab_size=V)
    return jmodel, jp, tl.Llama(tcfg, device="cpu"), tq_, tcfg


def test_pack_decode_megalayers_bytes_equal_jax(mega_models):
    _, jp, _, tq_, tcfg = mega_models
    tp = tl.pack_decode_megalayers(tq_, tcfg, bn=128)
    bridged = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    for i in range(tcfg.num_layers):
        mine, theirs = tp[f"h{i}"]["mega_pack"], bridged[f"h{i}"]["mega_pack"]
        assert tuple(mine[2:]) == tuple(theirs[2:])
        assert torch.equal(mine.w, theirs.w) and torch.equal(mine.s, theirs.s)
    assert torch.equal(tp["h0"]["wqkv_slot"].q, bridged["h0"]["wqkv_slot"].q)
    assert tp[f"h{tcfg.num_layers - 1}"]["mega_pack"].n_qkv == 0


def test_pack_decode_megalayers_fp8_bytes_equal_jax():
    # pack_decode_megalayers over fp8 e4m3 params packs fp8 tiles (the giga
    # pack requantizes them to int8 instead): byte for byte JAX's.
    cfg = jl.LlamaConfig.tiny(vocab_size=V)
    raw = jl.Llama(cfg).init(jax.random.key(8), (1, 16))
    jq_ = jl.add_quantized_lm_head(j_qmp(jl.fuse_llama_projections(raw), "fp8_e4m3"))
    jp = jl.pack_decode_megalayers(jq_, cfg, bn=128)
    tcfg = tl.LlamaConfig.tiny(vocab_size=V)
    tp = tl.pack_decode_megalayers(params_from_jax(jax.tree_util.tree_map(np.asarray, jq_),
                                                   "cpu"), tcfg, bn=128)
    for i in range(tcfg.num_layers):
        mine, theirs = tp[f"h{i}"]["mega_pack"], jp[f"h{i}"]["mega_pack"]
        assert mine.w.dtype == torch.float8_e4m3fn and tuple(mine[2:]) == tuple(theirs[2:])
        np.testing.assert_array_equal(mine.w.view(torch.uint8).numpy(),
                                      np.asarray(theirs.w).view(np.uint8))
        np.testing.assert_array_equal(mine.s.numpy(), np.asarray(theirs.s))


def test_model_mega_path_matches_jax(mega_models):
    """Prefill, three greedy_step_with_cache steps and a ragged step on the
    mega params; each decode step is one rms_quant_linear, L megakernels and
    the argmax head."""
    jmodel, jp, tmodel, tq_, tcfg = mega_models
    tp = tl.pack_decode_megalayers(tq_, tcfg, bn=128)
    rng = np.random.default_rng(9)
    Bm, P = 3, 5
    prompt = rng.integers(0, V, (Bm, P)).astype(np.int32)
    jc, tc = jmodel.init_kv_cache(Bm, 16, jnp.float32), tmodel.init_kv_cache(Bm, 16,
                                                                             torch.float32)
    jlog, jc = jmodel.forward_with_cache(jp, jnp.asarray(prompt), jc, 0)
    tlog, tc = tmodel.forward_with_cache(tp, torch.from_numpy(prompt), tc, 0)
    _close(tlog, jlog)
    tok = np.asarray(jnp.argmax(jlog[:, -1], -1)).astype(np.int32)[:, None]
    for step in range(3):
        before = (tmg.layer_megakernel_plain.calls, tdf.rms_quant_linear_plain.calls,
                  tdf.rms_quant_linear_argmax_plain.calls)
        jt, jc = jmodel.greedy_step_with_cache(jp, jnp.asarray(tok), jc, P + step)
        tt, tc = tmodel.greedy_step_with_cache(tp, torch.from_numpy(tok), tc, P + step)
        assert (tmg.layer_megakernel_plain.calls - before[0],
                tdf.rms_quant_linear_plain.calls - before[1],
                tdf.rms_quant_linear_argmax_plain.calls - before[2]) == (tcfg.num_layers, 1, 1)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        tok = np.asarray(jt)
    for i in range(tcfg.num_layers):
        _close(tc[f"h{i}"]["k"], jc[f"h{i}"]["k"])
        _close(tc[f"h{i}"]["v"], jc[f"h{i}"]["v"])
    pos = np.array([P + 3, P + 3, P + 3], np.int32)
    jlog, _ = jmodel.forward_with_cache_ragged(jp, jnp.asarray(tok), jc, jnp.asarray(pos))
    tlog, _ = tmodel.forward_with_cache_ragged(tp, torch.from_numpy(tok), tc,
                                               torch.from_numpy(pos))
    _close(tlog, jlog)


def test_mega_route_rule_is_jax_s(mega_models):
    """The megakernel runs unless a layer_stream is there to take a cache
    over the JAX package's 72 MB budget."""
    _, _, tmodel, tq_, tcfg = mega_models
    both = tl.pack_decode_layers(tl.pack_decode_megalayers(tq_, tcfg, bn=128), bn=128)
    assert "layer_stream" in both
    x = torch.zeros(2, 1, tcfg.hidden_size)
    cos, sin = tmodel._rope(torch.zeros(2, 1, dtype=torch.long))
    lens = torch.zeros(2, dtype=torch.int32)
    for maxT, route in ((16, True), (40 * 1024, False)):
        cache = tmodel.init_kv_cache(2, maxT, torch.float32)
        before = tmg.layer_megakernel_plain.calls
        tmodel._backbone_fused_decode(both, x, cache, lens, cos, sin)
        ran = tmg.layer_megakernel_plain.calls - before
        assert ran == (tcfg.num_layers if route else 0)
