"""The whole-step decode (``kernels/decode_giga.py``, ``requantize_int8``,
``pack_decode_giga``, ``Llama.giga_step``) against the JAX package.

Two shapes: the JAX tests' G = 1 (H 512, I 1024, NH = NKV = 8, HD 64,
bn 512), where the slot order is the identity, and G = 4 (H 256, I 512,
NH 8, NKV 2, HD 32, bn 64, so KD = bn), where it is not: a port that
attended KV head h // G instead of the slot's n % NKV would fail there.
Weights are made with numpy from a seed and quantized on each side; the
packs must hold the same bytes. JAX runs ``giga_decode_step`` as its own
tests run it on the CPU (``_giga_ref``), the port its plain version.

Tolerances: the same reference arithmetic on both sides, so only the
summation order differs. Both round activations to bf16 before every int8
product; a last-ulp difference can flip one such rounding, so the written
cache rows are held to 1e-2 of their largest value, as the int8 model
tests are. The logits get 2e-2: JAX's CPU attention keeps the
probabilities in f32 where the port's plain attention rounds them to bf16
(as JAX's does off the CPU), one bf16 step (2^-8) per probability, which
two layers of bf16 roundings carry into the logits (measured: up to 1.1e-2
of the largest logit). Greedy tokens are compared exactly: at these seeds
no row's top-two logit margin comes near that tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mila_tpu.inference import quantize as jq
from mila_tpu.inference import requant as jrq
from mila_tpu.inference.quantize import quantize_model_params as j_qmp
from mila_tpu.kernels import decode_giga as jg
from mila_tpu.models import llama as jl
from mila_tpu_torch.bridge import params_from_jax
from mila_tpu_torch.inference import quantize as tq
from mila_tpu_torch.inference import requant as trq
from mila_tpu_torch.inference.quantize import quantize_model_params as t_qmp
from mila_tpu_torch.kernels import decode_giga as tg
from mila_tpu_torch.models import llama as tl

# name: (L, H, I, NH, NKV, HD, bn, head columns, vocab)
SHAPES = {"g1": (2, 512, 1024, 8, 8, 64, 512, 1024, 1000),
          "g4": (2, 256, 512, 8, 2, 32, 64, 192, 184)}
B, T = 3, 32
LOGIT_TOL = 2e-2


def _w(rng, *shape):
    return (rng.standard_normal(shape) * 0.05).astype(np.float32)


def _build(name):
    L, H, I, NH, NKV, HD, bn, VP, V = SHAPES[name]
    NQ, KD = NH * HD, NKV * HD
    rng = np.random.default_rng(len(name) + H)
    raw = [(_w(rng, NQ, H), _w(rng, H, 2 * I), _w(rng, I, H), _w(rng, H, NQ + 2 * KD))
           for _ in range(L)]
    head = _w(rng, H, VP)
    ga = (1.0 + 0.1 * rng.standard_normal((L, H))).astype(np.float32)
    gm = (1.0 + 0.1 * rng.standard_normal((L, H))).astype(np.float32)
    gf = (1.0 + 0.1 * rng.standard_normal(H)).astype(np.float32)
    inv = (1.0 / 10000.0 ** (np.arange(0, HD, 2) / HD)).astype(np.float32)
    kw = dict(nh=NH, nkv=NKV, hd=HD, vocab=V, bn=bn, rope_inv_freq=inv)
    jpack = jg.pack_giga([tuple(jq.quantize(jnp.asarray(w), "int8") for w in ws) for ws in raw],
                         jq.quantize(jnp.asarray(head), "int8"), jnp.asarray(ga),
                         jnp.asarray(gm), jnp.asarray(gf), **kw)
    tpack = tg.pack_giga([tuple(tq.quantize(torch.from_numpy(w), "int8") for w in ws)
                          for ws in raw], tq.quantize(torch.from_numpy(head), "int8"),
                         torch.from_numpy(ga), torch.from_numpy(gm), torch.from_numpy(gf), **kw)
    return jpack, tpack


@pytest.fixture(scope="module", params=list(SHAPES))
def packs(request):
    return request.param, *_build(request.param)


def _close(got, want, tol=1e-2):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())))


def test_pack_giga_bytes_equal_jax(packs):
    name, jp, tp = packs
    assert isinstance(tp, tg.GigaPack)
    assert tuple(tp[7:]) == tuple(jp[7:])
    assert isinstance(tp.eps, float)
    for f in ("w", "s", "ga", "gm", "gf", "freq", "sign"):
        np.testing.assert_array_equal(getattr(tp, f).numpy(), np.asarray(getattr(jp, f)),
                                      err_msg=f)
    tpl = tp.n_wo + tp.n_gu + tp.n_down + tp.n_qkv
    assert tp.w.shape[0] == tp.n_qkv + tp.n_layers * tpl - tp.n_qkv + tp.n_head
    assert tp.w.shape[0] % 8 == 0
    n_real = SHAPES[name][7] // tp.bn
    assert tp.n_head > n_real and not tp.w[-(tp.n_head - n_real):].any()


def test_pack_giga_refuses_what_jax_refuses():
    rng = np.random.default_rng(1)
    wo = tq.quantize(torch.from_numpy(_w(rng, 512, 512)))
    head = tq.quantize(torch.from_numpy(_w(rng, 512, 1024)))
    g = torch.ones(1, 512)
    assert tg.pack_giga([(wo, wo, wo, wo)], head, g, g, g[0], nh=8, nkv=4, hd=64,
                        vocab=1000) is None  # KD != bn
    blocked = tq.quantize(torch.from_numpy(_w(rng, 512, 1024)), "int8", 128)
    assert tg.pack_giga([(wo, wo, wo, wo)], blocked, g, g, g[0], nh=8, nkv=8, hd=64,
                        vocab=1000) is None  # head scale blocks smaller than H


def _step_inputs(name, seed):
    L, H, I, NH, NKV, HD, bn, VP, V = SHAPES[name]
    KD = NKV * HD
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H)).astype(np.float32)
    lens = np.array([5, 17, T - 1], np.int32)[:B]
    pos = lens[:, None].astype(np.float32)
    inv = (1.0 / 10000.0 ** (np.arange(0, HD, 2) / HD)).astype(np.float32)
    ang = pos * np.tile(np.concatenate([inv, inv]), NKV)[None]
    sign = np.tile(np.concatenate([-np.ones(HD // 2), np.ones(HD // 2)]), NKV)[None]
    cos_t, sin_t = np.cos(ang).astype(np.float32), (sign * np.sin(ang)).astype(np.float32)
    kp = rng.standard_normal((L, B, T, KD)).astype(np.float32)
    vp = rng.standard_normal((L, B, T, KD)).astype(np.float32)
    wte = rng.standard_normal((V, H)).astype(np.float32)
    tokens = rng.integers(0, V, B).astype(np.int32)
    return x, cos_t, sin_t, lens, kp, vp, wte, tokens


@pytest.mark.parametrize("mode", ["x", "tokens"])
def test_giga_decode_step_matches_jax(packs, mode):
    name, jp, tp = packs
    x, cos_t, sin_t, lens, kp, vp, wte, tokens = _step_inputs(name, seed=3)
    jkp, jvp = jnp.asarray(kp, jnp.bfloat16), jnp.asarray(vp, jnp.bfloat16)
    tkp = torch.from_numpy(kp).to(torch.bfloat16)
    tvp = torch.from_numpy(vp).to(torch.bfloat16)
    before = tg.giga_decode_plain.calls
    if mode == "x":
        jout = jg.giga_decode_step(jnp.asarray(x, jnp.bfloat16), jnp.asarray(cos_t),
                                   jnp.asarray(sin_t), jnp.asarray(lens), jp, jkp, jvp)
        tout = tg.giga_decode_step(torch.from_numpy(x).to(torch.bfloat16),
                                   torch.from_numpy(cos_t), torch.from_numpy(sin_t),
                                   torch.from_numpy(lens), tp, tkp, tvp)
    else:
        jout = jg.giga_decode_step(jnp.asarray(wte), None, None, jnp.asarray(lens), jp, jkp,
                                   jvp, tokens=jnp.asarray(tokens))
        tout = tg.giga_decode_step(torch.from_numpy(wte), None, None, torch.from_numpy(lens),
                                   tp, tkp, tvp, tokens=torch.from_numpy(tokens))
    assert tg.giga_decode_plain.calls == before + 1
    tok, logits, kp2, vp2 = tout
    assert kp2 is tkp and vp2 is tvp  # written in place
    assert tok.dtype == torch.int32 and tok.shape == (B, 1) and logits.dtype == torch.bfloat16
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jout[0]))
    assert int(tok.max()) < tp.vocab
    _close(logits, jout[1], LOGIT_TOL)
    rows = np.arange(B)
    for got, want in ((kp2, jout[2]), (vp2, jout[3])):
        want = np.asarray(jnp.asarray(want, jnp.float32))
        for l in range(tp.n_layers):
            _close(got[l][rows, lens], want[l][rows, lens])
            keep = np.ones(T, bool)
            for b in rows:  # every other row is untouched
                keep[:] = True
                keep[lens[b]] = False
                np.testing.assert_array_equal(got[l, b][keep].float().numpy(),
                                              want[l, b][keep])


@pytest.mark.parametrize("dt", ["fp8_e4m3", "fp8_e5m2", "int8", "int4"])
def test_requantize_int8_matches_jax(dt):
    w = _w(np.random.default_rng(5), 256, 96)
    jqt = jrq.requantize_int8(jq.quantize(jnp.asarray(w), dt, 64))
    tqt = trq.requantize_int8(tq.quantize(torch.from_numpy(w), dt, 64))
    assert tqt.block_size == jqt.block_size and tqt.packed_rows == (jqt.packed_rows or 0)
    assert str(tqt.q.dtype).split(".")[-1] == jnp.dtype(jqt.q.dtype).name
    np.testing.assert_array_equal(tqt.q.view(torch.uint8).numpy(),
                                  np.asarray(jqt.q).view(np.uint8))
    np.testing.assert_array_equal(tqt.scale.numpy(), np.asarray(jqt.scale))


# ---------------------------------------------------------------------------
# The model: pack_decode_giga, giga_step, the stacked pools
# ---------------------------------------------------------------------------

def _cfg(mod, name):
    L, H, I, NH, NKV, HD, bn, VP, V = SHAPES[name]
    return mod.LlamaConfig(name=f"llama-giga-{name}", vocab_size=V, hidden_size=H,
                           intermediate_size=I, num_layers=L, num_heads=NH, num_kv_heads=NKV,
                           head_dim=HD, max_seq_len=128, rope_theta=10000.0,
                           param_dtype="float32")


@pytest.fixture(scope="module")
def model_g4():
    name = "g4"
    bn = SHAPES[name][6]
    cfg = _cfg(jl, name)
    jmodel = jl.Llama(cfg)
    raw = jmodel.init(jax.random.key(0), (1, 8))
    traw = params_from_jax(jax.tree_util.tree_map(np.asarray, raw), "cpu")
    return name, bn, cfg, jmodel, raw, traw


def _both_giga(model_g4, dt, bf16_stream=False):
    name, bn, cfg, jmodel, raw, traw = model_g4
    tcfg = _cfg(tl, name)
    if bf16_stream:
        jb = jl.fuse_llama_projections(jax.tree_util.tree_map(
            lambda a: a.astype(jnp.bfloat16), raw))
        tb = params_from_jax(jax.tree_util.tree_map(np.asarray, jb), "cpu")
        return (jl.pack_decode_giga(jb, cfg, bn=bn, bf16_stream=True),
                tl.pack_decode_giga(tb, tcfg, bn=bn, bf16_stream=True))
    jq_ = jl.add_quantized_lm_head(j_qmp(jl.fuse_llama_projections(raw), dt), dt, pad_to=bn)
    tq_ = tl.add_quantized_lm_head(t_qmp(tl.fuse_llama_projections(traw), dt, device="cpu"), dt,
                                   pad_to=bn)
    return jl.pack_decode_giga(jq_, cfg, bn=bn), tl.pack_decode_giga(tq_, tcfg, bn=bn)


@pytest.mark.parametrize("dt", ["int8", "fp8_e4m3", "int4", "bf16_stream"])
def test_pack_decode_giga_bytes_equal_jax(model_g4, dt):
    jp, tp = _both_giga(model_g4, dt, bf16_stream=dt == "bf16_stream")
    assert "giga_pack" in jp and "giga_pack" in tp
    jgp, tgp = jp["giga_pack"], tp["giga_pack"]
    assert tuple(tgp[7:]) == tuple(jgp[7:])
    want_dt = torch.bfloat16 if dt == "bf16_stream" else torch.int8
    assert tgp.w.dtype == want_dt
    raw_view = (lambda t: t.view(torch.int16)) if dt == "bf16_stream" else (lambda t: t)
    np.testing.assert_array_equal(raw_view(tgp.w).numpy(),
                                  np.asarray(jgp.w).view(raw_view(tgp.w).numpy().dtype))
    for f in ("s", "ga", "gm", "gf", "sign"):
        np.testing.assert_array_equal(getattr(tgp, f).numpy(), np.asarray(getattr(jgp, f)))
    # The RoPE frequencies come from each side's rope_frequencies: an ulp apart at most.
    np.testing.assert_allclose(tgp.freq.numpy(), np.asarray(jgp.freq), rtol=2e-7)


def test_pack_decode_giga_needs_a_quantized_head(model_g4):
    _, _, _, _, _, traw = model_g4
    assert "giga_pack" not in tl.pack_decode_giga(traw, _cfg(tl, "g4"), bn=64)


def test_giga_step_matches_jax(model_g4):
    """Prefill with forward_with_cache on each side, stack the cache, then
    three giga steps fed the JAX tokens."""
    _giga_steps(model_g4, "int8")


def test_giga_step_bf16_stream_matches_jax(model_g4):
    """The same on pack_decode_giga(bf16_stream=True): unit-scale bf16
    tiles with the padded tied wte^T as the head."""
    _giga_steps(model_g4, "bf16_stream")


def _giga_steps(model_g4, dt):
    name, bn, cfg, jmodel, _, _ = model_g4
    jp, tp = _both_giga(model_g4, dt, bf16_stream=dt == "bf16_stream")
    assert "giga_pack" in tp
    tmodel = tl.Llama(_cfg(tl, name), device="cpu")
    rng = np.random.default_rng(11)
    Bm, P, C = 2, 6, 24
    prompt = rng.integers(0, cfg.vocab_size, (Bm, P)).astype(np.int32)
    jc = jmodel.init_kv_cache(Bm, C)
    tc = tmodel.init_kv_cache(Bm, C)
    jlog, jc = jmodel.forward_with_cache(jp, jnp.asarray(prompt), jc, 0)
    tlog, tc = tmodel.forward_with_cache(tp, torch.from_numpy(prompt), tc, 0)
    _close(tlog, jlog)
    jkp, jvp = jmodel.stack_kv_cache(jc)
    tkp, tvp = tmodel.stack_kv_cache(tc)
    assert tuple(tkp.shape) == (cfg.num_layers, Bm, C, cfg.num_kv_heads * cfg.hd)
    tok = np.asarray(jnp.argmax(jlog[:, -1], -1)).astype(np.int32)[:, None]
    for step in range(3):
        lens = np.full((Bm,), P + step, np.int32)
        jt, jlg, jkp, jvp = jmodel.giga_step(jp, jnp.asarray(tok), jkp, jvp, jnp.asarray(lens))
        tt, tlg, tkp, tvp = tmodel.giga_step(tp, torch.from_numpy(tok), tkp, tvp,
                                             torch.from_numpy(lens))
        assert tlg.shape == (Bm, cfg.vocab_size)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        _close(tlg, jlg, LOGIT_TOL)
        tok = np.asarray(jt)
    _close(tkp, jkp)
    _close(tvp, jvp)
    back = tmodel.unstack_kv_cache(tkp, tvp)
    assert back["h1"]["k"].data_ptr() == tkp[1].data_ptr()  # views of the pools


def test_stack_unstack_round_trip(model_g4):
    name = model_g4[0]
    tmodel = tl.Llama(_cfg(tl, name), device="cpu")
    cache = tmodel.init_kv_cache(2, 16, torch.bfloat16)
    for i, lc in enumerate(cache.values()):
        lc["k"].normal_(generator=torch.Generator().manual_seed(i))
        lc["v"].normal_(generator=torch.Generator().manual_seed(10 + i))
    kp, vp = tmodel.stack_kv_cache(cache)
    back = tmodel.unstack_kv_cache(kp, vp)
    for key in cache:
        assert torch.equal(back[key]["k"], cache[key]["k"])
        assert torch.equal(back[key]["v"], cache[key]["v"])
    back["h0"]["k"][0, 0] = 7.0
    assert float(kp[0, 0, 0, 0]) == 7.0


def test_bridge_carries_giga_pack(packs):
    """eps stays a float and a pack without RoPE rows keeps its None."""
    name, jp, tp = packs
    for pack in (jp, jp._replace(freq=None, sign=None)):
        got = params_from_jax(jax.tree_util.tree_map(np.asarray, {"giga_pack": pack}),
                              "cpu")["giga_pack"]
        assert isinstance(got, tg.GigaPack)
        assert isinstance(got.eps, float) and got.eps == pytest.approx(1e-5)
        assert tuple(got[7:]) == tuple(tp[7:])
        assert torch.equal(got.w, tp.w) and torch.equal(got.s, tp.s)
        if pack.freq is None:
            assert got.freq is None and got.sign is None
        else:
            assert torch.equal(got.freq, tp.freq)


def test_decode_step_bytes_giga_matches_jax(model_g4):
    from benchmarks.llama_bench import decode_step_bytes as j_bytes

    name, bn, cfg, *_ = model_g4
    jp, tp = _both_giga(model_g4, "int8")
    want = j_bytes(jp, cfg, 8, 512)
    assert tl.decode_step_bytes(tp, _cfg(tl, name), 8, 512) == want
    assert want["weight_bytes"] == jp["giga_pack"].w.nbytes + jp["giga_pack"].s.nbytes
