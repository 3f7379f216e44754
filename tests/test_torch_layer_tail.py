"""The layer-tail stream: ``pack_layer``, ``pack_layer_stream``,
``mlp_qkv_fused`` and ``layer_tail_stream`` against the JAX package.

Three layers of H 256, I 512 and a wqkv of 384 columns, int8 with
per-channel scales, quantized on each side from the same numpy weights.
The packs must hold the same bytes as JAX's; a JAX pack bridged into the
port must equal the port's own. The tails (plain path) run against JAX's
(its CPU route is ``_layer_tail_ref`` / ``_qkv_tail_ref``) for the first,
a middle and the last layer.

Tolerance: the same references on both sides, so only summation order
differs. Both round activations to bf16 before every int8 product (f32
activations included); a last-ulp f32 difference can flip one such
rounding, so we allow 1e-2 of the largest output, as for the int8 model.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mila_tpu.inference import quantize as jq
from mila_tpu.kernels import layer_fused as jlf
from mila_tpu.kernels import layer_stream as jls
from mila_tpu_torch.bridge import params_from_jax
from mila_tpu_torch.inference import quantize as tq
from mila_tpu_torch.kernels import layer_fused as tlf
from mila_tpu_torch.kernels import layer_stream as tls

L, B, H, I, NQ, BN = 3, 4, 256, 512, 384, 128
_DT = {"f32": (jnp.float32, torch.float32, 1e-2), "bf16": (jnp.bfloat16, torch.bfloat16, 1e-2)}


def _w(rng, *shape):
    return (rng.standard_normal(shape) * 0.05).astype(np.float32)


def _build_layers(wdt):
    rng = np.random.default_rng(0)
    raw = [{"wo": _w(rng, H, H), "wgu": _w(rng, H, 2 * I), "down": _w(rng, I, H),
            "wqkv": _w(rng, H, NQ)} for _ in range(L)]
    jw = [{k: jq.quantize(jnp.asarray(v), wdt) for k, v in r.items()} for r in raw]
    tw = [{k: tq.quantize(torch.from_numpy(v), wdt) for k, v in r.items()} for r in raw]

    def packs(mod, ws):
        return [mod.pack_layer(w["wo"], w["wgu"], w["down"],
                               ws[i + 1]["wqkv"] if i + 1 < L else None, bn=BN)
                for i, w in enumerate(ws)]

    jpacks, tpacks = packs(jlf, jw), packs(tlf, tw)
    return jpacks, tpacks, jls.pack_layer_stream(jpacks), tls.pack_layer_stream(tpacks)


@pytest.fixture(scope="module")
def layers():
    return _build_layers("int8")


# fp8 packs carry JAX's scale fixup (2^120 for e4m3, 2^112 for e5m2) in
# their scale rows, byte for byte; the tails are held to the int8 cases'
# tolerance.
@pytest.fixture(scope="module", params=["fp8_e4m3", "fp8_e5m2"])
def layers_fp8(request):
    return _build_layers(request.param)


def test_pack_layer_bytes_equal_jax(layers):
    jpacks, tpacks, _, _ = layers
    for jp, tp in zip(jpacks, tpacks):
        assert tuple(tp[2:]) == tuple(jp[2:])
        np.testing.assert_array_equal(tp.w.numpy(), np.asarray(jp.w))
        np.testing.assert_array_equal(tp.s.numpy(), np.asarray(jp.s))
    assert tpacks[0].n_qkv == NQ // BN and tpacks[-1].n_qkv == 0


def test_pack_layer_stream_bytes_equal_jax(layers):
    _, _, js, ts = layers
    assert tuple(ts[4:]) == tuple(js[4:])
    for name in ("w", "s", "w_last", "s_last"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(), np.asarray(getattr(js, name)))


def test_bridge_carries_the_stream(layers):
    _, _, js, ts = layers
    bridged = params_from_jax(jax.tree_util.tree_map(np.asarray, {"layer_stream": js}),
                              "cpu")["layer_stream"]
    assert isinstance(bridged, tls.LayerStream)
    assert tuple(bridged[4:]) == tuple(ts[4:])
    for a, b in zip(bridged[:4], ts[:4]):
        assert torch.equal(a, b)


def test_pack_layer_refuses_what_jax_refuses():
    ones = lambda *s: np.ones(s, np.float32) * 0.01  # noqa: E731
    wo, wgu, down = (tq.quantize(torch.from_numpy(ones(*s))) for s in
                     ((256, 256), (256, 1024), (512, 256)))
    bad = tq.quantize(torch.from_numpy(ones(256, 300)))
    assert tlf.pack_layer(wo, wgu, down, bad, bn=256) is None
    assert tlf.pack_layer(wo, wgu, down, None, bn=256) is not None
    int4 = tq.quantize(torch.from_numpy(ones(256, 256)), "int4")
    assert tlf.pack_layer(int4, wgu, down, None) is None


def _acts(dt, seed):
    jdt, tdt, _ = _DT[dt]
    rng = np.random.default_rng(seed)
    att, x = rng.standard_normal((B, 1, H)), rng.standard_normal((B, 1, H))
    g1 = (1.0 + 0.1 * rng.standard_normal(H)).astype(np.float32)
    g2 = (1.0 + 0.1 * rng.standard_normal(H)).astype(np.float32)
    jargs = (jnp.asarray(att, jdt), jnp.asarray(x, jdt), jnp.asarray(g1), jnp.asarray(g2))
    targs = (torch.from_numpy(att).to(tdt), torch.from_numpy(x).to(tdt), torch.from_numpy(g1),
             torch.from_numpy(g2))
    return jargs, targs


def _close(got, want, tol):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("layer", [0, 1, 2])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_layer_tail_stream_matches_jax(layers, layer, dt):
    _, _, js, ts = layers
    (ja, jx, jg1, jg2), (ta, tx, tg1, tg2) = _acts(dt, seed=10 + layer)
    last = layer == L - 1
    jout, jqkv = jls.layer_tail_stream(ja, jx, jg1, js, layer, None if last else jg2)
    before = tlf.layer_tail_plain.calls
    tout, tqkv = tls.layer_tail_stream(ta, tx, tg1, ts, layer, None if last else tg2)
    assert tlf.layer_tail_plain.calls == before + 1
    assert tout.dtype == tx.dtype
    _close(tout, jout, _DT[dt][2])
    if last:
        assert jqkv is None and tqkv is None
    else:
        assert tqkv.shape == (B, 1, NQ)
        _close(tqkv, jqkv, _DT[dt][2])


@pytest.mark.parametrize("with_qkv", [True, False])
def test_mlp_qkv_fused_matches_jax(layers, with_qkv):
    jpacks, tpacks, _, _ = layers
    i = 0 if with_qkv else L - 1
    (ja, jx, jg1, jg2), (ta, tx, tg1, tg2) = _acts("bf16", seed=20)
    jout, jqkv = jlf.mlp_qkv_fused(ja[:, 0], jx[:, 0], jg1, jpacks[i], jg2 if with_qkv else None)
    tout, tqkv = tlf.mlp_qkv_fused(ta[:, 0], tx[:, 0], tg1, tpacks[i], tg2 if with_qkv else None)
    _close(tout, jout, 1e-2)
    if with_qkv:
        _close(tqkv, jqkv, 1e-2)
    else:
        assert jqkv is None and tqkv is None


def test_pack_layer_fp8_bytes_equal_jax(layers_fp8):
    jpacks, tpacks, js, ts = layers_fp8
    for jp, tp in zip(jpacks, tpacks):
        assert tp.w.dtype in (torch.float8_e4m3fn, torch.float8_e5m2)
        np.testing.assert_array_equal(tp.w.view(torch.uint8).numpy(),
                                      np.asarray(jp.w).view(np.uint8))
        np.testing.assert_array_equal(tp.s.numpy(), np.asarray(jp.s))
    np.testing.assert_array_equal(ts.s_last.numpy(), np.asarray(js.s_last))


@pytest.mark.parametrize("layer", [0, 1, 2])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_layer_tail_stream_fp8_matches_jax(layers_fp8, layer, dt):
    _, _, js, ts = layers_fp8
    (ja, jx, jg1, jg2), (ta, tx, tg1, tg2) = _acts(dt, seed=10 + layer)
    last = layer == L - 1
    jout, jqkv = jls.layer_tail_stream(ja, jx, jg1, js, layer, None if last else jg2)
    tout, tqkv = tls.layer_tail_stream(ta, tx, tg1, ts, layer, None if last else tg2)
    assert tout.dtype == tx.dtype
    _close(tout, jout, _DT[dt][2])
    if last:
        assert jqkv is None and tqkv is None
    else:
        _close(tqkv, jqkv, _DT[dt][2])


@pytest.mark.parametrize("with_qkv", [True, False])
def test_mlp_qkv_fused_fp8_matches_jax(layers_fp8, with_qkv):
    jpacks, tpacks, _, _ = layers_fp8
    i = 0 if with_qkv else L - 1
    (ja, jx, jg1, jg2), (ta, tx, tg1, tg2) = _acts("bf16", seed=20)
    jout, jqkv = jlf.mlp_qkv_fused(ja[:, 0], jx[:, 0], jg1, jpacks[i], jg2 if with_qkv else None)
    tout, tqkv = tlf.mlp_qkv_fused(ta[:, 0], tx[:, 0], tg1, tpacks[i], tg2 if with_qkv else None)
    _close(tout, jout, 1e-2)
    if with_qkv:
        _close(tqkv, jqkv, 1e-2)
    else:
        assert jqkv is None and tqkv is None


def test_layer_id_must_be_an_int(layers):
    _, _, _, ts = layers
    _, (ta, tx, tg1, tg2) = _acts("f32", seed=30)
    with pytest.raises(TypeError):
        tls.layer_tail_stream(ta, tx, tg1, ts, torch.tensor(0), tg2)


def test_tail_plan_covers_the_served_shapes():
    """The cooperative launch plan (host arithmetic) at Llama-3.2-1B's layer
    tail, its MLP block (bn 2048) and the giga head (251 vocab tiles and the
    5 zero tiles that pad the stream): units of 256 weight columns, every
    phase's K slice whole ring stages whose staged bf16 slice fits the
    block's shared memory, at most one unit per block unless the slice size
    or the tile count forces more, and no slice doubling left that would
    still keep to one unit per block."""
    sr = tlf._STAGE_ROWS
    shapes = ((512, {"wo": 4, "gu": 32, "down": 16, "qkv": 6}),
              (2048, {"wo": 1, "gu": 8, "down": 4}),
              (512, {"head": 256}))
    for bn, tiles in shapes:
        for M in (1, 8, 32):
            for grid in (132, 264):
                mt, plan = tlf.plan_tail(M, 2048, bn, tiles, grid)
                assert mt == (8 if M <= 8 else 32)
                for name, n in tiles.items():
                    cols, ks = plan[name]
                    kc, units = 2048 // ks, n * (bn // cols) * ks
                    assert cols == 256 and 2048 % ks == 0 and kc % sr == 0
                    assert tlf._xs_bytes(kc, mt) <= tlf._XS_BYTES
                    assert (units <= grid or ks == 1
                            or tlf._xs_bytes(2 * kc, mt) > tlf._XS_BYTES)
                    assert units * 2 > grid or kc == sr
    assert tlf.plan_tail(8, 2048, 512, shapes[0][1], 264)[1] == {
        "wo": (256, 32), "gu": (256, 4), "down": (256, 8), "qkv": (256, 16)}


@pytest.mark.parametrize("H,bn,M,smallest", [(256, 128, 4, 64), (512, 512, 1, 64),
                                             (3072, 512, 32, 192)])
def test_tail_plan_small_and_odd_shapes(H, bn, M, smallest):
    """128-column units where bn is not a multiple of 256; an H whose plan
    reaches the smallest slice (one ring stage); an H that is not a power of
    two, cut only into whole stages (3072 = 16 x 192). The slicing takes 128-column units
    where bn would take 256 too (the phase tool's ``c128`` plan)."""
    sr = tlf._STAGE_ROWS
    tiles = {"wo": H // bn, "gu": 4, "down": 2 * H // bn}
    mt, plan = tlf.plan_tail(M, H, bn, tiles, 264)
    for name, (cols, ks) in plan.items():
        assert cols == (256 if bn % 256 == 0 else 128)
        assert H % ks == 0 and (H // ks) % sr == 0
        assert tlf._xs_bytes(H // ks, mt) <= tlf._XS_BYTES
    assert min(H // ks for _, ks in plan.values()) == smallest
    assert all(c == 128 and (H // ks) % sr == 0
               for c, ks in tlf._slice_plan(M, H, bn, tiles, 264, 128)[1].values())
    with pytest.raises(ValueError):
        tlf.plan_tail(M, H + sr // 2, bn, tiles, 264)
