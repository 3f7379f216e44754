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


@pytest.fixture(scope="module")
def layers():
    rng = np.random.default_rng(0)
    raw = [{"wo": _w(rng, H, H), "wgu": _w(rng, H, 2 * I), "down": _w(rng, I, H),
            "wqkv": _w(rng, H, NQ)} for _ in range(L)]
    jw = [{k: jq.quantize(jnp.asarray(v), "int8") for k, v in r.items()} for r in raw]
    tw = [{k: tq.quantize(torch.from_numpy(v), "int8") for k, v in r.items()} for r in raw]

    def packs(mod, ws):
        return [mod.pack_layer(w["wo"], w["wgu"], w["down"],
                               ws[i + 1]["wqkv"] if i + 1 < L else None, bn=BN)
                for i, w in enumerate(ws)]

    jpacks, tpacks = packs(jlf, jw), packs(tlf, tw)
    return jpacks, tpacks, jls.pack_layer_stream(jpacks), tls.pack_layer_stream(tpacks)


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


def test_layer_id_must_be_an_int(layers):
    _, _, _, ts = layers
    _, (ta, tx, tg1, tg2) = _acts("f32", seed=30)
    with pytest.raises(TypeError):
        tls.layer_tail_stream(ta, tx, tg1, ts, torch.tensor(0), tg2)


def test_tail_plan_covers_the_served_shapes():
    """The cooperative launch plan (host arithmetic) at Llama-3.2-1B's tail:
    every phase's staged K slice fits the block's shared memory, and a
    phase has at most one unit per block unless the slice size forces more."""
    tiles = {"wo": 4, "gu": 32, "down": 16, "qkv": 6}
    for M in (1, 8, 32):
        for grid in (132, 264):
            mt, ks = tlf.plan_tail(M, 2048, 512, tiles, grid)
            for name, n in tiles.items():
                kc = 2048 // ks[name]
                assert kc * mt * 4 <= 32 * 1024 and kc % 8 == 0
                assert n * 4 * ks[name] <= grid or kc * mt * 4 > 16 * 1024
                assert n * 4 * ks[name] * 2 > grid or kc == 64
    assert tlf.plan_tail(8, 2048, 512, tiles, 264)[1] == {"wo": 16, "gu": 2, "down": 4,
                                                          "qkv": 8}
