"""The MLP-block stream (``kernels/decode_mlp.py``, ``pack_decode_mlp`` and
``LlamaBlock._finish_attn``'s ``mlp_pack`` branch) against the JAX package.

H 256, I 512, int8 and fp8 weights quantized on each side from the same
numpy weights: the packs must hold the same bytes. JAX's
``mlp_block_fused`` runs on the CPU as its own tests run it (the grid
kernel ``_mlp_mega_kernel`` in interpret mode); the port runs its plain
version, which repeats that kernel's rounding. ``mlp_block_ref`` (the
oracle) is held against JAX's too, and the plain version against it.

Tolerances: the port's plain version and JAX's interpreted kernel do the
same arithmetic, f32 products of bf16 operands in another summation
order; a last-ulp difference can flip a bf16 rounding of xn or h, so the
outputs are held to 1e-2 of their largest value (the int8 model tests'
tolerance). The plain version against the oracle: 5e-2 absolute and
relative, the JAX package's own tolerance between its kernel and this
oracle (the oracle rounds x1 and every product to the activation dtype).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mila_tpu.inference import quantize as jq
from mila_tpu.inference.quantize import quantize_model_params as j_qmp
from mila_tpu.kernels import decode_mlp as jm
from mila_tpu.models import llama as jl
from mila_tpu_torch.bridge import params_from_jax
from mila_tpu_torch.inference import quantize as tq
from mila_tpu_torch.kernels import decode_fused as tdf
from mila_tpu_torch.kernels import decode_mlp as tm
from mila_tpu_torch.models import llama as tl

H, I = 256, 512
_DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _weights(dtype, seed=0):
    rng = np.random.default_rng(seed)
    raw = [(rng.standard_normal(s) * 0.05).astype(np.float32) for s in ((H, H), (H, 2 * I),
                                                                       (I, H))]
    return ([jq.quantize(jnp.asarray(w), dtype) for w in raw],
            [tq.quantize(torch.from_numpy(w), dtype) for w in raw])


def _acts(M, dt, seed=1):
    rng = np.random.default_rng(seed)
    att, x = rng.standard_normal((M, H)), rng.standard_normal((M, H))
    g = (1.0 + 0.1 * rng.standard_normal(H)).astype(np.float32)
    jdt, tdt = _DT[dt]
    return ((jnp.asarray(att, jdt), jnp.asarray(x, jdt), jnp.asarray(g)),
            (torch.from_numpy(att).to(tdt), torch.from_numpy(x).to(tdt), torch.from_numpy(g)))


def _close(got, want, tol=1e-2):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("dtype,bn", [("int8", 128), ("int8", 256), ("fp8_e4m3", 128)])
def test_pack_mlp_bytes_equal_jax(dtype, bn):
    jw, tw = _weights(dtype)
    jp, tp = jm.pack_mlp(*jw, bn=bn), tm.pack_mlp(*tw, bn=bn)
    assert tuple(tp[2:]) == tuple(jp[2:])
    np.testing.assert_array_equal(tp.w.view(torch.uint8).numpy(), np.asarray(jp.w).view(np.uint8))
    np.testing.assert_array_equal(tp.s.numpy(), np.asarray(jp.s))


def test_pack_mlp_refuses_what_jax_refuses():
    jw, tw = _weights("int8")
    rng = np.random.default_rng(2)
    bad = tq.quantize(torch.from_numpy((rng.standard_normal((384, H)) * 0.05).astype(np.float32)))
    assert tm.pack_mlp(tw[0], tw[1], bad) is None  # down is not [I, H]
    int4 = [tq.quantize(torch.from_numpy(w.q.float().numpy()), "int4") for w in tw]
    assert tm.pack_mlp(*int4) is None
    blocked = tq.quantize(torch.from_numpy(tw[1].q.float().numpy()), "int8", 128)
    assert tm.pack_mlp(tw[0], blocked, tw[2]) is None


@pytest.mark.parametrize("M", [1, 8, 32])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_mlp_block_fused_matches_jax(M, dt):
    jw, tw = _weights("int8")
    jp, tp = jm.pack_mlp(*jw, bn=128), tm.pack_mlp(*tw, bn=128)
    (ja, jx, jg), (ta, tx, tg) = _acts(M, dt)
    want = jm.mlp_block_fused(ja[:, None], jx[:, None], jg, jp)
    before = tm.mlp_block_plain.calls
    got = tm.mlp_block_fused(ta[:, None], tx[:, None], tg, tp)
    assert tm.mlp_block_plain.calls == before + 1 and tm.mlp_block_fused.launches == 0
    assert got.dtype == tx.dtype and got.shape == (M, 1, H)
    _close(got, want)


@pytest.mark.parametrize("dtype", ["int8", "fp8_e4m3"])
def test_mlp_block_ref_matches_jax_and_plain(dtype):
    jw, tw = _weights(dtype, seed=3)
    (ja, jx, jg), (ta, tx, tg) = _acts(8, "bf16", seed=4)
    _close(tm.mlp_block_ref(ta, tx, tg, *tw), jm.mlp_block_ref(ja, jx, jg, *jw))
    plain = tm.mlp_block_plain(ta, tx, tg, tm.pack_mlp(*tw, bn=128), eps=1e-5)
    ref = tm.mlp_block_ref(ta, tx, tg, *tw)
    np.testing.assert_allclose(plain.float().numpy(), ref.float().numpy(), rtol=5e-2, atol=5e-2)


def test_mlp_block_fused_refuses_prefill_shapes():
    _, tw = _weights("int8")
    tp = tm.pack_mlp(*tw, bn=128)
    _, (ta, tx, tg) = _acts(33, "f32")
    with pytest.raises(ValueError):
        tm.mlp_block_fused(ta, tx, tg, tp)


# ---------------------------------------------------------------------------
# The model path: pack_decode_mlp and _finish_attn's mlp_pack branch
# ---------------------------------------------------------------------------

V = 61


@pytest.fixture(scope="module")
def mlp_models():
    cfg = jl.LlamaConfig.tiny(vocab_size=V)
    jmodel = jl.Llama(cfg)
    raw = jmodel.init(jax.random.key(5), (1, 16))
    jq_ = jl.add_quantized_lm_head(j_qmp(jl.fuse_llama_projections(raw), "int8"))
    jp = jl.pack_decode_mlp(jq_, bn=128)
    tq_ = params_from_jax(jax.tree_util.tree_map(np.asarray, jq_), "cpu")
    return jmodel, jp, tl.Llama(tl.LlamaConfig.tiny(vocab_size=V), device="cpu"), tq_


def test_pack_decode_mlp_bytes_equal_jax(mlp_models):
    _, jp, _, tq_ = mlp_models
    tp = tl.pack_decode_mlp(tq_, bn=128)
    bridged = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    for i in range(2):
        mine, theirs = tp[f"h{i}"]["mlp_pack"], bridged[f"h{i}"]["mlp_pack"]
        assert isinstance(theirs, tm.MLPPack) and tuple(mine[2:]) == tuple(theirs[2:])
        assert torch.equal(mine.w, theirs.w) and torch.equal(mine.s, theirs.s)
    assert "mlp_pack" not in tl.pack_decode_mlp(tl.fuse_llama_projections(
        params_from_jax(jax.tree_util.tree_map(np.asarray, mlp_models[0].init(
            jax.random.key(5), (1, 16))), "cpu")))["h0"]


def test_model_mlp_pack_path_matches_jax(mlp_models):
    """A 5-token prefill (M 15 <= 32: the decode kernels, the MLP through
    mlp_block_fused) and three forward_with_cache decode steps."""
    jmodel, jp, tmodel, tq_ = mlp_models
    tp = tl.pack_decode_mlp(tq_, bn=128)
    rng = np.random.default_rng(6)
    Bm, P = 3, 5
    tokens = rng.integers(0, V, (Bm, P)).astype(np.int32)
    jc, tc = jmodel.init_kv_cache(Bm, 16, jnp.float32), tmodel.init_kv_cache(Bm, 16,
                                                                             torch.float32)
    before = tm.mlp_block_plain.calls, tdf.quant_linear_residual_plain.calls
    jlog, jc = jmodel.forward_with_cache(jp, jnp.asarray(tokens), jc, 0)
    tlog, tc = tmodel.forward_with_cache(tp, torch.from_numpy(tokens), tc, 0)
    _close(tlog, jlog)
    for step in range(3):
        tok = np.asarray(jnp.argmax(jlog[:, -1], -1)).astype(np.int32)[:, None]
        jlog, jc = jmodel.forward_with_cache(jp, jnp.asarray(tok), jc, P + step)
        tlog, tc = tmodel.forward_with_cache(tp, torch.from_numpy(tok), tc, P + step)
        _close(tlog, jlog)
        np.testing.assert_array_equal(tlog[:, -1].argmax(-1).numpy(),
                                      np.asarray(jnp.argmax(jlog[:, -1], -1)))
    assert tm.mlp_block_plain.calls - before[0] == 4 * 2  # every layer of every call
    assert tdf.quant_linear_residual_plain.calls == before[1]
