"""Tiny Llama: the port against the JAX model on identical bridged weights.

The JAX tiny Llama (hidden 128, 2 layers, f32 params) is initialised by
JAX, its params mapped to numpy and bridged into the port. Both sides then
run ``apply``, ``forward_paged_prefill`` and 4 steps of
``forward_paged_ragged`` on the same tokens and page tables, unquantized,
int8 and fp8 e4m3 (fuse -> quantize -> quantized head, fp8 with an fp8
head), which routes the quantized models through all three kernel entry
points' plain paths and JAX's Pallas kernels in interpret mode.

Tolerances: unquantized f32 differs by summation order only (atol 1e-4 on
logits of magnitude ~1). With int8 or fp8 weights both sides round activations to
bf16 before every product; a last-ulp f32 difference can flip one such
rounding, so we allow 1e-2 of the largest logit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mila_tpu.inference.quantize import quantize_model_params as j_qmp
from mila_tpu.models import llama as jl
from mila_tpu_torch.bridge import params_from_jax
from mila_tpu_torch.inference.quantize import quantize_model_params as t_qmp
from mila_tpu_torch.models import llama as tl

B, BUCKET, PS, STEPS = 3, 16, 8, 4
LENS = np.array([5, 16, 9], np.int32)


@pytest.fixture(scope="module")
def models():
    cfg = jl.LlamaConfig.tiny(vocab_size=61)
    jmodel = jl.Llama(cfg)
    jparams = jmodel.init(jax.random.key(0), (1, 16))
    qparams = jl.add_quantized_lm_head(j_qmp(jl.fuse_llama_projections(jparams), "int8"))
    fparams = jl.add_quantized_lm_head(
        j_qmp(jl.fuse_llama_projections(jparams), "fp8_e4m3"), "fp8_e4m3")
    tmodel = tl.Llama(tl.LlamaConfig.tiny(vocab_size=61), device="cpu")
    out = {}
    for name, p in (("f32", jparams), ("int8", qparams), ("fp8_e4m3", fparams)):
        npp = jax.tree_util.tree_map(np.asarray, p)
        out[name] = (jmodel, p, tmodel, params_from_jax(npp, "cpu"))
    return out


def _tol(ref, quant):
    return 1e-2 * float(np.abs(ref).max()) if quant else 1e-4


def test_bridge_carries_qtensor_fields(models):
    _, jp, _, tp = models["int8"]
    jq, tq = jp["h0"]["wqkv"]["weight"], tp["h0"]["wqkv"]["weight"]
    assert (tq.block_size, tq.packed_rows) == (jq.block_size, jq.packed_rows)
    np.testing.assert_array_equal(tq.q.numpy(), np.asarray(jq.q))
    np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jq.scale))
    assert tp["lm_head_q"].q.shape == (128, 2048)  # vocab padded to 2048


def test_fuse_and_quantize_in_the_port_match_jax(models):
    _, jp, _, _ = models["int8"]
    _, _, _, traw = models["f32"]
    tq = tl.add_quantized_lm_head(
        t_qmp(tl.fuse_llama_projections(traw), "int8", device="cpu"))
    for path in (("h1", "wgu", "weight"), ("h0", "wo", "weight"), ("lm_head_q",)):
        j, t = jp, tq
        for p in path:
            j, t = j[p], t[p]
        np.testing.assert_array_equal(t.q.numpy(), np.asarray(j.q))
        np.testing.assert_array_equal(t.scale.numpy(), np.asarray(j.scale))


@pytest.mark.parametrize("which", ["f32", "int8", "fp8_e4m3"])
def test_apply_matches_jax(models, which):
    jmodel, jp, tmodel, tp = models[which]
    toks = np.random.default_rng(0).integers(0, 61, (2, 12)).astype(np.int32)
    want = np.asarray(jmodel.apply(jp, jnp.asarray(toks)))
    got = tmodel.apply(tp, torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, atol=_tol(want, which != "f32"), rtol=0)


@pytest.mark.parametrize("which", ["f32", "int8", "fp8_e4m3"])
def test_paged_prefill_and_decode_match_jax(models, which):
    jmodel, jp, tmodel, tp = models[which]
    rng = np.random.default_rng(1)
    tokens = np.zeros((B, BUCKET), np.int32)
    for i, n in enumerate(LENS):
        tokens[i, :n] = rng.integers(0, 61, n)
    table = (1 + np.arange(B * 4)).reshape(B, 4).astype(np.int32)
    jpools = jmodel.init_paged_cache(num_pages=16, page_size=PS, dtype=jnp.float32)
    tpools = tmodel.init_paged_cache(num_pages=16, page_size=PS, dtype=torch.float32)
    jlog, jpools = jmodel.forward_paged_prefill(jp, jnp.asarray(tokens), jpools,
                                                jnp.asarray(table), jnp.asarray(LENS))
    tlog, tpools = tmodel.forward_paged_prefill(tp, torch.from_numpy(tokens), tpools,
                                                torch.from_numpy(table), torch.from_numpy(LENS))
    want = np.asarray(jlog)
    np.testing.assert_allclose(tlog.numpy(), want, atol=_tol(want, which != "f32"), rtol=0)
    for name in ("k", "v"):
        np.testing.assert_allclose(tpools[name].numpy(), np.asarray(jpools[name]),
                                   atol=_tol(np.asarray(jpools[name]), which != "f32"), rtol=0)
    pos = LENS.copy()
    for step in range(STEPS):
        nxt = rng.integers(0, 61, (B, 1)).astype(np.int32)
        jlog, jpools = jmodel.forward_paged_ragged(jp, jnp.asarray(nxt), jpools,
                                                   jnp.asarray(table), jnp.asarray(pos))
        tlog, tpools = tmodel.forward_paged_ragged(tp, torch.from_numpy(nxt), tpools,
                                                   torch.from_numpy(table), torch.from_numpy(pos))
        want = np.asarray(jlog)
        assert tlog.shape == want.shape == (B, 1, 61)
        np.testing.assert_allclose(tlog.numpy(), want, atol=_tol(want, which != "f32"),
                                   rtol=0, err_msg=f"decode step {step}")
        pos = pos + 1


def test_init_llama_params_layout():
    cfg = tl.LlamaConfig.tiny(vocab_size=61)
    gen = torch.Generator().manual_seed(0)
    p = tl.init_llama_params(cfg, gen, device="cpu")
    jp = jl.Llama(jl.LlamaConfig.tiny(vocab_size=61)).init(jax.random.key(0), (1, 16))
    jshapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jp)
    tshapes = {k: {n: {m: tuple(t.shape) for m, t in d.items()} for n, d in v.items()}
               if k.startswith("h") else {n: tuple(t.shape) for n, t in v.items()}
               for k, v in p.items()}
    assert tshapes == jshapes
    w = p["h0"]["wq"]["weight"]
    assert abs(float(w.std()) - 0.02) < 0.002 and float(p["norm_f"]["gamma"].min()) == 1.0


def test_llama_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tl.Llama(tl.LlamaConfig.tiny())
    with pytest.raises(RuntimeError, match="CUDA"):
        tl.init_llama_params(tl.LlamaConfig.tiny())
