"""The contiguous KV-cache protocol of the tiny Llama, and ``Generator``,
against the JAX package on identical bridged weights.

Variants: f32 params; int8 (fuse -> quantize -> quantized head), which
runs the decode kernels' plain paths and JAX's Pallas kernels in interpret
mode; int8 with ``pack_decode_layers(bn=128)``, whose decode steps take
``fused_decode_attention`` + ``layer_tail_stream`` (JAX: their CPU
references) and whose greedy step takes ``rms_quant_linear_argmax``; fp8
e4m3 with an fp8 head, unpacked and packed, in ``forward_with_cache`` and
``greedy_step_with_cache``.
Both sides run ``forward_with_cache`` (a 5-token prefill and 3 decode
steps), ``greedy_step_with_cache`` and ``forward_with_cache_ragged``; the
caches are compared after the steps. ``Generator.generate`` is compared
token for token (greedy, and greedy with an EOS token).

Tolerances: f32 logits and caches 1e-4 (summation order only); int8 and fp8 1e-2
of the largest logit (both sides round activations to bf16 before every
int8 product, and a last-ulp f32 difference can flip one such rounding).
Greedy tokens are compared exactly: at these seeds no row's top-two logit
margin is within that tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mila_tpu.inference.generator import Generator as JGenerator
from mila_tpu.inference.quantize import quantize_model_params as j_qmp
from mila_tpu.models import llama as jl
from mila_tpu_torch.bridge import params_from_jax
from mila_tpu_torch.inference.generator import Generator
from mila_tpu_torch.inference.sampling import SamplingConfig
from mila_tpu_torch.kernels import decode_fused as tdf
from mila_tpu_torch.models import llama as tl

V, B, T0, MAXLEN = 61, 3, 5, 16


@pytest.fixture(scope="module")
def models():
    cfg = jl.LlamaConfig.tiny(vocab_size=V)
    jmodel = jl.Llama(cfg)
    jparams = jmodel.init(jax.random.key(0), (1, 16))
    qparams = jl.add_quantized_lm_head(j_qmp(jl.fuse_llama_projections(jparams), "int8"))
    packed = jl.pack_decode_layers(qparams, bn=128)
    assert "layer_stream" in packed
    fparams = jl.add_quantized_lm_head(
        j_qmp(jl.fuse_llama_projections(jparams), "fp8_e4m3"), "fp8_e4m3")
    fpacked = jl.pack_decode_layers(fparams, bn=128)
    assert "layer_stream" in fpacked
    tmodel = tl.Llama(tl.LlamaConfig.tiny(vocab_size=V), device="cpu")
    out = {}
    for name, p in (("f32", jparams), ("int8", qparams), ("packed", packed),
                    ("fp8_e4m3", fparams), ("packed_fp8_e4m3", fpacked)):
        out[name] = (jmodel, p, tmodel, params_from_jax(jax.tree_util.tree_map(np.asarray, p),
                                                        "cpu"))
    return out


def _tol(ref, which):
    return 1e-4 if which == "f32" else 1e-2 * float(np.abs(ref).max())


def _close(got, want, which, msg=""):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=_tol(want, which),
                               err_msg=msg)


def test_port_packs_the_same_stream(models):
    _, _, _, tq = models["int8"]
    _, _, _, tp = models["packed"]
    mine = tl.pack_decode_layers(tq, bn=128)["layer_stream"]
    assert tuple(mine[4:]) == tuple(tp["layer_stream"][4:])
    for a, b in zip(mine[:4], tp["layer_stream"][:4]):
        assert torch.equal(a, b)
    assert "layer_stream" not in tl.pack_decode_layers(models["f32"][3])


def test_init_kv_cache_rounds_to_8(models):
    _, _, tmodel, _ = models["f32"]
    cache = tmodel.init_kv_cache(2, 13, torch.float32)
    assert len(cache) == 2 and cache["h1"]["v"].shape == (2, 16, 2, 32)


@pytest.mark.parametrize("which", ["f32", "int8", "packed", "fp8_e4m3",
                                   "packed_fp8_e4m3"])
def test_forward_with_cache_matches_jax(models, which):
    jmodel, jp, tmodel, tp = models[which]
    rng = np.random.default_rng(1)
    toks = rng.integers(0, V, (B, T0)).astype(np.int32)
    jcache = jmodel.init_kv_cache(B, MAXLEN, jnp.float32)
    tcache = tmodel.init_kv_cache(B, MAXLEN, torch.float32)
    jlog, jcache = jmodel.forward_with_cache(jp, jnp.asarray(toks), jcache, 0)
    tlog, tcache = tmodel.forward_with_cache(tp, torch.from_numpy(toks), tcache, 0)
    assert tlog.shape == (B, T0, V)
    _close(tlog, jlog, which, "prefill")
    for step in range(3):
        nxt = rng.integers(0, V, (B, 1)).astype(np.int32)
        jlog, jcache = jmodel.forward_with_cache(jp, jnp.asarray(nxt), jcache, T0 + step)
        tlog, tcache = tmodel.forward_with_cache(tp, torch.from_numpy(nxt), tcache, T0 + step)
        _close(tlog, jlog, which, f"decode step {step}")
    for i in range(2):
        for kv in ("k", "v"):
            _close(tcache[f"h{i}"][kv], jcache[f"h{i}"][kv], which, f"cache h{i}.{kv}")


def _prefilled(models, which, seed=2):
    jmodel, jp, tmodel, tp = models[which]
    toks = np.random.default_rng(seed).integers(0, V, (B, T0)).astype(np.int32)
    _, jcache = jmodel.forward_with_cache(jp, jnp.asarray(toks),
                                          jmodel.init_kv_cache(B, MAXLEN, jnp.float32), 0)
    _, tcache = tmodel.forward_with_cache(tp, torch.from_numpy(toks),
                                          tmodel.init_kv_cache(B, MAXLEN, torch.float32), 0)
    return jcache, tcache


@pytest.mark.parametrize("which", ["f32", "int8", "packed", "fp8_e4m3",
                                   "packed_fp8_e4m3"])
def test_greedy_step_with_cache_matches_jax(models, which):
    jmodel, jp, tmodel, tp = models[which]
    jcache, tcache = _prefilled(models, which)
    nxt = np.array([[7], [9], [1]], np.int32)
    jtok, jcache = jmodel.greedy_step_with_cache(jp, jnp.asarray(nxt), jcache, T0)
    before = tdf.rms_quant_linear_argmax_plain.calls
    ttok, tcache = tmodel.greedy_step_with_cache(tp, torch.from_numpy(nxt), tcache, T0)
    # The quantized head fuses the argmax; the f32 model argmaxes its logits.
    assert tdf.rms_quant_linear_argmax_plain.calls == before + (which != "f32")
    assert ttok.shape == (B, 1) and ttok.dtype == torch.int32
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    _close(tcache["h1"]["k"], jcache["h1"]["k"], which)


@pytest.mark.parametrize("which", ["f32", "int8", "packed"])
def test_forward_with_cache_ragged_matches_jax(models, which):
    jmodel, jp, tmodel, tp = models[which]
    jcache, tcache = _prefilled(models, which, seed=3)
    positions = np.array([5, 2, 4], np.int32)  # per-row insert positions
    nxt = np.array([[3], [8], [2]], np.int32)
    for step in range(2):
        jlog, jcache = jmodel.forward_with_cache_ragged(jp, jnp.asarray(nxt), jcache,
                                                        jnp.asarray(positions))
        tlog, tcache = tmodel.forward_with_cache_ragged(tp, torch.from_numpy(nxt), tcache,
                                                        torch.from_numpy(positions))
        assert tlog.shape == (B, 1, V)
        _close(tlog, jlog, which, f"ragged step {step}")
        positions = positions + 1
    _close(tcache["h0"]["v"], jcache["h0"]["v"], which)


def test_mega_pack_raises(models):
    """mega_pack params no longer raise: a decode step runs one megakernel
    per layer (held against JAX in tests/test_torch_layer_mega.py)."""
    from mila_tpu_torch.kernels import layer_mega as tmg

    _, _, tmodel, tp = models["int8"]
    params = tl.pack_decode_megalayers(tp, tmodel.config, bn=128)
    assert "mega_pack" in params["h0"] and "wqkv_slot" in params["h0"]
    cache = tmodel.init_kv_cache(B, MAXLEN, torch.float32)
    before = tmg.layer_megakernel_plain.calls
    logits, _ = tmodel.forward_with_cache(params, torch.zeros((B, 1), dtype=torch.int32),
                                          cache, 0)
    assert tmg.layer_megakernel_plain.calls == before + tmodel.config.num_layers
    assert logits.shape == (B, 1, V) and torch.isfinite(logits).all()


@pytest.mark.parametrize("which", ["f32", "int8"])
def test_generator_greedy_tokens_equal_jax(models, which):
    jmodel, jp, tmodel, tp = models[which]
    prompt = np.random.default_rng(4).integers(0, V, (2, 6)).astype(np.int32)
    want = np.asarray(JGenerator(jmodel, jp, max_len=32).generate(jnp.asarray(prompt), 8))
    got = Generator(tmodel, tp, max_len=32).generate(prompt, 8)
    assert got.shape == (2, 14) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # EOS masking: once a row emits eos it keeps emitting it.
    eos = int(want[0, 8])
    want_eos = np.asarray(JGenerator(jmodel, jp, max_len=32).generate(
        jnp.asarray(prompt), 8, eos_token=eos))
    got_eos = Generator(tmodel, tp, max_len=32).generate(prompt, 8, eos_token=eos)
    np.testing.assert_array_equal(got_eos.numpy(), want_eos)
    assert (got_eos.numpy()[0, 9:] == eos).all()


def test_generator_sampled_and_limits(models):
    _, _, tmodel, tp = models["int8"]
    gen = Generator(tmodel, tp, max_len=32)
    prompt = np.ones((2, 4), np.int32)
    g = torch.Generator().manual_seed(1)
    out = gen.generate(prompt, 6, generator=g, sampling=SamplingConfig(temperature=0.9, top_k=8))
    assert out.shape == (2, 10) and int(out.min()) >= 0 and int(out.max()) < V
    with pytest.raises(ValueError):
        gen.generate(prompt, 40)


@pytest.mark.parametrize("which", ["f32", "int8", "packed"])
def test_decode_step_bytes_matches_the_bench(models, which):
    from benchmarks.llama_bench import decode_step_bytes as j_bytes

    jmodel, jp, _, tp = models[which]
    want = j_bytes(jp, jmodel.config, 8, 512)
    got = tl.decode_step_bytes(tp, tl.LlamaConfig.tiny(vocab_size=V), 8, 512)
    assert got == want
