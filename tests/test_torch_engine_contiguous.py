"""The port's engine with ``kv_layout="contiguous"`` against the JAX engine.

Tiny Llama int8 (f32 params and cache, buckets (16, 32)), identical bridged
weights, unpacked and with ``pack_decode_layers(bn=128)`` (the decode then
runs ``fused_decode_attention`` + ``layer_tail_stream``): six greedy
requests with prompts of 3 to 25 tokens on four slots, so admission comes
in waves and slots are reused. Greedy tokens must be equal. Only live rows
are compared: the JAX engine's free slots advance their positions between
rebuilds, the port's stay at 0, and neither is ever read.
"""

import jax
import numpy as np
import pytest
import torch

from mila_tpu.inference.engine import EngineConfig as JEngineConfig
from mila_tpu.inference.engine import InferenceEngine as JEngine
from mila_tpu.inference.quantize import quantize_model_params as j_qmp
from mila_tpu.models import llama as jl
from mila_tpu_torch.bridge import params_from_jax
from mila_tpu_torch.inference.engine import EngineConfig, InferenceEngine
from mila_tpu_torch.inference.sampling import SamplingConfig
from mila_tpu_torch.models import llama as tl

V = 61
PROMPT_LENS = (3, 25, 9, 17, 12, 5)
NEW_TOKENS = (6, 10, 3, 12, 7, 9)


@pytest.fixture(scope="module")
def pair():
    cfg = jl.LlamaConfig.tiny(vocab_size=V)
    jmodel = jl.Llama(cfg)
    jparams = jmodel.init(jax.random.key(3), (1, 16))
    jparams = jl.add_quantized_lm_head(j_qmp(jl.fuse_llama_projections(jparams), "int8"))
    tmodel = tl.Llama(tl.LlamaConfig.tiny(vocab_size=V), device="cpu")
    out = {}
    for name, p in (("int8", jparams), ("packed", jl.pack_decode_layers(jparams, bn=128))):
        out[name] = (jmodel, p, tmodel, params_from_jax(jax.tree_util.tree_map(np.asarray, p),
                                                        "cpu"))
    return out


def _config(cls, **kw):
    base = dict(max_batch=4, max_len=64, prefill_buckets=(16, 32), cache_dtype="float32",
                kv_layout="contiguous")
    base.update(kw)
    return cls(**base)


def _prompts():
    rng = np.random.default_rng(7)
    return [rng.integers(0, V, n).astype(np.int32) for n in PROMPT_LENS]


@pytest.mark.parametrize("which", ["int8", "packed"])
def test_greedy_tokens_equal_jax_engine(pair, which):
    jmodel, jparams, tmodel, tparams = pair[which]
    jeng = JEngine(jmodel, jparams, _config(JEngineConfig))
    teng = InferenceEngine(tmodel, tparams, _config(EngineConfig), device="cpu")
    assert teng.kv_layout == "contiguous" and teng.pools is None
    jreqs = [jeng.submit(p, max_new_tokens=n) for p, n in zip(_prompts(), NEW_TOKENS)]
    treqs = [teng.submit(p, max_new_tokens=n) for p, n in zip(_prompts(), NEW_TOKENS)]
    jeng.run()
    teng.run()
    for j, t, n in zip(jreqs, treqs, NEW_TOKENS):
        assert t.done and len(t.output) == n
        assert t.output == j.output, (t.id, t.output, j.output)
    assert teng.stats["prefills"] == jeng.stats["prefills"] == len(PROMPT_LENS)
    assert teng.stats["prefill_groups"] == len(PROMPT_LENS)  # one call per admission
    assert all(s is None for s in teng._slots) and not teng._positions.any()


def test_streaming_cancel_and_sampling(pair):
    _, _, tmodel, tparams = pair["int8"]
    eng = InferenceEngine(tmodel, tparams, _config(EngineConfig, max_batch=2), device="cpu")
    seen = []
    r1 = eng.submit(np.array([5, 6], np.int32), max_new_tokens=5,
                    on_token=lambda r, t: seen.append(t))
    r2 = eng.submit(np.array([1, 2, 3], np.int32), max_new_tokens=30)
    r3 = eng.submit(np.array([4], np.int32), max_new_tokens=6,
                    sampling=SamplingConfig(temperature=0.8, top_k=5))
    eng.step()
    r2.cancel()
    eng.run()
    assert seen == r1.output and len(r1.output) == 5
    assert r2.cancelled and r2.done and len(r2.output) < 30
    assert len(r3.output) == 6 and all(0 <= t < V for t in r3.output)
    assert eng.stats["cancelled"] == 1


def test_layout_choice_and_refusals(pair):
    _, _, tmodel, tparams = pair["int8"]
    auto = InferenceEngine(tmodel, tparams, _config(EngineConfig, kv_layout="auto"), device="cpu")
    assert auto.kv_layout == "paged"  # the model has the paged protocol
    with pytest.raises(ValueError, match="int8 KV cache"):
        InferenceEngine(tmodel, tparams, _config(EngineConfig, cache_dtype="int8"), device="cpu")
    with pytest.raises(NotImplementedError, match="row 10"):
        InferenceEngine(tmodel, {**tparams, "giga_pack": None}, _config(EngineConfig),
                        device="cpu")
    with pytest.raises(ValueError):
        InferenceEngine(tmodel, tparams, _config(EngineConfig, kv_layout="ring"), device="cpu")


def test_contiguous_engine_without_cuda_raises(pair):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, _, tmodel, tparams = pair["int8"]
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine(tmodel, tparams, EngineConfig(kv_layout="contiguous"))
