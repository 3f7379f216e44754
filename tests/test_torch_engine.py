"""The port's paged engine against the JAX engine, and its scheduling.

Tiny Llama int8, and fp8 e4m3 for the greedy tokens (f32 params, f32
pages, page_size 16, buckets (16, 32)),
identical bridged weights: six greedy requests with prompts of 3 to 25
tokens on four slots cover both buckets, admission waves and page
crossings. Greedy tokens must be equal. Only live rows are compared: the
JAX engine's free slots advance positions between rebuilds, the port's stay
at 0, and neither is ever read.
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
from mila_tpu_torch.models import llama as tl

V = 61
PROMPT_LENS = (3, 25, 9, 17, 12, 5)
NEW_TOKENS = (6, 10, 3, 12, 7, 9)


def _pair(wdt):
    cfg = jl.LlamaConfig.tiny(vocab_size=V)
    jmodel = jl.Llama(cfg)
    jparams = jmodel.init(jax.random.key(3), (1, 16))
    jparams = jl.add_quantized_lm_head(j_qmp(jl.fuse_llama_projections(jparams), wdt), wdt)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    tmodel = tl.Llama(tl.LlamaConfig.tiny(vocab_size=V), device="cpu")
    return jmodel, jparams, tmodel, tparams


@pytest.fixture(scope="module")
def pair():
    return _pair("int8")


def _config(cls, **kw):
    base = dict(max_batch=4, max_len=64, prefill_buckets=(16, 32), cache_dtype="float32",
                page_size=16)
    base.update(kw)
    return cls(**base)


def _prompts():
    rng = np.random.default_rng(7)
    return [rng.integers(0, V, n).astype(np.int32) for n in PROMPT_LENS]


def test_greedy_tokens_equal_jax_engine(pair):
    _check_greedy_tokens(*pair)


def test_greedy_tokens_equal_jax_engine_fp8():
    """The same requests over fp8 e4m3 weights and an fp8 head."""
    _check_greedy_tokens(*_pair("fp8_e4m3"))


def _check_greedy_tokens(jmodel, jparams, tmodel, tparams):
    jeng = JEngine(jmodel, jparams, _config(JEngineConfig, kv_layout="paged"))
    teng = InferenceEngine(tmodel, tparams, _config(EngineConfig), device="cpu")
    jreqs = [jeng.submit(p, max_new_tokens=n) for p, n in zip(_prompts(), NEW_TOKENS)]
    treqs = [teng.submit(p, max_new_tokens=n) for p, n in zip(_prompts(), NEW_TOKENS)]
    jeng.run()
    teng.run()
    for j, t, n in zip(jreqs, treqs, NEW_TOKENS):
        assert t.done and len(t.output) == n
        assert t.output == j.output, (t.id, t.output, j.output)
    assert teng.stats["prefills"] == jeng.stats["prefills"] == len(PROMPT_LENS)
    assert teng.alloc.free_pages == teng.alloc.num_pages - 1  # every page back


@pytest.fixture
def engine(pair):
    _, _, tmodel, tparams = pair

    def make(**kw):
        return InferenceEngine(tmodel, tparams, _config(EngineConfig, **kw), device="cpu")

    return make


def test_streaming_callback(engine):
    eng = engine(max_batch=2)
    seen = []
    req = eng.submit(np.array([5, 6], np.int32), max_new_tokens=5,
                     on_token=lambda r, t: seen.append((r.id, t)))
    eng.run()
    assert [t for _, t in seen] == req.output and len(req.output) == 5
    assert all(i == req.id for i, _ in seen)


def test_cancel_queued_and_active(engine):
    eng = engine(max_batch=1)
    r1 = eng.submit(np.array([1, 2], np.int32), max_new_tokens=40)
    r2 = eng.submit(np.array([3], np.int32), max_new_tokens=3)
    r3 = eng.submit(np.array([4], np.int32), max_new_tokens=3)
    r3.cancel()
    done = eng.step()  # r3 retired, r1 admitted and its first chunk decoded
    assert r3 in done and r3.output == [] and not r1.done
    r1.cancel()
    done = eng.run()
    assert r1 in done and r1.cancelled and r1.done
    assert r2.done and len(r2.output) == 3
    assert eng.stats["cancelled"] == 2
    assert eng.alloc.free_pages == eng.alloc.num_pages - 1


def test_priority_order(engine):
    eng = engine(max_batch=1)
    order = []
    r_low = eng.submit(np.array([1], np.int32), max_new_tokens=2, priority=5,
                       on_token=lambda r, t: order.append(r.id))
    r_hi = eng.submit(np.array([2], np.int32), max_new_tokens=2, priority=0,
                      on_token=lambda r, t: order.append(r.id))
    eng.run()
    assert order[0] == r_hi.id and set(order) == {r_low.id, r_hi.id}


def test_page_pressure_defers_admission(engine):
    # 5 usable pages of 16 tokens; each request reserves 2 (bucket 32 / final
    # length 19 + chunk) so only two run at once, the rest wait in the queue.
    eng = engine(num_pages=6)
    reqs = [eng.submit(np.arange(1, 20, dtype=np.int32) % V, max_new_tokens=4)
            for _ in range(4)]
    eng.step()
    assert sum(r.slot >= 0 for r in reqs) == 2
    eng.run()
    assert all(r.done and len(r.output) == 4 for r in reqs)
    assert eng.alloc.free_pages == 5


def test_sampled_requests_run(engine):
    from mila_tpu_torch.inference.sampling import SamplingConfig

    eng = engine()
    reqs = [eng.submit(np.array([1, 2, 3], np.int32), max_new_tokens=6,
                       sampling=SamplingConfig(temperature=t, top_k=k))
            for t, k in ((0.8, 0), (1.0, 5), (0.0, 0))]
    eng.run()
    assert all(len(r.output) == 6 and all(0 <= x < V for x in r.output) for r in reqs)


def test_unported_layouts_raise(pair):
    _, _, tmodel, tparams = pair
    # The giga decode of the contiguous layout is ported: giga params select it.
    eng = InferenceEngine(tmodel, {**tparams, "giga_pack": None},
                          EngineConfig(kv_layout="contiguous", max_len=64), device="cpu")
    assert eng._use_giga_decode() and eng.giga_pools is not None
    # Speculative decoding is ported: without a draft model it is refused.
    with pytest.raises(ValueError, match="draft"):
        InferenceEngine(tmodel, tparams, EngineConfig(speculative_k=2), device="cpu")


def test_engine_without_cuda_raises(pair):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, _, tmodel, tparams = pair
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine(tmodel, tparams, EngineConfig())
