"""The engine's giga branch (contiguous layout, ``giga_pack`` params)
against the JAX engine, mirroring ``tests/inference/test_engine_giga.py``.

Two int8 models: the JAX test's (vocab 976, H 512, NH = NKV = 8, HD 64,
bn 512; the slot order is the identity) and one with G = 4 (vocab 184,
H 256, NH 8, NKV 2, HD 32, bn 64), identical weights bridged from JAX.
Greedy tokens of the port's giga engine must equal the JAX giga engine's
on the same prompts (live rows only: the JAX engine's free slots advance
their positions, the port's stay at 0, and neither is read). On the port
alone the giga engine must agree with the plain contiguous engine as the
JAX test requires of its own: equal first tokens and at most two
differing tokens in all (the giga stream and the per-layer path round in
different places and may flip a near-tie of random weights).
"""

import jax
import numpy as np
import pytest

from mila_tpu.inference.engine import EngineConfig as JEngineConfig
from mila_tpu.inference.engine import InferenceEngine as JEngine
from mila_tpu.inference.quantize import quantize_model_params as j_qmp
from mila_tpu.models import llama as jl
from mila_tpu_torch.bridge import params_from_jax
from mila_tpu_torch.inference.engine import EngineConfig, InferenceEngine
from mila_tpu_torch.inference.sampling import SamplingConfig
from mila_tpu_torch.kernels import decode_giga as tg
from mila_tpu_torch.kernels import dense_attention as tda
from mila_tpu_torch.models import llama as tl

# name: (vocab, H, I, NH, NKV, HD, bn)
SHAPES = {"g1": (976, 512, 1024, 8, 8, 64, 512), "g4": (184, 256, 512, 8, 2, 32, 64)}
PROMPTS = (np.arange(1, 8, dtype=np.int32), np.arange(3, 15, dtype=np.int32))


def _cfg(mod, name):
    V, H, I, NH, NKV, HD, _ = SHAPES[name]
    return mod.LlamaConfig(name=f"llama-engine-giga-{name}", vocab_size=V, hidden_size=H,
                           intermediate_size=I, num_layers=2, num_heads=NH, num_kv_heads=NKV,
                           head_dim=HD, max_seq_len=128, rope_theta=10000.0,
                           param_dtype="float32")


@pytest.fixture(scope="module", params=list(SHAPES))
def giga_pair(request):
    name = request.param
    bn = SHAPES[name][6]
    cfg = _cfg(jl, name)
    jmodel = jl.Llama(cfg)
    raw = jmodel.init(jax.random.key(0), (1, 8))
    jq_ = jl.add_quantized_lm_head(j_qmp(jl.fuse_llama_projections(raw), "int8"), "int8",
                                   pad_to=bn)
    jp = jl.pack_decode_giga(jq_, cfg, bn=bn)
    assert "giga_pack" in jp
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    tmodel = tl.Llama(_cfg(tl, name), device="cpu")
    return name, jmodel, jp, tmodel, tp


def _config(cls, **kw):
    base = dict(max_batch=2, max_len=64, prefill_buckets=(16,), kv_layout="contiguous",
                decode_chunk=4)
    base.update(kw)
    return cls(**base)


def _serve(engine, prompts, new=6, **kw):
    reqs = [engine.submit(p, max_new_tokens=new, **kw) for p in prompts]
    engine.run()
    return [r.output for r in reqs]


def test_engine_selects_giga_decode(giga_pair):
    _, _, _, tmodel, tp = giga_pair
    eng = InferenceEngine(tmodel, tp, _config(EngineConfig), device="cpu")
    assert eng._use_giga_decode() and eng.giga_pools is not None
    kp = eng.giga_pools[0]
    assert kp.shape == (2, 2, 64, tmodel.config.num_kv_heads * tmodel.config.hd)
    assert eng.cache["h1"]["k"].data_ptr() == kp[1].data_ptr()  # the prefill writes the pools
    for kw in ({"max_len": 60}, {"cache_dtype": "float32"}):
        assert not InferenceEngine(tmodel, tp, _config(EngineConfig, **kw),
                                   device="cpu")._use_giga_decode()
    plain = {k: v for k, v in tp.items() if k != "giga_pack"}
    assert not InferenceEngine(tmodel, plain, _config(EngineConfig), device="cpu").giga_pools


def test_engine_giga_matches_jax_giga_engine(giga_pair):
    _, jmodel, jp, tmodel, tp = giga_pair
    jeng = JEngine(jmodel, jp, _config(JEngineConfig))
    assert jeng._use_giga_decode()
    want = _serve(jeng, PROMPTS)
    teng = InferenceEngine(tmodel, tp, _config(EngineConfig), device="cpu")
    before = tg.giga_decode_plain.calls, tda.fused_decode_attention_plain.calls
    got = _serve(teng, PROMPTS)
    assert got == want
    assert tg.giga_decode_plain.calls - before[0] == teng.stats["decode_iters"]
    assert tda.fused_decode_attention_plain.calls == before[1]


def test_engine_giga_matches_plain_contiguous(giga_pair):
    _, _, _, tmodel, tp = giga_pair
    giga = _serve(InferenceEngine(tmodel, tp, _config(EngineConfig), device="cpu"), PROMPTS)
    plain = {k: v for k, v in tp.items() if k != "giga_pack"}
    ref = _serve(InferenceEngine(tmodel, plain, _config(EngineConfig), device="cpu"), PROMPTS)
    total = agree = 0
    for g, p in zip(giga, ref):
        assert g[0] == p[0]
        total += len(g)
        agree += sum(a == b for a, b in zip(g, p))
    assert agree >= total - 2, (giga, ref)


def test_engine_giga_serves_waves_and_samples(giga_pair):
    """Three requests on two slots (a second admission wave writes the
    pools through the views) with one sampling request among them."""
    name, _, _, tmodel, tp = giga_pair
    V = SHAPES[name][0]
    eng = InferenceEngine(tmodel, tp, _config(EngineConfig), device="cpu")
    rng = np.random.default_rng(0)
    reqs = [eng.submit(rng.integers(0, V, n).astype(np.int32), max_new_tokens=8,
                       sampling=SamplingConfig(greedy=i != 1, temperature=0.8))
            for i, n in enumerate((5, 11, 9))]
    eng.run()
    for r in reqs:
        assert r.done and len(r.output) == 8
        assert all(0 <= t < V for t in r.output)
