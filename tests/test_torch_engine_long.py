"""The port's paged engine on the low-bit long-prompt path against the JAX
engine: int4 weights, int8 KV pages, prefill through flash attention.

A tiny Llama with head_dim 64 (hidden 256, 4 heads over 2 KV heads, so the
flash gate's D % 64 passes), fused, quantized to int4 with an int4 head,
``attention_impl="flash"`` on both sides: the 128- and 256-token prefill
buckets take the flash route (JAX's Pallas kernel in interpret mode, the
port's plain version on the CPU), decode reads int8 pages through the
paged attention (JAX's CPU oracle and the port's plain version, both
dequantizing the pages first) and the decode projections take the int4
route wherever its gate passes. Six greedy requests with prompts of 40 to
250 tokens on four slots cover both buckets, two admission waves and page
crossings. Greedy tokens must be equal.
"""

import dataclasses

import jax
import numpy as np
import pytest

from mila_tpu.inference.engine import EngineConfig as JEngineConfig
from mila_tpu.inference.engine import InferenceEngine as JEngine
from mila_tpu.inference.quantize import quantize_model_params as j_qmp
from mila_tpu.models import llama as jl
from mila_tpu_torch.bridge import params_from_jax
from mila_tpu_torch.inference.engine import EngineConfig, InferenceEngine
from mila_tpu_torch.kernels import flash_attention as tfa
from mila_tpu_torch.kernels import quant_matmul as tqm
from mila_tpu_torch.models import llama as tl

V = 61
PROMPT_LENS = (250, 40, 130, 97, 200, 64)
NEW_TOKENS = (6, 9, 4, 11, 5, 8)
WIDTHS = dict(hidden_size=256, intermediate_size=512, num_heads=4, num_kv_heads=2,
              max_seq_len=512, attention_impl="flash")


@pytest.fixture(scope="module")
def pair():
    jcfg = dataclasses.replace(jl.LlamaConfig.tiny(vocab_size=V), **WIDTHS)
    jmodel = jl.Llama(jcfg)
    raw = jmodel.init(jax.random.key(5), (1, 16))
    jparams = jl.add_quantized_lm_head(j_qmp(jl.fuse_llama_projections(raw), "int4"), "int4")
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    tmodel = tl.Llama(tl.LlamaConfig.tiny(vocab_size=V).replace(**WIDTHS), device="cpu")
    return jmodel, jparams, tmodel, tparams


def _config(cls):
    return cls(max_batch=4, max_len=320, prefill_buckets=(128, 256), cache_dtype="int8",
               page_size=32)


def test_int4_int8_flash_engine_tokens_equal_jax(pair):
    jmodel, jparams, tmodel, tparams = pair
    assert tmodel.config.hd == 64 and tparams["h0"]["wqkv"]["weight"].packed_rows == 256
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, V, n).astype(np.int32) for n in PROMPT_LENS]
    jeng = JEngine(jmodel, jparams, _config(JEngineConfig))
    teng = InferenceEngine(tmodel, tparams, _config(EngineConfig), device="cpu")
    assert "k_scale" in teng.pools and str(teng.pools["k"].dtype) == "torch.int8"
    flash0, int4_0 = tfa.flash_attention_plain.calls, tqm.quant_linear_int4_plain.calls
    jreqs = [jeng.submit(p, max_new_tokens=n) for p, n in zip(prompts, NEW_TOKENS)]
    treqs = [teng.submit(p, max_new_tokens=n) for p, n in zip(prompts, NEW_TOKENS)]
    jeng.run()
    teng.run()
    for j, t, n in zip(jreqs, treqs, NEW_TOKENS):
        assert t.done and len(t.output) == n
        assert t.output == j.output, (t.id, t.output, j.output)
    layers = tmodel.config.num_layers
    # Every prefill group attended through the flash route; decode went
    # through the int4 route (the down projection's K 512 passes its gate).
    assert tfa.flash_attention_plain.calls - flash0 == layers * teng.stats["prefill_groups"]
    assert tqm.quant_linear_int4_plain.calls - int4_0 >= layers * teng.stats["decode_iters"]
    assert teng.alloc.free_pages == teng.alloc.num_pages - 1
