"""Inference: sampling, KV-cache generation, speculative decoding, the
paged KV cache and the continuous-batching engine (port of
``mila_tpu/inference``)."""

from mila_tpu_torch.inference.sampling import SamplingConfig, sample_logits, sample_mult
from mila_tpu_torch.inference.generator import Generator
from mila_tpu_torch.inference.speculative import SpeculativeGenerator
from mila_tpu_torch.inference.kv_cache import PagedCacheConfig, PagedKVCache

__all__ = ["Generator", "PagedCacheConfig", "PagedKVCache", "SamplingConfig",
           "SpeculativeGenerator", "sample_logits", "sample_mult"]
