"""Autoregressive generation over the contiguous KV cache (port of
``mila_tpu/inference/generator.py``).

One prefill of the whole prompt through ``forward_with_cache``, then one
``forward_with_cache`` step per new token; the cache is written in place.
JAX jits the step and donates the cache; PyTorch runs it eagerly. Random
draws come from a ``torch.Generator`` (JAX splits a ``jax.random`` key), so
sampled tokens match JAX's in distribution only; greedy tokens match
exactly.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from mila_tpu_torch.inference.sampling import SamplingConfig, sample_logits

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class Generator:
    """Wraps a cache-capable model (``init_kv_cache`` + ``forward_with_cache``)
    for incremental decoding on the model's device."""

    def __init__(self, model, params, max_len: int = 0, cache_dtype=None):
        self.model = model
        self.params = params
        self.max_len = max_len or model.config.max_seq_len
        self.cache_dtype = cache_dtype or _DTYPES[model.config.param_dtype]

    def generate(self, prompt, max_new_tokens: int,
                 generator: Optional[torch.Generator] = None,
                 sampling: Optional[SamplingConfig] = None,
                 eos_token: Optional[int] = None) -> torch.Tensor:
        """prompt [B, T0] int32 -> [B, T0 + max_new_tokens] int32. A row that
        emitted ``eos_token`` keeps emitting it (shapes stay fixed, as in
        JAX)."""
        cfg = sampling or SamplingConfig(greedy=True)
        dev = self.model.device
        if generator is None:
            generator = torch.Generator(device=dev)
            generator.manual_seed(0)
        if not isinstance(prompt, torch.Tensor):
            prompt = torch.from_numpy(np.asarray(prompt, np.int32))
        prompt = prompt.to(device=dev, dtype=torch.int32)
        B, T0 = prompt.shape
        if T0 + max_new_tokens > self.max_len:
            raise ValueError(f"prompt {T0} + new {max_new_tokens} exceeds cache {self.max_len}")
        V = self.model.config.vocab_size
        cache = self.model.init_kv_cache(B, self.max_len, self.cache_dtype)
        logits, cache = self.model.forward_with_cache(self.params, prompt, cache, 0)
        token = sample_logits(logits[:, -1, :V], generator, cfg)[:, None]
        out = [prompt, token]
        done = torch.zeros((B, 1), dtype=torch.bool, device=dev) if eos_token is not None else None
        for i in range(1, max_new_tokens):
            logits, cache = self.model.forward_with_cache(self.params, token, cache, T0 + i - 1)
            nxt = sample_logits(logits[:, -1, :V], generator, cfg)[:, None]
            if eos_token is not None:
                done = done | (token == eos_token)
                nxt = torch.where(done, torch.full_like(nxt, eos_token), nxt)
            token = nxt
            out.append(token)
        return torch.cat(out, dim=1)
