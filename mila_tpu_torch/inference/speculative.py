"""Speculative decoding: a small draft model proposes k tokens, the target
verifies them in one forward (port of ``mila_tpu/inference/speculative.py``).

Decode at small batch reads the whole model per token, so verifying k draft
tokens in one target forward turns k weight streams into one. The
rejection scheme of speculative sampling: draft token i is accepted with
probability min(1, p_i / q_i); the first rejection is replaced by a draw
from norm(relu(p - q)); when all k are accepted a bonus token is drawn from
the target's (k+1)-th distribution. Greedy mode accepts while the target's
argmax agrees, which reproduces the target-only greedy stream exactly.

One round: k + 1 draft steps (the last only writes d_k's K/V into the
draft's cache), one target forward over [last, d_1 .. d_k], the acceptance
and the replacement or bonus token, then one small device-to-host copy of
(n_accepted, tokens). JAX jits the round and donates the caches; here it
runs eagerly and the caches are written in place. Both caches may hold K/V
past the accepted prefix; the next round's writes overwrite them before any
read (attention is masked to the true length), so the rewind is by position
only. Random draws come from one ``torch.Generator`` passed in (JAX splits
a key), so sampled tokens match JAX's in distribution only.

Batch 1 per generator: acceptance lengths differ per row (the engine's
speculative rounds batch ragged rows on its slots).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from mila_tpu_torch.inference.sampling import SamplingConfig, categorical


class SpeculativeGenerator:
    """Speculative decode of a target with a small draft. Both models are
    cache-capable (``init_kv_cache`` + ``forward_with_cache``), share the
    vocabulary and live on one device."""

    def __init__(self, target, target_params, draft, draft_params, *, k: int = 4,
                 max_len: int = 0, cache_dtype=None):
        if k < 1:
            raise ValueError("k must be >= 1")
        self.target = target
        self.target_params = target_params
        self.draft = draft
        self.draft_params = draft_params
        self.k = k
        self.max_len = max_len or min(target.config.max_seq_len,
                                      getattr(draft.config, "max_seq_len", 1 << 30))
        self.cache_dtype = cache_dtype or getattr(torch, target.config.param_dtype)
        self.vocab = min(target.config.vocab_size, draft.config.vocab_size)
        self.stats = {"rounds": 0, "accepted": 0, "proposed": 0}

    def _round(self, last: torch.Tensor, tcache: dict, dcache: dict, pos: int, greedy: bool,
               temp: float, gen: torch.Generator):
        """One round from ``last`` [1, 1] at ``pos`` (tokens in both caches):
        returns (n accepted, the k drafts then the replacement or bonus
        token: k + 1 ints)."""
        k, V = self.k, self.vocab
        tok, d_toks, qs = last, [], []
        for i in range(k + 1):  # step k + 1 only writes d_k's K/V
            logits, dcache = self.draft.forward_with_cache(self.draft_params, tok, dcache,
                                                           pos + i)
            logits = logits[:, -1, :V].float()
            if greedy:
                nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            else:
                qs.append(torch.softmax(logits / temp, dim=-1)[0])
                nxt = categorical(logits / temp, gen)
            d_toks.append(nxt)
            tok = nxt[:, None]
        d = torch.cat(d_toks[:k])  # [k]
        seq = torch.cat([last[0], d])[None]  # [1, k + 1]
        t_logits, tcache = self.target.forward_with_cache(self.target_params, seq, tcache, pos)
        p = torch.softmax(t_logits[0, :, :V].float() / temp, dim=-1)  # [k + 1, V]
        p_of_d = p[:k].gather(1, d[:, None].long())[:, 0]
        if greedy:
            acc = p_of_d >= p[:k].max(dim=-1).values  # d_i is the target's argmax
        else:
            q = torch.stack(qs[:k])  # [k, V]
            q_of_d = q.gather(1, d[:, None].long())[:, 0]
            u = torch.rand((k,), generator=gen, device=p.device)
            acc = u < p_of_d / q_of_d.clamp_min(1e-20)
        n = torch.cumprod(acc.to(torch.int32), dim=0).sum()
        p_n = p[n]  # rejected at draft n + 1: its distribution; n == k: the bonus
        if greedy:
            t_new = torch.argmax(p_n).to(torch.int32)
        else:
            resid = (p_n - q[torch.clamp(n, max=k - 1)]).clamp_min(0.0)
            dist = torch.where((n == k) | (resid.sum() <= 1e-12), p_n, resid)
            t_new = categorical(torch.log(dist.clamp_min(1e-30)), gen)
        out = torch.cat([n.to(torch.int32)[None], d, t_new.reshape(1)]).cpu().tolist()
        return out[0], out[1:]

    def generate(self, prompt, max_new_tokens: int, generator: Optional[torch.Generator] = None,
                 sampling: Optional[SamplingConfig] = None,
                 eos_token: Optional[int] = None) -> torch.Tensor:
        """prompt [1, T0] -> [1, T0 + max_new_tokens] int32 on the target's
        device. After ``eos_token`` the row keeps emitting it."""
        cfg = sampling or SamplingConfig(greedy=True)
        greedy = cfg.greedy or cfg.temperature == 0.0
        temp = max(cfg.temperature, 1e-6)
        dev = self.target.device
        if generator is None:
            generator = torch.Generator(device=dev)
            generator.manual_seed(0)
        if not isinstance(prompt, torch.Tensor):
            prompt = torch.from_numpy(np.asarray(prompt, np.int32))
        prompt = prompt.to(device=dev, dtype=torch.int32)
        B, T0 = prompt.shape
        if B != 1:
            raise ValueError("speculative generation is per-sequence (B=1)")
        if T0 + max_new_tokens + self.k + 2 > self.max_len:
            raise ValueError("prompt + max_new_tokens (+k) exceeds max_len")
        tcache = self.target.init_kv_cache(1, self.max_len, self.cache_dtype)
        dcache = self.draft.init_kv_cache(1, self.max_len, self.cache_dtype)
        logits, tcache = self.target.forward_with_cache(self.target_params, prompt, tcache, 0)
        _, dcache = self.draft.forward_with_cache(self.draft_params, prompt, dcache, 0)
        lf = logits[0, -1, : self.vocab].float()
        first = int(torch.argmax(lf)) if greedy else int(categorical(lf / temp, generator))
        emitted, pos, last = [first], T0, first
        while len(emitted) < max_new_tokens:
            n, out = self._round(torch.tensor([[last]], dtype=torch.int32, device=dev), tcache,
                                 dcache, pos, greedy, temp, generator)
            self.stats["rounds"] += 1
            self.stats["proposed"] += self.k
            self.stats["accepted"] += n
            for t in out[:n] + [out[self.k]]:
                emitted.append(t)
                if (eos_token is not None and t == eos_token) or len(emitted) >= max_new_tokens:
                    break
            if eos_token is not None and emitted[-1] == eos_token:
                break
            pos += n + 1
            last = emitted[-1]
        emitted = emitted[:max_new_tokens]
        if eos_token is not None and len(emitted) < max_new_tokens:
            emitted += [eos_token] * (max_new_tokens - len(emitted))
        tail = torch.tensor([emitted], dtype=torch.int32, device=dev)
        return torch.cat([prompt, tail], dim=1)

    @property
    def acceptance_rate(self) -> float:
        return self.stats["accepted"] / max(self.stats["proposed"], 1)
