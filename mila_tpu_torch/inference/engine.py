"""Inference engine: continuous batching over a paged or a contiguous KV
cache (port of ``mila_tpu/inference/engine.py``).

Two layouts share the engine logic:

- ``paged`` (``auto`` picks it when the model has the paged protocol):
  admission is gated on a worst-case page reservation; admitted requests
  prefill together, one call per prompt bucket, writing pages through the
  table; decode reads pages through the paged attention kernel.
- ``contiguous``: per-slot [max_batch, maxT] caches (``init_kv_cache``);
  each admitted request prefills alone at its bucket, writing its slot's
  rows in place (JAX runs the prefill on a one-row cache and merges it
  into the slot with a one-hot ``where``); decode runs
  ``forward_with_cache_ragged``, the dense or, with ``pack_decode_layers``
  params, the fused decode kernels. With ``giga_pack`` params (and a bf16
  cache of a multiple of 8 rows) decode runs ``giga_step``, the whole step
  as one kernel, over stacked [L, B, T, NKV*HD] pools; when every active
  slot is greedy its token is the kernel's own argmax and the logits are
  not read. The engine keeps one stacked allocation for the whole run and
  hands the prefill per-layer views of it, so the prefill writes the
  pools in place (JAX stacks the dict cache after each admission wave and
  folds it back before the next prefill; the values are the same).

Every engine step then decodes ``decode_chunk`` tokens for all active slots
in lock step, sampling on the device, with one device-to-host copy per
chunk. Slots that finish mid-chunk overshoot harmlessly; their pages are
reclaimed (paged) or their rows rewritten by the next prefill (contiguous).

Differences from the JAX engine: PyTorch runs eagerly, so the chunk is a
Python loop of forward calls where JAX traced a ``lax.scan``; rows without
a request keep their position frozen at 0 instead of advancing (their
writes go to the reserved page 0, or to row 0 of their own slot, and are
never read); random draws come from a ``torch.Generator``.

Speculative decoding (``speculative_k`` > 0, the paged layout): a draft
model with the contiguous protocol mirrors every prompt in its own bf16
cache (one draft forward over each prefill bucket group's rows), and each
engine step is one round for all active slots: the draft proposes k
tokens per row through ``forward_with_cache_ragged``, the target verifies
all of them in one ``forward_paged_chunk`` call, and each row emits its
accepted prefix and then the replacement or bonus token. Greedy rows
accept while the target's argmax agrees (their stream equals the
target-only stream); sampled rows run the rejection scheme of
speculative sampling (accept with min(1, p/q), replace the first
rejection by a draw from norm(relu(p - q)), a bonus draw when all k are
accepted). Unlike the JAX engine, the draft takes one more step per round
to write d_k's K/V (JAX's draft never writes that row when all k drafts
are accepted, so its next proposals read a stale row), and the rounds'
time counts in ``t_decode_s``.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from mila_tpu_torch.device import DeviceLike, resolve_device
from mila_tpu_torch.inference.kv_cache import PageAllocator
from mila_tpu_torch.inference.sampling import (
    SamplingConfig,
    categorical,
    sample_categorical,
    sample_logits,
)

CACHE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "int8": torch.int8}


@dataclasses.dataclass
class Request:
    id: int
    prompt: np.ndarray  # [T0] int32
    max_new_tokens: int
    sampling: SamplingConfig = dataclasses.field(default_factory=SamplingConfig)
    eos_token: Optional[int] = None
    priority: int = 0  # lower = served first; FIFO within a level
    on_token: Optional[Callable] = None  # called with (request, token_id)
    output: list = dataclasses.field(default_factory=list)
    done: bool = False
    cancelled: bool = False
    slot: int = -1
    submitted_at: float = 0.0
    first_token_at: float = 0.0
    finished_at: float = 0.0

    @property
    def ttft_s(self) -> float:
        return (self.first_token_at - self.submitted_at) if self.first_token_at else 0.0

    def cancel(self) -> None:
        """Request cancellation; the engine retires it at the next step."""
        self.cancelled = True


@dataclasses.dataclass
class EngineConfig:
    max_batch: int = 8
    max_len: int = 1024
    prefill_buckets: tuple = (32, 64, 128, 256, 512, 1024)
    cache_dtype: str = "bfloat16"
    decode_chunk: int = 8  # tokens decoded per step before one host fetch
    kv_layout: str = "auto"  # auto | paged | contiguous
    page_size: int = 128
    num_pages: int = 0  # 0 -> max_batch * ceil(max_len / page_size) + 1
    # Speculative decoding (paged layout): draft_model proposes speculative_k
    # tokens a round, the target verifies them in one forward_paged_chunk.
    speculative_k: int = 0  # 0 = off
    draft_model: Any = None
    draft_params: Any = None


class InferenceEngine:
    """Continuous-batching engine over a model with the paged protocol
    (``init_paged_cache``, ``forward_paged_prefill``, ``forward_paged_ragged``)
    or the contiguous one (``init_kv_cache``, ``forward_with_cache``,
    ``forward_with_cache_ragged``).

    Runs on ``device``: the GPU unless the caller passes ``device="cpu"``.
    """

    def __init__(self, model, params, config: Optional[EngineConfig] = None,
                 device: DeviceLike = None):
        self.model = model
        self.params = params
        self.config = c = config or EngineConfig()
        self.device = resolve_device(device)
        if getattr(model, "device", self.device).type != self.device.type:
            raise ValueError(f"model lives on {model.device}, engine on {self.device}")
        paged_capable = hasattr(model, "forward_paged_ragged")
        if c.kv_layout == "auto":
            self.kv_layout = "paged" if paged_capable else "contiguous"
        elif c.kv_layout == "paged" and not paged_capable:
            raise ValueError("model has no paged-forward protocol")
        elif c.kv_layout not in ("paged", "contiguous"):
            raise ValueError(f"unknown kv_layout {c.kv_layout!r}")
        else:
            self.kv_layout = c.kv_layout
        dt = CACHE_DTYPES[c.cache_dtype]
        if dt == torch.int8 and self.kv_layout != "paged":
            raise ValueError("int8 KV cache requires the paged layout")
        if self.kv_layout == "paged":
            ps = c.page_size
            num_pages = c.num_pages or (c.max_batch * -(-c.max_len // ps) + 1)
            self.pools = model.init_paged_cache(num_pages, ps, dt)
            self.alloc = PageAllocator(num_pages, ps, c.max_batch, c.max_len)
            self.num_pages_total = num_pages
            self.cache = None
        else:
            self.cache = model.init_kv_cache(c.max_batch, c.max_len, dt)
            self.pools = self.alloc = None
        self.spec_k = int(c.speculative_k or 0)
        if self.spec_k:
            if self.kv_layout != "paged":
                raise ValueError("speculative decoding requires the paged layout")
            if not hasattr(model, "forward_paged_chunk"):
                raise ValueError("model has no forward_paged_chunk (speculative verify)")
            if c.draft_model is None or c.draft_params is None:
                raise ValueError("speculative_k needs draft_model + draft_params")
            if c.draft_model.config.vocab_size != model.config.vocab_size:
                raise ValueError("draft/target vocab mismatch")
            self.draft_cache = c.draft_model.init_kv_cache(c.max_batch, c.max_len,
                                                           torch.bfloat16)
        self.giga_pools = None
        if self._use_giga_decode():
            # One stacked allocation; the dict cache becomes views of it.
            self.giga_pools = model.stack_kv_cache(self.cache)
            self.cache = model.unstack_kv_cache(*self.giga_pools)
        self._slots: list[Optional[Request]] = [None] * c.max_batch
        self._queue: list[Request] = []
        self._req_ids = itertools.count()
        self._positions = np.zeros((c.max_batch,), np.int32)
        self._last_token = np.zeros((c.max_batch,), np.int32)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(0)
        self._dev: Optional[dict] = None  # device-resident decode operands
        self._dev_dirty = True
        self.stats = {"steps": 0, "decode_iters": 0, "prefills": 0, "tokens_out": 0,
                      "cancelled": 0, "prefill_groups": 0, "t_prefill_s": 0.0,
                      "t_decode_s": 0.0, "prefill_by_bucket": {}, "spec_rounds": 0,
                      "spec_accepted": 0, "spec_proposed": 0}

    # ------------- public API -------------

    def submit(self, prompt, max_new_tokens: int = 64, sampling: Optional[SamplingConfig] = None,
               eos_token: Optional[int] = None, priority: int = 0,
               on_token: Optional[Callable] = None) -> Request:
        req = Request(id=next(self._req_ids), prompt=np.asarray(prompt, np.int32).reshape(-1),
                      max_new_tokens=max_new_tokens,
                      sampling=sampling or SamplingConfig(greedy=True), eos_token=eos_token,
                      priority=priority, on_token=on_token, submitted_at=time.monotonic())
        if len(req.prompt) + max_new_tokens + self._overshoot_margin() > self.config.max_len:
            raise ValueError("prompt + max_new_tokens exceeds engine max_len")
        if self.kv_layout == "paged":
            worst = self.alloc.pages_for(self._worst_len(req))
            if worst > self.num_pages_total - 1:
                raise ValueError(f"request needs {worst} KV pages; pool has "
                                 f"{self.num_pages_total - 1}")
        self._queue.append(req)
        self._queue.sort(key=lambda r: (r.priority, r.id))
        return req

    def has_work(self) -> bool:
        return bool(self._queue) or any(s is not None for s in self._slots)

    def run(self) -> list[Request]:
        """Drive until all submitted work completes; returns finished requests."""
        finished: list[Request] = []
        while self.has_work():
            finished.extend(self.step())
        return finished

    def step(self) -> list[Request]:
        """One iteration: retire cancellations, admit and prefill queued
        requests, one chunked decode for all active slots. Returns the
        requests finished in this step."""
        finished: list[Request] = []
        self._drop_cancelled(finished)
        self._admit(finished)
        active = [i for i, s in enumerate(self._slots) if s is not None]
        if not active:
            return finished
        if self.spec_k:
            self._spec_round(active, finished)
            return finished
        # Variable chunk: when every active slot is within `bound` tokens of
        # its cap, shrink the chunk to the next power of two >= bound.
        chunk = max(self.config.decode_chunk, 1)
        bound = max(self._slots[i].max_new_tokens - len(self._slots[i].output) for i in active)
        if 0 < bound < chunk:
            chunk = 1 << (bound - 1).bit_length()
        t0 = time.monotonic()
        if self.kv_layout == "paged":
            for i in active:
                self.alloc.ensure(i, int(self._positions[i]) + chunk)
        dev = self._device_operands()
        start_pos = self._positions.copy()
        toks_dev = self._decode_chunk(chunk, dev)
        toks = toks_dev.cpu().numpy()  # [B, chunk]: the one fetch per chunk
        self.stats["t_decode_s"] += time.monotonic() - t0
        self.stats["decode_iters"] += chunk
        for i in active:
            req = self._slots[i]
            for j in range(chunk):
                if req.done:
                    break
                self._emit(req, int(toks[i, j]))
                self._maybe_finish(req, finished)
            if self._slots[i] is not None:  # the cache advanced by the whole chunk
                self._positions[i] = int(start_pos[i]) + chunk
                self._last_token[i] = int(toks[i, chunk - 1])
        self.stats["steps"] += 1
        return finished

    # ------------- internals -------------

    def _bucket_for(self, n: int) -> int:
        for b in self.config.prefill_buckets:
            if n <= b and b <= self.config.max_len:
                return b
        raise ValueError(f"prompt length {n} exceeds buckets")

    def _overshoot_margin(self) -> int:
        """Cache positions can overshoot the last emitted token by a chunk,
        or by a speculative round's k drafts and its bonus token."""
        return max(self.config.decode_chunk, self.spec_k + 1, 1)

    def _worst_len(self, req: Request) -> int:
        """Most tokens a request can occupy: its prefill bucket, or its final
        length including chunk overshoot."""
        bucket = self._bucket_for(len(req.prompt))
        final = len(req.prompt) + req.max_new_tokens + self._overshoot_margin()
        return max(bucket, min(final, self.config.max_len))

    def _sampling_rows(self, reqs) -> tuple[np.ndarray, np.ndarray]:
        greedy = np.ones((self.config.max_batch,), bool)
        temps = np.ones((self.config.max_batch,), np.float32)
        for req in reqs:
            s = req.sampling
            greedy[req.slot] = s.greedy or s.temperature == 0.0
            temps[req.slot] = max(s.temperature, 1e-6)
        return greedy, temps

    def _use_giga_decode(self) -> bool:
        """The contiguous layout can decode with the whole-step giga kernel:
        the params carry a ``giga_pack``, the model has the stacked-pool
        protocol, and the cache is bf16 with a multiple of 8 rows (the
        kernel's rules)."""
        c = self.config
        return (self.kv_layout == "contiguous" and isinstance(self.params, dict)
                and "giga_pack" in self.params and hasattr(self.model, "giga_step")
                and hasattr(self.model, "stack_kv_cache") and c.max_len % 8 == 0
                and CACHE_DTYPES[c.cache_dtype] == torch.bfloat16)

    def _sample(self, logits: torch.Tensor, greedy: torch.Tensor, temps: torch.Tensor,
                all_greedy: bool, greedy_tok: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Greedy or temperature sampling on the device, [B, V] -> [B] int32.
        ``greedy_tok``: the argmax when the caller has it already."""
        logits = logits.float()
        if greedy_tok is None:
            greedy_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        if all_greedy:
            return greedy_tok
        sampled = sample_categorical(logits, temps, self._gen)
        return torch.where(greedy, greedy_tok, sampled)

    def _device_operands(self) -> dict:
        """Decode operands on the device, rebuilt only when slot state or the
        page table changed (not per chunk)."""
        if self._dev_dirty or self._dev is None:
            live = [s for s in self._slots if s is not None]
            greedy, temps = self._sampling_rows(live)
            active = np.array([s is not None for s in self._slots], np.int32)
            to_dev = lambda a: torch.from_numpy(a).to(self.device)  # noqa: E731
            self._dev = {
                "tok": to_dev(self._last_token[:, None].copy()),
                "pos": to_dev(self._positions.copy()),
                "active": to_dev(active),
                "greedy": to_dev(greedy),
                "temps": to_dev(temps),
                "all_greedy": bool(greedy.all()),
                "table_np": None,
                "table": None,
            }
            self._dev_dirty = False
        if self.kv_layout == "paged":
            tbl = self.alloc.table
            if self._dev["table_np"] is None or not np.array_equal(self._dev["table_np"], tbl):
                self._dev["table_np"] = tbl.copy()
                self._dev["table"] = torch.from_numpy(tbl.copy()).to(self.device)
        return self._dev

    def _decode_chunk(self, chunk: int, dev: dict) -> torch.Tensor:
        """``chunk`` lock-step decode steps on the device -> tokens [B, chunk]."""
        V = self.model.config.vocab_size
        toks, pos = dev["tok"], dev["pos"]
        out = torch.empty((self.config.max_batch, chunk), dtype=torch.int32,
                          device=self.device)
        for j in range(chunk):
            if self.giga_pools is not None:
                tok_g, logits, *self.giga_pools = self.model.giga_step(
                    self.params, toks, *self.giga_pools, pos)
                nxt = (tok_g[:, 0] if dev["all_greedy"] else
                       self._sample(logits[:, :V], dev["greedy"], dev["temps"], False,
                                    greedy_tok=tok_g[:, 0]))
            else:
                if self.kv_layout == "paged":
                    logits, self.pools = self.model.forward_paged_ragged(
                        self.params, toks, self.pools, dev["table"], pos)
                else:
                    logits, self.cache = self.model.forward_with_cache_ragged(
                        self.params, toks, self.cache, pos)
                nxt = self._sample(logits[:, -1, :V], dev["greedy"], dev["temps"],
                                   dev["all_greedy"])
            out[:, j] = nxt
            toks = nxt[:, None]
            pos = pos + dev["active"]
        dev["tok"], dev["pos"] = toks, pos
        return out

    # ---- speculative decoding (paged target, contiguous draft) ----

    def _draft_prefill(self, tokens: torch.Tensor, reqs: list) -> None:
        """The draft mirrors a bucket group's prompts in its cache: one draft
        forward over the group's rows of ``tokens`` [max_batch, bucket] and
        of the cache, whose results are written back to those rows (JAX runs
        the draft over every slot and keeps the other rows with a masked
        ``where``)."""
        c = self.config
        idx = torch.tensor([r.slot for r in reqs], device=self.device)
        rows = {n: {"k": lc["k"][idx], "v": lc["v"][idx]} for n, lc in self.draft_cache.items()}
        _, rows = c.draft_model.forward_with_cache(c.draft_params, tokens[idx], rows, 0)
        for n, lc in self.draft_cache.items():
            lc["k"][idx] = rows[n]["k"]
            lc["v"][idx] = rows[n]["v"]

    def _spec_verify(self, table, last, positions, greedy, temps, all_greedy: bool):
        """One batched round on the device: (n accepted [B], drafts [B, k],
        replacement or bonus token [B])."""
        c, k = self.config, self.spec_k
        V = self.model.config.vocab_size
        t1 = temps.clamp_min(1e-6)[:, None]
        toks, pos = last[:, None], positions
        d_toks, q_of_d, qs = [], [], []
        # 1. k proposals per row, and one more step that writes d_k's K/V.
        for i in range(k + 1):
            logits, self.draft_cache = c.draft_model.forward_with_cache_ragged(
                c.draft_params, toks, self.draft_cache, pos)
            if i == k:
                break
            logits = logits[:, -1, :V].float() / t1
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            if not all_greedy:
                q = torch.softmax(logits, dim=-1)
                nxt = torch.where(greedy, nxt, categorical(logits, self._gen))
                qs.append(q)
                q_of_d.append(q.gather(1, nxt[:, None].long())[:, 0])
            d_toks.append(nxt)
            toks, pos = nxt[:, None], pos + 1
        d = torch.stack(d_toks, dim=1)  # [B, k]
        # 2. one target verify over [last, d_1 .. d_k].
        t_logits, self.pools = self.model.forward_paged_chunk(
            self.params, torch.cat([last[:, None], d], dim=1), self.pools, table, positions)
        t_logits = t_logits[..., :V].float() / t1[..., None]
        t_arg = torch.argmax(t_logits, dim=-1).to(torch.int32)  # [B, k + 1]
        rows = torch.arange(d.shape[0], device=d.device)
        # 3. the accepted prefix per row; 4. the replacement or bonus token.
        acc = d == t_arg[:, :k]
        if all_greedy:
            n = torch.cumprod(acc.to(torch.int32), dim=1).sum(dim=1)
            return n, d, t_arg[rows, n]
        p = torch.softmax(t_logits, dim=-1)  # [B, k + 1, V]
        p_of_d = p[:, :k].gather(2, d[..., None].long())[..., 0]
        u = torch.rand((d.shape[0], k), generator=self._gen, device=d.device)
        acc_samp = u < p_of_d / torch.stack(q_of_d, dim=1).clamp_min(1e-20)
        n = torch.cumprod(torch.where(greedy[:, None], acc, acc_samp).to(torch.int32),
                          dim=1).sum(dim=1)
        p_n = p[rows, n]
        q_n = torch.stack(qs, dim=1)[rows, n.clamp_max(k - 1)]
        resid = (p_n - q_n).clamp_min(0.0)
        resid_ok = resid.sum(-1, keepdim=True) > 1e-12
        dist = torch.where((n == k)[:, None], p_n, torch.where(resid_ok, resid, p_n))
        t_samp = categorical(torch.log(dist.clamp_min(1e-30)), self._gen)
        return n, d, torch.where(greedy, t_arg[rows, n], t_samp)

    def _spec_round(self, active: list, finished: list) -> None:
        """One speculative round for the active slots: draft, verify, emit
        each row's accepted prefix and its replacement or bonus token."""
        k = self.spec_k
        t0 = time.monotonic()
        for i in active:
            self.alloc.ensure(i, int(self._positions[i]) + k + 1)
        greedy, temps = self._sampling_rows([self._slots[i] for i in active])
        to_dev = lambda a: torch.from_numpy(a.copy()).to(self.device)  # noqa: E731
        n, d, t_new = self._spec_verify(to_dev(self.alloc.table), to_dev(self._last_token),
                                        to_dev(self._positions), to_dev(greedy),
                                        to_dev(temps), bool(greedy.all()))
        out = torch.cat([n.to(torch.int32)[:, None], d, t_new[:, None].to(torch.int32)],
                        dim=1).cpu().numpy()  # the one fetch per round
        self.stats["t_decode_s"] += time.monotonic() - t0
        for i in active:
            req = self._slots[i]
            a = int(out[i, 0])
            emit = [int(x) for x in out[i, 1:1 + a]] + [int(out[i, 1 + k])]
            self.stats["spec_proposed"] += k
            self.stats["spec_accepted"] += a
            for t in emit:
                if req.done:
                    break
                self._emit(req, t)
                self._maybe_finish(req, finished)
            if self._slots[i] is not None:
                self._positions[i] = int(self._positions[i]) + a + 1
                self._last_token[i] = emit[-1]
        self.stats["spec_rounds"] += 1
        self.stats["steps"] += 1

    def _drop_cancelled(self, finished: list) -> None:
        still = []
        for r in self._queue:
            if r.cancelled:
                self._retire(r, finished)
            else:
                still.append(r)
        self._queue = still
        for req in list(self._slots):
            if req is not None and req.cancelled:
                self._retire(req, finished)

    def _admit(self, finished: list) -> None:
        """Fill free slots from the queue (priority order) and prefill them,
        one batched call per bucket. A request whose worst-case pages are
        not available stays queued until retirements free them."""
        admitted, skipped = [], []
        paged = self.kv_layout == "paged"
        while self._queue and any(s is None for s in self._slots):
            req = self._queue.pop(0)
            if paged and not self.alloc.can_admit(self._worst_len(req)):
                skipped.append(req)
                continue
            slot = next(i for i, s in enumerate(self._slots) if s is None)
            req.slot = slot
            self._slots[slot] = req
            if paged:
                self.alloc.reserve(slot, self._worst_len(req))
            admitted.append(req)
        if skipped:
            self._queue = sorted(skipped + self._queue, key=lambda r: (r.priority, r.id))
        if not paged:
            for req in admitted:
                self._contiguous_prefill(req, finished)
            return
        groups: dict[int, list[Request]] = {}
        for req in admitted:
            groups.setdefault(self._bucket_for(len(req.prompt)), []).append(req)
        for bucket, reqs in sorted(groups.items()):
            self._paged_prefill_group(bucket, reqs, finished)

    def _paged_prefill_group(self, bucket: int, reqs: list, finished: list) -> None:
        """Prefill same-bucket admissions in one call. Rows not being
        admitted get a zero page-table row: their writes land on page 0."""
        c = self.config
        tokens = np.zeros((c.max_batch, bucket), np.int32)
        table = np.zeros((c.max_batch, self.alloc.table_width), np.int32)
        true_len = np.zeros((c.max_batch,), np.int32)
        for req in reqs:
            T0 = len(req.prompt)
            self.alloc.ensure(req.slot, bucket)
            tokens[req.slot, :T0] = req.prompt
            table[req.slot] = self.alloc.table[req.slot]
            true_len[req.slot] = T0
        greedy, temps = self._sampling_rows(reqs)
        to_dev = lambda a: torch.from_numpy(a).to(self.device)  # noqa: E731
        t0 = time.monotonic()
        logits, self.pools = self.model.forward_paged_prefill(
            self.params, to_dev(tokens), self.pools, to_dev(table), to_dev(true_len))
        V = self.model.config.vocab_size
        toks_dev = self._sample(logits[:, :V], to_dev(greedy), to_dev(temps),
                                bool(greedy.all()))
        if self.spec_k:
            self._draft_prefill(to_dev(tokens), reqs)
        toks = toks_dev.cpu().numpy()  # the one small fetch per group
        self._count_prefill(bucket, time.monotonic() - t0)
        for req in reqs:
            T0 = len(req.prompt)
            self.alloc.trim(req.slot, T0)  # release bucket-padding pages
            s = req.sampling
            if s.top_k > 0 or s.top_p < 1.0:
                tok = int(sample_logits(logits[req.slot, :V], self._gen, s))
            else:
                tok = int(toks[req.slot])
            self._emit(req, tok)
            req.first_token_at = time.monotonic()
            self._positions[req.slot] = T0
            self._last_token[req.slot] = tok
            self._dev_dirty = True
            self.stats["prefills"] += 1
            self._maybe_finish(req, finished)

    def _contiguous_prefill(self, req: Request, finished: list) -> None:
        """Prefill one admission at its bucket into its own slot: the
        forward runs on views of the slot's cache rows, so its writes land
        in place."""
        T0 = len(req.prompt)
        bucket = self._bucket_for(T0)
        tokens = np.zeros((1, bucket), np.int32)
        tokens[0, :T0] = req.prompt
        s = req.slot
        rows = {name: {"k": lc["k"][s:s + 1], "v": lc["v"][s:s + 1]}
                for name, lc in self.cache.items()}
        t0 = time.monotonic()
        logits, _ = self.model.forward_with_cache(
            self.params, torch.from_numpy(tokens).to(self.device), rows, 0)
        V = self.model.config.vocab_size
        tok = int(sample_logits(logits[0, T0 - 1, :V], self._gen, req.sampling))
        self._count_prefill(bucket, time.monotonic() - t0)
        self._emit(req, tok)
        req.first_token_at = time.monotonic()
        self._positions[s] = T0
        self._last_token[s] = tok
        self._dev_dirty = True
        self.stats["prefills"] += 1
        self._maybe_finish(req, finished)

    def _count_prefill(self, bucket: int, seconds: float) -> None:
        """One prefill call: totals, and per bucket {"groups", "s"}."""
        self.stats["t_prefill_s"] += seconds
        self.stats["prefill_groups"] += 1
        per = self.stats["prefill_by_bucket"].setdefault(bucket, {"groups": 0, "s": 0.0})
        per["groups"] += 1
        per["s"] += seconds

    def _emit(self, req: Request, tok: int) -> None:
        req.output.append(tok)
        self.stats["tokens_out"] += 1
        if req.on_token is not None:
            req.on_token(req, tok)

    def _maybe_finish(self, req: Request, finished: list) -> None:
        hit_eos = req.eos_token is not None and req.output and req.output[-1] == req.eos_token
        if len(req.output) >= req.max_new_tokens or hit_eos or req.cancelled:
            self._retire(req, finished)

    def _retire(self, req: Request, finished: list) -> None:
        req.done = True
        req.finished_at = time.monotonic()
        self._dev_dirty = True
        if req.cancelled:
            self.stats["cancelled"] += 1
        finished.append(req)
        if req.slot >= 0 and self._slots[req.slot] is req:
            if self.kv_layout == "paged":
                self.alloc.release(req.slot)
            self._positions[req.slot] = 0
            self._last_token[req.slot] = 0
            self._slots[req.slot] = None
