"""Paged KV cache: page pools, page-table writes and reads, host allocator
(port of ``mila_tpu/inference/kv_cache.py``).

Pools are [L, P, NKV, HD, ps]: page-major with token-minor pages, so one
page of one KV head is a contiguous [HD, ps] slab for the decode kernel.
Unlike the JAX package, whose arrays are immutable, writes here update the
pools in place (the engine owns them; this saves a pool copy per step).

``PagedCacheConfig`` and ``PagedKVCache`` are the JAX package's standalone
page pool (slots, page growth, writes, a gather read for oracles), here a
thin view over the engine's pools and ``PageAllocator``: JAX keeps a second,
token-major page layout [L, P, ps, NKV, HD] for it, the port does not.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mila_tpu_torch.device import DeviceLike, resolve_device

from mila_tpu_torch.kernels.paged_attention import (  # noqa: F401 (re-export)
    paged_decode_attention,
    paged_decode_attention_ref,
)


@dataclasses.dataclass
class PagedCacheConfig:
    num_layers: int
    num_kv_heads: int
    head_dim: int
    page_size: int = 128
    num_pages: int = 512
    max_seqs: int = 8
    dtype: str = "bfloat16"

    @property
    def pages_per_seq(self) -> int:
        return self.num_pages  # upper bound; table rows are this wide

    def hbm_bytes(self) -> int:
        """Bytes of the K and V pools together."""
        per = (self.num_layers * self.num_pages * self.page_size * self.num_kv_heads
               * self.head_dim * getattr(torch, self.dtype).itemsize)
        return 2 * per


def kv_quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 over the trailing (head_dim) axis: one scale per
    (token, head)."""
    x32 = x.float()
    amax = x32.abs().amax(dim=-1)
    scale = torch.clamp_min(amax / 127.0, 1e-8)
    q = torch.round(x32 / scale[..., None]).to(torch.int8)
    return q, scale


def make_paged_pools(num_layers: int, num_kv_heads: int, head_dim: int,
                     num_pages: int, page_size: int, dtype, device) -> dict:
    """Page pools [L, P, NKV, HD, ps]; int8 pools carry scale planes
    [L, P, NKV, ps]."""
    shape = (num_layers, num_pages, num_kv_heads, head_dim, page_size)
    pools = {"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
    if dtype == torch.int8:
        sshape = (num_layers, num_pages, num_kv_heads, page_size)
        pools["k_scale"] = torch.zeros(sshape, dtype=torch.float32, device=device)
        pools["v_scale"] = torch.zeros(sshape, dtype=torch.float32, device=device)
    return pools


def _token_major(pool: torch.Tensor, layer: int) -> torch.Tensor:
    """View of one layer's pool as [P, ps, ...]: the indexed (page, offset)
    dims adjacent and first, as JAX's ``.at[layer, ids, :, :, offs]`` lays
    them out (advanced indices split by slices move to the front)."""
    view = pool[layer]
    return view.permute(0, view.ndim - 1, *range(1, view.ndim - 1))


def paged_scatter(pools: dict, layer: int, page_ids, offs, k, v) -> dict:
    """Write new K/V through the page table, in place. ``page_ids``/``offs``
    are index tensors with k/v's leading dims ([B] for decode, [B, T] for
    prefill); k/v are [..., NKV, HD]."""
    page_ids = page_ids.long()
    offs = offs.long()
    if "k_scale" in pools:
        qk, sk = kv_quantize(k)
        qv, sv = kv_quantize(v)
        _token_major(pools["k"], layer)[page_ids, offs] = qk
        _token_major(pools["v"], layer)[page_ids, offs] = qv
        _token_major(pools["k_scale"], layer)[page_ids, offs] = sk
        _token_major(pools["v_scale"], layer)[page_ids, offs] = sv
        return pools
    _token_major(pools["k"], layer)[page_ids, offs] = k.to(pools["k"].dtype)
    _token_major(pools["v"], layer)[page_ids, offs] = v.to(pools["v"].dtype)
    return pools


def paged_attention_read(pools: dict, layer: int, q, page_table, seq_lens):
    """Decode-attention read of one layer's pages (dequantizing if int8)."""
    return paged_decode_attention(
        q, pools["k"][layer], pools["v"][layer], page_table, seq_lens,
        k_scale=pools["k_scale"][layer] if "k_scale" in pools else None,
        v_scale=pools["v_scale"][layer] if "v_scale" in pools else None,
    )


class PageAllocator:
    """Host-side page allocator for the engine's paged decode path.

    Page 0 is reserved as a garbage page: table rows of inactive slots point
    at it, so the lock-step decode's K/V writes from finished or empty rows
    land somewhere harmless and are never read. ``first_page`` 0 hands out
    every page (``PagedKVCache``, which has no lock-step writes).
    """

    def __init__(self, num_pages: int, page_size: int, max_slots: int, max_len: int,
                 first_page: int = 1):
        if num_pages < first_page + 1:
            raise ValueError(f"need at least {first_page + 1} pages ({first_page} reserved)")
        self.page_size = page_size
        self.num_pages = num_pages
        self.table_width = -(-max_len // page_size)
        self._free = list(range(num_pages - 1, first_page - 1, -1))
        self.table = np.zeros((max_slots, self.table_width), np.int32)
        self._used = np.zeros((max_slots,), np.int32)
        # Worst-case page promises per slot (admission gating).
        self._reserved = np.zeros((max_slots,), np.int32)

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def available_pages(self) -> int:
        """Free pages not promised to an active slot's future growth."""
        pending = int(np.maximum(self._reserved - self._used, 0).sum())
        return len(self._free) - pending

    def pages_for(self, length: int) -> int:
        return -(-length // self.page_size)

    def can_admit(self, worst_len: int) -> bool:
        need = self.pages_for(worst_len)
        return need <= self.table_width and need <= self.available_pages

    def reserve(self, slot: int, worst_len: int) -> None:
        if not self.can_admit(worst_len):
            raise RuntimeError(f"cannot reserve {self.pages_for(worst_len)} pages "
                               f"({self.available_pages} available)")
        self._reserved[slot] = self.pages_for(worst_len)

    def ensure(self, slot: int, new_len: int) -> None:
        """Grow the slot's page list to cover ``new_len`` tokens."""
        need = self.pages_for(new_len)
        if need > self.table_width:
            raise RuntimeError(f"length {new_len} exceeds table width")
        while self._used[slot] < need:
            if not self._free:
                raise RuntimeError("KV page pool exhausted")
            self.table[slot, self._used[slot]] = self._free.pop()
            self._used[slot] += 1

    def trim(self, slot: int, keep_len: int) -> None:
        """Release pages beyond ``keep_len`` tokens (bucket padding); the
        slot's reservation stays."""
        keep = self.pages_for(keep_len)
        while self._used[slot] > keep:
            self._used[slot] -= 1
            idx = int(self._used[slot])
            self._free.append(int(self.table[slot, idx]))
            self.table[slot, idx] = 0

    def release(self, slot: int) -> None:
        self.trim(slot, 0)
        self._reserved[slot] = 0


class PagedKVCache:
    """A page pool with its host allocator state: the engine's pools
    (``make_paged_pools``, on ``device``: the GPU unless the caller passes
    ``"cpu"``) written in place through ``paged_scatter``, and a
    ``PageAllocator`` that hands out every page; the page table, lengths
    and free list are numpy."""

    def __init__(self, config: PagedCacheConfig, max_len: int = 0,
                 device: DeviceLike = None):
        c = config
        self.config = c
        self.device = resolve_device(device)
        self.max_len = max_len or (c.num_pages // c.max_seqs) * c.page_size
        self.alloc = PageAllocator(c.num_pages, c.page_size, c.max_seqs, self.max_len,
                                   first_page=0)
        self.table_width = self.alloc.table_width
        self.pools = make_paged_pools(c.num_layers, c.num_kv_heads, c.head_dim, c.num_pages,
                                      c.page_size, getattr(torch, c.dtype), self.device)
        self.seq_lens = np.zeros((c.max_seqs,), np.int32)
        self._active = np.zeros((c.max_seqs,), bool)

    @property
    def page_table(self) -> np.ndarray:
        return self.alloc.table

    @property
    def free_pages(self) -> int:
        return self.alloc.free_pages

    def allocate_slot(self, length_hint: int = 0) -> int:
        """Claim a sequence slot."""
        for s in range(self.config.max_seqs):
            if not self._active[s]:
                self._active[s] = True
                self.seq_lens[s] = 0
                return s
        raise RuntimeError("no free sequence slots")

    def free_slot(self, slot: int) -> None:
        self.alloc.release(slot)
        self.seq_lens[slot] = 0
        self._active[slot] = False

    def ensure_capacity(self, slot: int, new_len: int) -> None:
        """Grow the slot's page list to cover ``new_len`` tokens."""
        if new_len > self.max_len:
            raise RuntimeError(f"sequence length {new_len} exceeds max {self.max_len}")
        self.alloc.ensure(slot, new_len)

    def write_tokens(self, slot: int, layer_kv: list, start_pos: int) -> None:
        """Write new K/V of one slot from ``start_pos``: layer_kv[l] = (k, v),
        each [T, NKV, HD] (the pages need not be adjacent)."""
        T = layer_kv[0][0].shape[0]
        self.ensure_capacity(slot, start_pos + T)
        pos = torch.arange(start_pos, start_pos + T)
        ps = self.config.page_size
        ids = torch.from_numpy(self.page_table[slot])[pos // ps].to(self.device)
        offs = (pos % ps).to(self.device)
        for layer, (k, v) in enumerate(layer_kv):
            paged_scatter(self.pools, layer, ids, offs, k.to(self.device), v.to(self.device))
        self.seq_lens[slot] = max(int(self.seq_lens[slot]), start_pos + T)

    def gather_kv(self, layer: int, slots) -> tuple[torch.Tensor, torch.Tensor]:
        """Contiguous [B, W * ps, NKV, HD] K and V of the given slots (the
        oracle's read path)."""
        table = torch.from_numpy(self.page_table[np.asarray(slots)]).long().to(self.device)

        def read(pool):
            x = pool[layer][table]  # [B, W, NKV, HD, ps]
            B, W, NKV, HD, ps = x.shape
            return x.permute(0, 1, 4, 2, 3).reshape(B, W * ps, NKV, HD)

        return read(self.pools["k"]), read(self.pools["v"])
