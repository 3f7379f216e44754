"""Paged KV cache: page pools, page-table writes and reads, host allocator
(port of the paged part of ``mila_tpu/inference/kv_cache.py``).

Pools are [L, P, NKV, HD, ps]: page-major with token-minor pages, so one
page of one KV head is a contiguous [HD, ps] slab for the decode kernel.
Unlike the JAX package, whose arrays are immutable, writes here update the
pools in place (the engine owns them; this saves a pool copy per step).
"""

from __future__ import annotations

import numpy as np
import torch

from mila_tpu_torch.kernels.paged_attention import (  # noqa: F401 (re-export)
    paged_decode_attention,
    paged_decode_attention_ref,
)


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
    land somewhere harmless and are never read.
    """

    def __init__(self, num_pages: int, page_size: int, max_slots: int, max_len: int):
        if num_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is reserved)")
        self.page_size = page_size
        self.num_pages = num_pages
        self.table_width = -(-max_len // page_size)
        self._free = list(range(num_pages - 1, 0, -1))
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
