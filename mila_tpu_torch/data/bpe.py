"""Byte-level BPE tokenizer: the native encoder with a pure-Python one of
the same semantics (port of ``mila_tpu/data/bpe.py``, unchanged in
behaviour, so both give JAX's ids on the same vocabulary and merges).

Pre-tokenization approximates the GPT-2 regex in ASCII
(`'s|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|\\s+`);
bytes >= 0x80 count as letters. Merge ranks come from an explicit list or
from vocabulary order (:func:`derive_merges`).
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from mila_tpu_torch import native as _native


def _is_letter(b: int) -> bool:
    return 65 <= b <= 90 or 97 <= b <= 122 or b >= 0x80


def _is_digit(b: int) -> bool:
    return 48 <= b <= 57


_SPACE = frozenset(b" \t\n\r\f\v")


def _is_space(b: int) -> bool:
    return b in _SPACE


def _next_pretoken(s: bytes, i: int) -> int:
    """End index of the pre-token starting at ``i`` (as mila_bpe.cpp)."""
    n = len(s)
    if s[i] == 0x27 and i + 1 < n:  # apostrophe contractions
        c1 = s[i + 1] | 0x20
        if c1 in (ord("s"), ord("t"), ord("m"), ord("d")):
            return i + 2
        if i + 2 < n:
            c2 = s[i + 2] | 0x20
            if (c1, c2) in ((ord("r"), ord("e")), (ord("v"), ord("e")), (ord("l"), ord("l"))):
                return i + 3
    j = i
    leading_space = False
    if s[j] == 0x20 and j + 1 < n and not _is_space(s[j + 1]):
        leading_space = True
        j += 1
    if j < n and _is_letter(s[j]):
        while j < n and _is_letter(s[j]):
            j += 1
        return j
    if j < n and _is_digit(s[j]):
        while j < n and _is_digit(s[j]):
            j += 1
        return j
    if j < n and not _is_space(s[j]):
        while j < n and not (_is_space(s[j]) or _is_letter(s[j]) or _is_digit(s[j])):
            j += 1
        return j
    if leading_space:
        return i + 1
    while j < n and _is_space(s[j]):
        j += 1
    return j


def derive_merges(vocab: Sequence[bytes]) -> list[tuple[int, int, int]]:
    """(left, right, merged) triples from vocabulary order: multi-byte
    tokens in id order, each split where max(left, right) is least (the
    parts predate the merge)."""
    lookup = {tok: i for i, tok in enumerate(vocab)}
    merges = []
    for tid, tok in enumerate(vocab):
        if len(tok) < 2:
            continue
        best = None
        for cut in range(1, len(tok)):
            a, b = lookup.get(tok[:cut]), lookup.get(tok[cut:])
            if a is None or b is None or a >= tid or b >= tid:
                continue
            key = (max(a, b), min(a, b))
            if best is None or key < best[0]:
                best = (key, (a, b, tid))
        if best is not None:
            merges.append(best[1])
    return merges


class BPETokenizer:
    """Byte-level BPE with ranked merges. ``vocab``: id -> bytes (all 256
    single bytes for lossless encoding); ``merges``: (left, right[,
    merged]) in rank order, derived from vocabulary order when absent."""

    def __init__(self, vocab: Sequence[bytes], merges: Optional[Sequence[tuple]] = None):
        self.vocab = [bytes(t) for t in vocab]
        self._lookup = {t: i for i, t in enumerate(self.vocab)}
        if merges is None:
            triples = derive_merges(self.vocab)
        else:
            triples = []
            for m in merges:
                if len(m) == 3:
                    a, b, mid = m
                else:
                    a, b = m
                    mid = self._lookup.get(self.vocab[a] + self.vocab[b])
                    if mid is None:
                        raise ValueError(f"merged token for pair ({a},{b}) not in vocab")
                triples.append((int(a), int(b), int(mid)))
        self.merges = triples
        self._ranks = {(a, b): (r, mid) for r, (a, b, mid) in enumerate(triples)}
        self._byte_to_id = [self._lookup.get(bytes([b]), -1) for b in range(256)]
        self._native_handle = _native.bpe_new(self.vocab, self.merges)

    def __del__(self):
        handle = getattr(self, "_native_handle", None)
        if handle:
            try:
                _native.bpe_free(handle)
            except Exception:  # noqa: BLE001 - interpreter teardown
                pass

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def encode(self, text: str | bytes, *, use_native: Optional[bool] = None) -> np.ndarray:
        """Token ids (int32). The native encoder unless ``use_native`` is
        False or it did not load; on its error the Python one runs."""
        data = text.encode("utf-8") if isinstance(text, str) else bytes(text)
        if not data:
            return np.zeros((0,), np.int32)
        if use_native is None:
            use_native = self._native_handle is not None
        if use_native and self._native_handle is not None:
            ids = _native.bpe_encode(self._native_handle, data)
            if ids is not None:
                return ids
        return self._encode_py(data)

    def _encode_py(self, data: bytes) -> np.ndarray:
        out: list[int] = []
        i, n = 0, len(data)
        while i < n:
            j = _next_pretoken(data, i)
            ids = []
            for k in range(i, j):
                bid = self._byte_to_id[data[k]]
                if bid < 0:
                    raise ValueError(f"byte {data[k]:#x} not in vocab")
                ids.append(bid)
            out.extend(self._merge(ids))
            i = j
        return np.asarray(out, np.int32)

    def _merge(self, ids: list[int]) -> list[int]:
        while len(ids) >= 2:
            best = None
            for i in range(len(ids) - 1):
                rm = self._ranks.get((ids[i], ids[i + 1]))
                if rm is not None and (best is None or rm[0] < best[0]):
                    best = (rm[0], i, rm[1])
            if best is None:
                break
            _, i, mid = best
            ids[i:i + 2] = [mid]
        return ids

    def decode(self, ids) -> str:
        return b"".join(self.vocab[int(i)] for i in np.asarray(ids).reshape(-1)
                        if 0 <= int(i) < len(self.vocab)).decode("utf-8", errors="replace")

    @staticmethod
    def from_llmc_bin(path: str | Path) -> "BPETokenizer":
        """An encoder over an llm.c gpt2_tokenizer.bin's vocabulary (merges
        derived from its order)."""
        from mila_tpu_torch.serialization.llmc import GPT2Tokenizer

        return BPETokenizer(GPT2Tokenizer(path).tokens)

    @staticmethod
    def byte_fallback(extra: Sequence[bytes] = ()) -> "BPETokenizer":
        """The 256 single bytes, then ``extra`` tokens in merge order."""
        return BPETokenizer([bytes([b]) for b in range(256)] + [bytes(t) for t in extra])
