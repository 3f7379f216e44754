"""Decode attention over the contiguous, token-major KV cache.

Replaces two TPU kernels of ``mila_tpu/kernels/dense_attention.py``:

- ``dense_decode_attention`` (``_dense_kernel``): one query per row, GQA,
  over ``[B, T, NKV, HD]`` caches with per-row lengths (the current token
  included). Reached from ``LlamaBlock.apply_with_cache`` and
  ``Llama.forward_with_cache_ragged`` when the params carry no layer pack.
- ``fused_decode_attention`` (``_fused_kernel``): the packed decode path's
  attention. It takes the raw fused qkv row (before RoPE) and tiled RoPE
  tables, ropes q and the new k itself, attends over the ``old_lens[b]``
  cached rows plus the current token, and writes the roped k and the raw v
  into row ``old_lens[b]`` of the caches it is given.

As in the TPU kernels, q (or qkv) and the caches need not share a dtype: a
bf16 or f32 q over bf16 or f32 caches (``PAIRS``) is read each in its own
dtype, the output (and ``k_new``) takes q's, and the fused entry rounds the
row it writes to the caches' dtype. The speculative engine's draft, whose
cache is always bf16, reaches this pair with f32 params.

What bounds both on the H100: the K/V bytes of the live rows (one query
per row does 2 operations per byte read). The CUDA kernels
(``csrc/dense_decode_attn.cu``) split each row along the sequence
(flash-decoding): the grid is (B * NKV, S), where :func:`plan_splits`
chooses S on the host from B, NKV, T and the SM count (never from the
lengths, a device tensor: reading them would stall the stream and break
CUDA-graph capture). Each block reads its row's length on the device and
takes the token range :func:`split_tokens` gives, so the splits share the
row's own length, not the cache's, and each holds at least
``SPLIT_MIN_TOKENS`` tokens unless the row is shorter. The G = NH / NKV
query heads of a KV head share its block, so each K/V element is read once,
and a split's K and V rows are requested through ``cp.async`` before any
math. With more than one split in a row, the splits write f32 partials
(o, m, l) into scratch this wrapper allocates, and the last split of a (row,
KV head) to finish merges them with the log-sum-exp rescale, in a fixed order,
inside the same launch. It counts arrivals in counters that the wrapper
keeps (``_counters``): no two launches that may run at the same time share
one, and no tensor a captured graph uses is handed to anything else.

The TPU kernel contracts lane-packed queries (``pack_queries``) against
whole ``[T, NKV*HD]`` slabs to keep the MXU busy; the CUDA kernels index
the KV head directly and need no packed queries, so
``fused_decode_attention`` accepts ``q_pk=None`` and ignores it otherwise.

The fused kernel writes the new rows in place, as the aliased Pallas call
does: the returned caches are the tensors passed in. Its plain version
(``fused_decode_attention_plain``, the port of
``_fused_decode_attention_ref``) writes them with an in-place index write.
Rows with ``old_lens[b] >= T`` are not written (JAX drops the out-of-range
scatter).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from mila_tpu_torch.kernels import _build
from mila_tpu_torch.kernels.quant_matmul import _sm_count
from mila_tpu_torch.ops.attention import decode_attention

SPLIT_MIN_TOKENS = 32  # a split holds at least this many tokens of a row (fewer only if shorter)
SPLIT_BLOCKS_PER_SM = 2  # splits until the grid has this many blocks per SM
SPLIT_MAX = 64  # the merge's staging holds at most this many splits' maxima and sums


def plan_splits(B: int, NKV: int, T: int, sms: int) -> int:
    """The number S of sequence splits per (row, KV head) for a cache of T
    rows: enough for B * NKV * S to reach ``SPLIT_BLOCKS_PER_SM`` blocks per
    SM, at most T // ``SPLIT_MIN_TOKENS`` and ``SPLIT_MAX``; S >= 1.
    Independent of the rows' lengths."""
    most = max(1, min(SPLIT_MAX, T // SPLIT_MIN_TOKENS))
    want = -(-SPLIT_BLOCKS_PER_SM * sms // max(1, B * NKV))
    return max(1, min(most, want))


def split_tokens(length: int, S: int) -> list[tuple[int, int]]:
    """The token ranges of a row of ``length`` tokens under S splits, as the
    kernel computes them on the device: n = min(S, max(1, length //
    SPLIT_MIN_TOKENS)) ranges [s length / n, (s + 1) length / n), covering
    [0, length) once with sizes within one; splits n .. S - 1 take none."""
    n = min(S, max(1, length // SPLIT_MIN_TOKENS))
    return [(s * length // n, (s + 1) * length // n) for s in range(n)]


def pack_queries(q: torch.Tensor, nkv: int) -> torch.Tensor:
    """[..., NH, HD] -> [..., NH, NKV*HD]: head n's vector lands in its kv
    head's lane range (n // group), zeros elsewhere."""
    *lead, NH, HD = q.shape
    group = NH // nkv
    onehot = torch.nn.functional.one_hot(torch.arange(NH, device=q.device) // group,
                                         nkv).to(q.dtype)  # [NH, NKV]
    qj = torch.einsum("...nd,nj->...njd", q, onehot)
    return qj.reshape(*lead, NH, nkv * HD)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def dense_decode_attention_plain(q, k_cache, v_cache, lens, *,
                                 scale: Optional[float] = None) -> torch.Tensor:
    """Plain version of :func:`dense_decode_attention` (``ops.decode_attention``,
    which is what the JAX entry point runs on the CPU)."""
    dense_decode_attention_plain.calls += 1
    squeeze = q.ndim == 4
    q4 = q if squeeze else q[:, None]
    out = decode_attention(q4, k_cache, v_cache, lens, scale=scale)
    return out if squeeze else out[:, 0]


def _rope_flat(x: torch.Tensor, c: torch.Tensor, s: torch.Tensor, hd: int) -> torch.Tensor:
    """x * c + swap_halves(x) * s per head of width hd, in f32, cast back."""
    xg = x.reshape(*x.shape[:-1], x.shape[-1] // hd, hd)
    y = torch.cat([xg[..., hd // 2:], xg[..., : hd // 2]], dim=-1).reshape(x.shape)
    return (x.float() * c.float() + y.float() * s.float()).to(x.dtype)


def fused_decode_attention_plain(qkv, cos_t, sin_t, k_cache, v_cache, old_lens, *,
                                 num_heads: int, scale: Optional[float] = None):
    """Plain version of :func:`fused_decode_attention` (port of
    ``_fused_decode_attention_ref``): rope via the tiled tables, write the
    new row in place, then decode attention over old rows + the current."""
    fused_decode_attention_plain.calls += 1
    B, T, NKV, HD = k_cache.shape
    KD, NQ = NKV * HD, num_heads * HD
    k_new = _rope_flat(qkv[:, NQ:NQ + KD], cos_t, sin_t, HD)
    v_new = qkv[:, NQ + KD:]
    q = _rope_flat(qkv[:, :NQ], cos_t[:, :HD].repeat(1, num_heads),
                   sin_t[:, :HD].repeat(1, num_heads), HD)
    lens = old_lens.to(device=k_cache.device, dtype=torch.long)
    live = lens < T
    rows = torch.arange(B, device=k_cache.device)[live]
    kc, vc = k_cache.view(B, T, KD), v_cache.view(B, T, KD)
    kc[rows, lens[live]] = k_new[live].to(kc.dtype)
    vc[rows, lens[live]] = v_new[live].to(vc.dtype)
    out = decode_attention(q.reshape(B, 1, num_heads, HD), k_cache, v_cache, lens + 1,
                           scale=scale)
    return out[:, 0], k_new, k_cache, v_cache


dense_decode_attention_plain.calls = 0
fused_decode_attention_plain.calls = 0

# ---------------------------------------------------------------------------
# CUDA launch
# ---------------------------------------------------------------------------

_HDS = (8, 16, 32, 64, 128)


def _lib() -> ctypes.CDLL:
    lib = _build.library("dense_decode_attn")
    if not getattr(lib, "_typed", False):
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.dense_decode_attn.argtypes = [vp] * 9 + [ci] * 6 + [cf, ci, ci, vp]
        lib.dense_decode_attn.restype = ci
        lib.fused_decode_attn.argtypes = [vp] * 12 + [ci] * 6 + [cf, ci, ci, vp]
        lib.fused_decode_attn.restype = ci
        lib.dense_capture_id.argtypes = [vp]
        lib.dense_capture_id.restype = ctypes.c_ulonglong
        lib._typed = True
    return lib


# (q dtype, cache dtype) pairs the kernels instantiate: the TPU kernels take q
# in any dtype and stage the caches in theirs.
PAIRS = {(qd, cd) for qd in (torch.bfloat16, torch.float32)
         for cd in (torch.bfloat16, torch.float32)}


def _check_heads(NH: int, NKV: int, HD: int) -> None:
    if NH % NKV or NH // NKV > 8 or HD not in _HDS:
        raise ValueError(f"dense_decode_attn needs NH/NKV <= 8 and HD in {_HDS} "
                         f"(NH={NH}, NKV={NKV}, HD={HD})")


def _check_cache(k_cache, v_cache, dtype) -> None:
    if (v_cache.shape != k_cache.shape or v_cache.dtype != k_cache.dtype
            or (dtype, k_cache.dtype) not in PAIRS):
        raise TypeError("dense_decode_attn takes a bf16 or f32 q over bf16 or f32 k/v caches "
                        f"of one dtype and shape (q {dtype}, caches {k_cache.dtype}/"
                        f"{v_cache.dtype})")
    if not (k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError("dense_decode_attn: caches must be contiguous")
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("dense_decode_attn: caches must be 16-byte aligned (16-byte loads)")


# Arrival counters, zero between launches (the merging split resets its
# own). Eager launches on one stream run in order, so they share one tensor
# per (device, stream); one outgrown is kept (``_RETIRED``), never freed, as
# a launch queued before may still count in it. A launch captured into a
# CUDA graph takes counters allocated during that capture, one tensor per
# (capture, stream), zeroed by a fill captured with them: the graph's own
# memory pool holds them, every replay zeroes them before its first launch,
# and no eager launch or other graph counts in them.
_EAGER_COUNTERS: dict = {}
_CAPTURE_COUNTERS: dict = {}
_RETIRED: list = []


def _counters(device, n: int) -> torch.Tensor:
    """An int32 tensor of at least ``n`` arrival counters, zero when the
    launch that takes it starts, for the current stream of ``device``."""
    stream = torch.cuda.current_stream(device).cuda_stream
    capture = 0
    if torch.cuda.is_current_stream_capturing():
        capture = _lib().dense_capture_id(ctypes.c_void_p(stream))
    # A stream captures one graph at a time: its entries of ended captures go.
    for key in [k for k in _CAPTURE_COUNTERS if k[1] == stream and k[0] != capture]:
        del _CAPTURE_COUNTERS[key]
    if capture:
        t = _CAPTURE_COUNTERS.get((capture, stream))
        if t is None or t.numel() < n:
            t = torch.zeros(n, dtype=torch.int32, device=device)
            _CAPTURE_COUNTERS[(capture, stream)] = t
        return t
    key = (device.index, stream)
    t = _EAGER_COUNTERS.get(key)
    if t is None or t.numel() < n:
        if t is not None:
            _RETIRED.append(t)
        t = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _EAGER_COUNTERS[key] = t
    return t


def _scratch(B: int, NH: int, NKV: int, HD: int, T: int, device):
    """(S, the kernels' scratch): f32 partials o [B, NH, S, HD], m and l
    [B, NH, S] each, and the arrival counters, or Nones when S == 1."""
    S = plan_splits(B, NKV, T, _sm_count(device.index or 0))
    if S == 1:
        return S, [None] * 4
    o_part = torch.empty((B, NH, S, HD), dtype=torch.float32, device=device)
    ml_part = torch.empty((2, B, NH, S), dtype=torch.float32, device=device)
    return S, [o_part, ml_part[0], ml_part[1], _counters(device, B * NKV)]


def _ptrs(tensors) -> list:
    return [None if t is None else _build.ptr(t) for t in tensors]


def dense_decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                           lens: torch.Tensor, *, scale: Optional[float] = None) -> torch.Tensor:
    """Decode attention over the dense cache. q [B, 1, NH, HD] or [B, NH, HD];
    caches [B, T, NKV, HD]; lens [B] int32 = valid rows including the current
    token. Returns q's shape.

    CUDA tensors launch ``dense_decode_attn`` (a bf16 or f32 q over bf16 or
    f32 caches in any pairing, ``PAIRS``); CPU tensors take
    :func:`dense_decode_attention_plain`."""
    if not q.is_cuda:
        return dense_decode_attention_plain(q, k_cache, v_cache, lens, scale=scale)
    B, T, NKV, HD = k_cache.shape
    NH = q.shape[-2]
    if q.shape[-1] != HD or q.numel() != B * NH * HD:
        raise ValueError(f"bad shapes q {tuple(q.shape)} cache {tuple(k_cache.shape)}")
    _check_heads(NH, NKV, HD)
    _check_cache(k_cache, v_cache, q.dtype)
    qc = q.contiguous()
    ln = lens.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty_like(qc)
    sm_scale = 1.0 / math.sqrt(HD) if scale is None else scale
    S, scratch = _scratch(B, NH, NKV, HD, T, q.device)
    lib = _lib()
    rc = lib.dense_decode_attn(
        _build.ptr(qc), _build.ptr(k_cache), _build.ptr(v_cache), _build.ptr(ln),
        _build.ptr(out), *_ptrs(scratch), B, T, NH, NKV, HD, S, sm_scale,
        int(q.dtype == torch.float32), int(k_cache.dtype == torch.float32), _build.stream_of(q))
    _build.check(lib, rc, "dense_decode_attn")
    dense_decode_attention.launches += 1
    return out


def fused_decode_attention(qkv: torch.Tensor, q_pk: Optional[torch.Tensor],
                           cos_t: torch.Tensor, sin_t: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, old_lens: torch.Tensor, *, num_heads: int,
                           scale: Optional[float] = None):
    """In-kernel RoPE + dense-cache decode attention + cache write-back.

    qkv [B, NQ + 2*NKV*HD] raw fused projection (before RoPE); ``q_pk`` is
    accepted for the JAX signature and not used; cos_t/sin_t [B, NKV*HD]
    tiled tables (cos duplicated over the halves, sin pre-signed
    ``[-sin | sin]``); caches [B, T, NKV, HD] (the kernel, like the TPU
    kernel, takes T % 8 == 0 only); old_lens [B] = live rows, the current
    token excluded.

    Returns (att [B, NH, HD], k_new [B, NKV*HD] roped in qkv's dtype,
    k_cache, v_cache) where the caches are the tensors given, row
    ``old_lens[b]`` now holding the roped k and the raw v."""
    del q_pk
    B, T, NKV, HD = k_cache.shape
    NH = num_heads
    sm_scale = 1.0 / math.sqrt(HD) if scale is None else scale
    if not qkv.is_cuda:
        return fused_decode_attention_plain(qkv, cos_t, sin_t, k_cache, v_cache, old_lens,
                                            num_heads=NH, scale=sm_scale)
    if T % 8:
        raise ValueError(f"fused_decode_attention needs T % 8 == 0 (got T={T}): "
                         "init_kv_cache rounds the cache length up")
    KD, NQ = NKV * HD, NH * HD
    if qkv.shape != (B, NQ + 2 * KD) or cos_t.shape != (B, KD) or sin_t.shape != (B, KD):
        raise ValueError(f"bad shapes qkv {tuple(qkv.shape)} cos {tuple(cos_t.shape)} "
                         f"cache {tuple(k_cache.shape)}")
    _check_heads(NH, NKV, HD)
    _check_cache(k_cache, v_cache, qkv.dtype)
    qc = qkv.contiguous()
    c32 = cos_t.to(torch.float32).contiguous()
    s32 = sin_t.to(torch.float32).contiguous()
    ln = old_lens.to(device=qkv.device, dtype=torch.int32).contiguous()
    att = torch.empty((B, NH, HD), dtype=qkv.dtype, device=qkv.device)
    k_new = torch.empty((B, KD), dtype=qkv.dtype, device=qkv.device)
    S, scratch = _scratch(B, NH, NKV, HD, T, qkv.device)
    lib = _lib()
    rc = lib.fused_decode_attn(
        _build.ptr(qc), _build.ptr(c32), _build.ptr(s32), _build.ptr(k_cache),
        _build.ptr(v_cache), _build.ptr(ln), _build.ptr(att), _build.ptr(k_new), *_ptrs(scratch),
        B, T, NH, NKV, HD, S, sm_scale, int(qkv.dtype == torch.float32),
        int(k_cache.dtype == torch.float32), _build.stream_of(qkv))
    _build.check(lib, rc, "fused_decode_attn")
    fused_decode_attention.launches += 1
    return att, k_new, k_cache, v_cache


dense_decode_attention.launches = 0
fused_decode_attention.launches = 0
