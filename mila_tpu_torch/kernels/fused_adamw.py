"""Fused AdamW: one update of every parameter leaf of a step (param, both
moments and the f32 master) in one launch per dtype group, the global-norm
clip's factor in one launch, and the stochastic-rounding noise drawn in the
kernel from JAX's own generator.

Replaces the TPU kernel ``mila_tpu/kernels/fused_adamw.py:_adamw_kernel``
(entry ``fused_adamw_update``). ``optim.AdamW.step`` calls
:func:`grad_clip_scale` (where it clips) and :func:`fused_adamw_step` once a
step on every device: for CUDA tensors they launch ``csrc/fused_adamw.cu``,
for CPU tensors they run :func:`grad_clip_scale_plain` and
:func:`fused_adamw_step_plain`, which is JAX's per-leaf update
(``optim/adamw.py``) in the same operation order, leaf by leaf.
:func:`fused_adamw_update` keeps JAX's per-leaf entry; on the card it
launches the same kernel over its one leaf.

What bounds it on the H100: bytes. Per element the update reads g (2 bytes
in bf16), m, v and the master (4 each) and writes p, m, v and the master,
and the norm reads g again: 30 bytes against ~12 f32 operations and the
draw's ~75 integer ones. One launch per (param dtype, grad dtype) group
takes every leaf through a table of leaves in its kernel parameters, a
block per 32768-element chunk; see the source.

Stochastic-rounding noise: element i of a bf16 leaf with a master draws
``bits(leaf_key, shape).ravel()[i] & 0xffff``, JAX's Threefry-2x32 bits
(``jax_threefry_partitionable``, as the JAX package runs), with
``leaf_key = threefry(key, (0, id))``: ``split(key, n)[id]`` for
``AdamW.step`` (``id`` the leaf's index in JAX's tree order, ``key`` the
step key), ``fold_in(key(0), seed)`` for :func:`fused_adamw_update`'s
``seed``. :func:`threefry2x32` is the plain version of the draw, in int64
torch ops. Given the same key, the port's rounded params equal JAX's bit
for bit wherever the f32 masters are equal.

Differences from the JAX entry, none of which changes a result:
- ``noise`` (uint32 or int32 bits, one per element) may replace the draw,
  so a test can feed the bits of another generator; without it a bf16
  param with a master needs ``seed``;
- ``grad_scale`` (a float, or the clip factor as a device f32) multiplies
  the f32 gradient first, so the global-norm clip of ``AdamW.step`` (JAX:
  ``g * clip``, which promotes a bf16 gradient to f32) costs no pass of its
  own; 1.0 leaves g as it is;
- ``block`` and ``interpret`` (the TPU's tiling and interpreter) are gone.

Stochastic rounding applies, as in JAX's kernel, to a bf16 param with a
master; an f32 param with a master gets p' = master'. An fp16 param is
rounded to nearest, with or without a master, as JAX's kernel rounds it.
JAX's ``AdamW`` gives the same fp16 values: its fp16 "stochastic" branch
steps to the neighbouring f32 value (``nextafter`` in f32) and casts that
back to fp16, which lands on the nearest fp16 value again (a defect of the
reference, ROADMAP §C.3); so on fp16 the kernel and both JAX routes agree
bit for bit.

Outputs are new tensors: per group one flat buffer per stream, each leaf a
view at a 16-byte-aligned offset; the inputs are left as they were.

A step reads no host value back, so it can be captured in a CUDA graph; but
the step count's bias corrections, the learning rate and a host key travel
in the launch's parameters, so every replay of such a graph repeats the step
it captured (what a timing wants), never the next one.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import functools
import math
import os
from typing import Optional, Sequence

import numpy as np
import torch

from mila_tpu_torch.kernels import _build

# csrc/fused_adamw.cu: Leaf and NormLeaf records, the chunks a block takes
# (chunk_size), and the leaves a launch holds.
LEAF = np.dtype([("p", "<u8"), ("g", "<u8"), ("m", "<u8"), ("v", "<u8"), ("w", "<u8"),
                 ("noise", "<u8"), ("n", "<i8"), ("out", "<i8"), ("chunk0", "<i4"),
                 ("id", "<u4")])
NORM_LEAF = np.dtype([("g", "<u8"), ("n", "<i8"), ("chunk0", "<i4"), ("dtype", "<i4")])
CHUNK_MAX, CHUNK_MIN = 32768, 2048
MAX_LEAVES = 448
MAX_NORM_LEAVES = 1024
ALIGN = 8  # elements: every leaf's outputs start 16-byte aligned

_M32 = 0xFFFFFFFF
_FILL_BLOCKS = 132 * 8  # blocks that fill the H100's SMs eight deep
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_DRAW_BLOCK = 1 << 22  # elements of the plain draw at a time on the card (int64 temporaries)
_NP_BLOCK = 1 << 18  # and on the CPU (uint32, a block in the cache)


def _f32(x: float) -> float:
    """x rounded to f32, as a Python float (JAX's weakly typed scalars)."""
    return float(np.float32(x))


@functools.lru_cache(maxsize=16)
def bias_corrections(step: int, beta1: float, beta2: float) -> tuple[float, float]:
    """(1 - beta1^t, 1 - beta2^t) computed in f32, as JAX computes them
    (once per step: every leaf of the step asks for the same pair)."""
    t = torch.tensor(float(step), dtype=torch.float32)
    b1 = torch.tensor(_f32(beta1), dtype=torch.float32)
    b2 = torch.tensor(_f32(beta2), dtype=torch.float32)
    return float(1.0 - b1 ** t), float(1.0 - b2 ** t)


# ---------------------------------------------------------------------------
# The draw: Threefry-2x32-20, in int64 torch ops (the kernel's plain version)
# ---------------------------------------------------------------------------

def threefry2x32(k0, k1, x0, x1):
    """JAX's ``threefry_2x32`` of the counter (x0, x1) under the key (k0,
    k1): ints or int64 tensors holding uint32 values (a 0-dim tensor key
    broadcasts over tensor counters)."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = ((x1 << r) & _M32) | (x1 >> (32 - r))
            x1 = x1 ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def key_words(key) -> tuple:
    """A step key as two uint32 words: ``None`` is JAX's ``key(0)``, (0, 0);
    a 2-element integer tensor (``jax.random.key_data``, or the words a
    generator drew) gives its words, as ints where it lies on the CPU and
    as 0-dim int64 tensors where it lies on the card (no host sync)."""
    if key is None:
        return 0, 0
    if isinstance(key, torch.Tensor):
        if key.numel() != 2 or key.is_floating_point():
            raise ValueError(f"a step key is two integer words, got {key.dtype} "
                             f"{tuple(key.shape)}")
        k = key.reshape(2)
        if not k.is_cuda:
            return tuple(int(x) & _M32 for x in k.tolist())
        k = k.to(torch.int64) & _M32
        return k[0], k[1]
    k0, k1 = key
    return int(k0) & _M32, int(k1) & _M32


def leaf_key(key, leaf_id: int) -> tuple:
    """threefry(key, (0, id)): ``split(key, n)[id]`` and ``fold_in(key, id)``."""
    k0, k1 = key_words(key)
    return threefry2x32(k0, k1, 0, int(leaf_id) & _M32)


def threefry_bits(key, leaf_id: int, n: int, device) -> torch.Tensor:
    """JAX's ``bits(leaf_key(key, leaf_id), (n,), uint32)``: element i is
    x0 ^ x1 of threefry(leaf key, (i >> 32, i)). On the CPU, uint32 numpy
    passes over cache-sized blocks on a thread each, as int32 bits; on the
    card (or with a key on the card), int64 torch ops."""
    lk0, lk1 = leaf_key(key, leaf_id)
    if torch.device(device).type == "cpu" and isinstance(lk0, int):
        return torch.from_numpy(_bits_numpy(lk0, lk1, n).view(np.int32))
    return _bits_torch(lk0, lk1, n, device)


def _bits_torch(lk0, lk1, n: int, device) -> torch.Tensor:
    out = torch.empty(n, dtype=torch.int64, device=device)
    for s in range(0, n, _DRAW_BLOCK):
        i = torch.arange(s, min(n, s + _DRAW_BLOCK), dtype=torch.int64, device=device)
        x0, x1 = threefry2x32(lk0, lk1, i >> 32, i & _M32)
        out[s:s + i.numel()] = x0 ^ x1
    return out


def _bits_numpy(lk0: int, lk1: int, n: int) -> np.ndarray:
    out = np.empty(n, np.uint32)
    ks = (lk0, lk1, lk0 ^ lk1 ^ 0x1BD11BDA)
    u32 = np.uint32

    def block(s: int) -> None:
        i = np.arange(s, min(n, s + _NP_BLOCK), dtype=np.uint64)
        x0 = (i >> np.uint64(32)).astype(u32)
        x1 = i.astype(u32)
        tmp = np.empty_like(x1)
        x0 += u32(ks[0])
        x1 += u32(ks[1])
        for r5 in range(5):
            for r in _ROTATIONS[r5 % 2]:
                x0 += x1
                np.left_shift(x1, u32(r), out=tmp)
                x1 >>= u32(32 - r)
                x1 |= tmp
                x1 ^= x0
            x0 += u32(ks[(r5 + 1) % 3])
            x1 += u32((ks[(r5 + 2) % 3] + r5 + 1) & _M32)
        np.bitwise_xor(x0, x1, out=out[s:s + x1.size])

    starts = range(0, n, _NP_BLOCK)
    if len(starts) > 1:
        with concurrent.futures.ThreadPoolExecutor(min(len(starts), os.cpu_count() or 1)) as ex:
            list(ex.map(block, starts))
    elif n:
        block(0)
    return out


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def stochastic_round_bf16(w: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """bf16 of (bits(w) + (noise & 0xffff)) & 0xffff0000: unbiased rounding
    of an f32 tensor from the given random bits (JAX's construction)."""
    bits = w.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    r = (bits + (noise.reshape(w.shape).to(torch.int64) & 0xFFFF)) & 0xFFFF0000
    r = torch.where(r >= 1 << 31, r - (1 << 32), r).to(torch.int32)
    return r.view(torch.float32).to(torch.bfloat16)


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient element, in f32
    (``grads`` a tree of tensors or a list of them)."""
    from mila_tpu_torch.utils.tree import tree_leaves

    leaves = grads if isinstance(grads, (list, tuple)) else tree_leaves(grads)
    return torch.sqrt(sum(g.float().square().sum() for g in leaves))


def _update_plain(p, g, m, v, master, *, step, lr, beta1, beta2, eps, weight_decay, noise,
                  grad_scale):
    bc1, bc2 = bias_corrections(step, beta1, beta2)
    dev = m.device
    # 0-dim tensors on the device: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which the kernel does not.
    bc1_t = torch.tensor(bc1, dtype=torch.float32, device=dev)
    bc2_t = torch.tensor(bc2, dtype=torch.float32, device=dev)
    gs = grad_scale if isinstance(grad_scale, torch.Tensor) else _f32(grad_scale)
    g32 = g.float() * gs
    w = (master if master is not None else p).float()
    m_new = _f32(beta1) * m + _f32(1.0 - beta1) * g32
    v_new = _f32(beta2) * v + _f32(1.0 - beta2) * g32 * g32
    upd = (m_new / bc1_t) / (torch.sqrt(v_new / bc2_t) + _f32(eps)) + _f32(weight_decay) * w
    w_new = w - _f32(lr) * upd
    if master is not None and p.dtype == torch.bfloat16:
        p_new = stochastic_round_bf16(w_new, noise)
    else:
        p_new = w_new.to(p.dtype)
    return p_new, m_new, v_new, (w_new if master is not None else None)


def fused_adamw_update_plain(p, g, m, v, master, *, step: int, lr: float, beta1: float = 0.9,
                             beta2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.01,
                             noise: Optional[torch.Tensor] = None, seed: Optional[int] = None,
                             grad_scale=1.0):
    """Plain version of :func:`fused_adamw_update`: the same f32 operations in
    the same order as the kernel (and JAX's ``AdamW.step``), one PyTorch op
    each."""
    fused_adamw_update_plain.calls += 1
    if _rounds_stochastically(p, master, noise, seed) and noise is None:
        noise = threefry_bits(None, seed, p.numel(), p.device)
    return _update_plain(p, g, m, v, master, step=step, lr=lr, beta1=beta1, beta2=beta2, eps=eps,
                         weight_decay=weight_decay, noise=noise, grad_scale=grad_scale)


fused_adamw_update_plain.calls = 0


def fused_adamw_step_plain(params: Sequence[torch.Tensor], grads, m, v, masters=None, *,
                           step: int, lr: float, beta1: float = 0.9, beta2: float = 0.999,
                           eps: float = 1e-8, weight_decay: float = 0.01, grad_scale=None,
                           key=None, leaf_ids: Optional[Sequence[int]] = None):
    """Plain version of :func:`fused_adamw_step`: :func:`fused_adamw_update`'s
    plain update leaf by leaf, each bf16 leaf with a master rounded with the
    bits :func:`threefry_bits` draws under the step key."""
    fused_adamw_step_plain.calls += 1
    n = len(params)
    ids = range(n) if leaf_ids is None else leaf_ids
    words = key_words(key)
    masters = [None] * n if masters is None else masters
    out = []
    for j, p, g, mi, vi, w in zip(ids, params, grads, m, v, masters):
        noise = (threefry_bits(words, j, p.numel(), p.device)
                 if w is not None and p.dtype == torch.bfloat16 else None)
        out.append(_update_plain(p, g, mi, vi, w, step=step, lr=lr, beta1=beta1, beta2=beta2,
                                 eps=eps, weight_decay=weight_decay, noise=noise,
                                 grad_scale=1.0 if grad_scale is None else grad_scale))
    return tuple([o[i] for o in out] for i in range(4))


fused_adamw_step_plain.calls = 0


def grad_clip_scale_plain(grads: Sequence[torch.Tensor], max_norm: float):
    """Plain version of :func:`grad_clip_scale`: (min(1, max_norm / (norm +
    1e-6)), norm) as 0-dim f32 tensors, JAX's ``AdamW.step`` clip."""
    grad_clip_scale_plain.calls += 1
    norm = global_norm(list(grads))
    num = torch.tensor(max_norm, dtype=torch.float32, device=norm.device)
    return torch.clamp(num / (norm + 1e-6), max=1.0), norm


grad_clip_scale_plain.calls = 0


# ---------------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------------

def _lib() -> ctypes.CDLL:
    lib = _build.library("fused_adamw")
    if not getattr(lib, "_typed", False):
        vp, ci, cu, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
        lib.fused_adamw_step.argtypes = ([vp, ci, ci, ci, ci, ci] + [vp] * 5 + [cf, vp, cu, cu]
                                         + [cf] * 9 + [vp])
        lib.fused_adamw_step.restype = ci
        lib.clip_norm.argtypes = [vp, ci, ci, ci, cf, vp, vp, vp, vp]
        lib.clip_norm.restype = ci
        lib.clip_norm_blocks.argtypes = [ci]
        lib.clip_norm_blocks.restype = ci
        lib._typed = True
    return lib


def chunk_size(total: int) -> int:
    """Elements a block takes in a launch over ``total`` elements: CHUNK_MAX,
    halved down to CHUNK_MIN (each thread's 8 once) while the launch would
    not fill the card eight blocks an SM deep."""
    c = CHUNK_MAX
    while c > CHUNK_MIN and total < c * _FILL_BLOCKS:
        c //= 2
    return c


def _ready(t: torch.Tensor) -> torch.Tensor:
    """t contiguous, at a 16-byte-aligned address (the kernels' vector loads)."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _ptr(t: Optional[torch.Tensor], keep: list) -> int:
    """The address of :func:`_ready`'s t (0 for None). The tensor read, t
    or its copy, is kept alive in ``keep`` until the launch: a caller's
    temporary (a master cast to f32, a reshaped noise) freed before it could
    hand its memory to the next leaf's temporary or to an output."""
    if t is None:
        return 0
    t = _ready(t)
    keep.append(t)
    return t.data_ptr()


def _addr(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.data_ptr()


@functools.lru_cache(maxsize=1024)
def _strides(shape: tuple) -> tuple:
    out, acc = [], 1
    for d in reversed(shape):
        out.append(acc)
        acc *= d
    return tuple(reversed(out))


def _views(buf: torch.Tensor, offs, shapes) -> list:
    return [buf.as_strided(s, _strides(s), o) for o, s in zip(offs, shapes)]


def _rounds_stochastically(p, master, noise, seed) -> bool:
    """Whether a per-leaf update rounds stochastically (a bf16 param with a
    master); such a leaf needs ``noise`` (one value per element) or a
    ``seed`` to draw it from."""
    if master is None or p.dtype != torch.bfloat16:
        return False
    if noise is None and seed is None:
        raise ValueError("stochastic rounding of a bf16 param needs noise or a seed")
    if noise is not None and noise.numel() != p.numel():
        raise ValueError("fused_adamw: noise must hold one value per element")
    return True


def _f32_master(w: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return w if w is None or w.dtype == torch.float32 else w.float()


def _check_leaf(p, g, m, v, w):
    if p.dtype not in _build.DTYPE_CODES:
        raise NotImplementedError(f"fused_adamw takes f32, bf16 or fp16 params, got {p.dtype}")
    if (g.dtype not in (p.dtype, torch.float32) or m.dtype != torch.float32
            or v.dtype != torch.float32):
        raise ValueError(f"fused_adamw: g must be p's dtype or f32 and m, v f32 (p {p.dtype}, "
                         f"g {g.dtype}, m {m.dtype}, v {v.dtype})")
    n, dev = p.numel(), p.get_device()
    if (g.numel() != n or m.numel() != n or v.numel() != n or g.get_device() != dev
            or m.get_device() != dev or v.get_device() != dev
            or (w is not None and (w.numel() != n or w.get_device() != dev))):
        raise ValueError("fused_adamw: p, g, m, v and master must match in size and device")


def _launch(params, grads, ms, vs, masters, noises, ids, *, step, lr, beta1, beta2, eps,
            weight_decay, grad_scale, key):
    """Launch the update over the leaves, one launch per (param dtype, grad
    dtype) group of at most MAX_LEAVES leaves (none for a group whose leaves
    are all empty); returns the four output lists and the number of
    launches."""
    dev = params[0].device
    n = len(params)
    for i in range(n):
        _check_leaf(params[i], grads[i], ms[i], vs[i], masters[i])
    scale_t, gs = None, 1.0
    if isinstance(grad_scale, torch.Tensor):
        if grad_scale.device != dev or grad_scale.numel() != 1:
            raise ValueError("fused_adamw: grad_scale must be one value on the params' device")
        scale_t = _ready(grad_scale.float())
    elif grad_scale is not None:
        gs = _f32(grad_scale)
    key_t, k0, k1 = None, 0, 0
    if isinstance(key, torch.Tensor) and key.is_cuda:
        if key.numel() != 2 or key.device != dev or key.is_floating_point():
            raise ValueError("fused_adamw: a step key is two integer words on the params' device")
        k = key.reshape(2)
        if k.element_size() == 8:  # the low 32 bits of each word (little-endian)
            k = k.view(torch.int32)[0::2]
        if k.element_size() != 4:
            raise ValueError(f"fused_adamw: a step key of {key.dtype} words")
        key_t = _ready(k)
    else:
        k0, k1 = key_words(key)
    bc1, bc2 = bias_corrections(step, beta1, beta2)
    hyper = (_f32(lr), _f32(beta1), _f32(1.0 - beta1), _f32(beta2), _f32(1.0 - beta2),
             _f32(eps), _f32(weight_decay), bc1, bc2)
    groups: dict = {}
    for i in range(n):
        groups.setdefault((params[i].dtype, grads[i].dtype), []).append(i)
    out = [[None] * n for _ in range(4)]
    lib, stream, launches = _lib(), _build.stream_of(params[0]), 0
    for (pd, gd), members in groups.items():
        for b in range(0, len(members), MAX_LEAVES):
            idx = members[b:b + MAX_LEAVES]
            sizes = [params[i].numel() for i in idx]
            offs = np.zeros(len(idx), np.int64)
            offs[1:] = np.cumsum([-(-s // ALIGN) * ALIGN for s in sizes[:-1]])
            total = int(offs[-1]) + sizes[-1]
            chunk = chunk_size(sum(sizes))
            chunks = [-(-s // chunk) for s in sizes]
            keep = []
            tab = np.array([(_ptr(params[i], keep), _ptr(grads[i], keep), _ptr(ms[i], keep),
                             _ptr(vs[i], keep),
                             _ptr(_f32_master(masters[i]), keep),
                             _ptr(None if noises[i] is None else noises[i].reshape(-1), keep),
                             sizes[r], offs[r], 0, int(ids[i]) & _M32)
                            for r, i in enumerate(idx)], LEAF)
            tab["chunk0"][1:] = np.cumsum(chunks[:-1])
            with_master = any(masters[i] is not None for i in idx)
            p_out = torch.empty(total, dtype=pd, device=dev)
            m_out, v_out = (torch.empty(total, dtype=torch.float32, device=dev)
                            for _ in range(2))
            w_out = torch.empty(total, dtype=torch.float32, device=dev) if with_master else None
            if sum(chunks):
                rc = lib.fused_adamw_step(
                    tab.ctypes.data, len(idx), int(sum(chunks)), chunk, _build.DTYPE_CODES[pd],
                    int(gd != torch.float32), _addr(p_out), _addr(m_out), _addr(v_out),
                    _addr(w_out), _addr(scale_t), gs, _addr(key_t), k0, k1, *hyper, stream)
                _build.check(lib, rc, "fused_adamw_step")
                launches += 1
            shapes = [tuple(params[i].shape) for i in idx]
            offs = offs.tolist()
            for k, buf in enumerate((p_out, m_out, v_out)):
                for i, t in zip(idx, _views(buf, offs, shapes)):
                    out[k][i] = t
            if w_out is not None:
                for i, t in zip(idx, _views(w_out, offs, shapes)):
                    out[3][i] = t if masters[i] is not None else None
    return out, launches


def fused_adamw_step(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor], m, v,
                     masters=None, *, step: int, lr: float, beta1: float = 0.9,
                     beta2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.01,
                     grad_scale=None, key=None, leaf_ids: Optional[Sequence[int]] = None):
    """One AdamW update of every leaf of a step: lists of params, grads, m,
    v and masters (or None) in; lists (p', m', v', master') out, master'
    None where the master is. ``grad_scale``: None, a float or a 0-dim f32
    tensor on the params' device (:func:`grad_clip_scale`'s factor); ``key``
    the step key of the stochastic rounding (:func:`key_words`);
    ``leaf_ids`` each leaf's counter under it (default 0, 1, ...). CUDA
    tensors launch ``fused_adamw_step`` once per (param dtype, grad dtype)
    group (a graph replay repeats this step: ``step``, ``lr`` and a host key
    are captured as values); CPU tensors take :func:`fused_adamw_step_plain`."""
    n = len(params)
    if not n:
        return [], [], [], []
    masters = [None] * n if masters is None else list(masters)
    kw = dict(step=int(step), lr=float(lr), beta1=beta1, beta2=beta2, eps=eps,
              weight_decay=weight_decay, grad_scale=grad_scale)
    if not params[0].is_cuda:
        return fused_adamw_step_plain(params, grads, m, v, masters, key=key, leaf_ids=leaf_ids,
                                      **kw)
    ids = list(range(n)) if leaf_ids is None else list(leaf_ids)
    out, launches = _launch(list(params), list(grads), list(m), list(v), masters, [None] * n,
                            ids, key=key, **kw)
    fused_adamw_step.launches += launches
    return tuple(out)


fused_adamw_step.launches = 0


def fused_adamw_update(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                       master: Optional[torch.Tensor], *, step: int, lr: float,
                       beta1: float = 0.9, beta2: float = 0.999, eps: float = 1e-8,
                       weight_decay: float = 0.01, noise: Optional[torch.Tensor] = None,
                       seed: Optional[int] = None, grad_scale=1.0):
    """One fused AdamW update of one parameter leaf; returns (p', m', v',
    master') with master' None when master is. ``step`` is the 1-based step
    count; ``lr`` a float (a schedule's value). A bf16 param with a master
    rounds stochastically with ``noise`` (bits, one per element) or, given
    ``seed``, JAX's kernel's bits ``bits(fold_in(key(0), seed))``. CUDA
    tensors launch ``fused_adamw_step``'s kernel over this leaf; CPU tensors
    take :func:`fused_adamw_update_plain`."""
    kw = dict(step=int(step), lr=float(lr), beta1=beta1, beta2=beta2, eps=eps,
              weight_decay=weight_decay, grad_scale=grad_scale)
    if not p.is_cuda:
        return fused_adamw_update_plain(p, g, m, v, master, noise=noise, seed=seed, **kw)
    nz = None
    if _rounds_stochastically(p, master, noise, seed) and noise is not None:
        if noise.dtype not in (torch.int32, torch.uint32):
            raise ValueError("fused_adamw: noise must be int32/uint32 bits, one per element")
        nz = noise.to(p.device)
    leaf_id = 0 if seed is None else int(seed) & _M32
    out, launches = _launch([p], [g], [m], [v], [master], [nz], [leaf_id], key=None, **kw)
    fused_adamw_update.launches += launches
    return tuple(o[0] for o in out)


fused_adamw_update.launches = 0


# ---------------------------------------------------------------------------
# The clip's global norm
# ---------------------------------------------------------------------------

_counters: dict = {}


def _done_counter(dev: torch.device, stream: int) -> torch.Tensor:
    """The norm kernel's ticket counter for this stream: 0 between launches.
    Made once outside a graph capture; inside one (a first call under
    capture), a counter of the graph's own, zeroed in the graph."""
    key = (dev.index, stream)
    c = _counters.get(key)
    if c is None:
        c = torch.zeros(1, dtype=torch.int32, device=dev)
        if dev.type != "cuda" or not torch.cuda.is_current_stream_capturing():
            _counters[key] = c
    return c


def _launch_norm(grads: list, max_norm: float):
    """(factor, norm) over ``grads`` and the number of launches: 1, or 0
    where every leaf is empty."""
    if len(grads) > MAX_NORM_LEAVES:
        raise NotImplementedError(f"clip_norm takes at most {MAX_NORM_LEAVES} leaves, got "
                                  f"{len(grads)}")
    dev = grads[0].device
    for g in grads:
        if g.dtype not in _build.DTYPE_CODES or g.device != dev:
            raise ValueError(f"clip_norm: gradients of f32, bf16 or fp16 on one device, got "
                             f"{g.dtype} on {g.device}")
    keep = []
    tab = np.array([(_ptr(g, keep), g.numel(), 0, _build.DTYPE_CODES[g.dtype]) for g in grads],
                   NORM_LEAF)
    chunk = chunk_size(sum(g.numel() for g in grads))
    chunks = [math.ceil(g.numel() / chunk) for g in grads]
    tab["chunk0"][1:] = np.cumsum(chunks[:-1])
    lib, stream = _lib(), _build.stream_of(grads[0])
    nchunks = int(sum(chunks))
    out = torch.empty(2, dtype=torch.float32, device=dev)
    if nchunks == 0:  # every leaf empty: the norm is 0 and the factor 1
        out.copy_(torch.tensor([1.0, 0.0]))
        return (out[0], out[1]), 0
    partial = torch.empty(lib.clip_norm_blocks(nchunks), dtype=torch.float32, device=dev)
    rc = lib.clip_norm(tab.ctypes.data, len(grads), nchunks, chunk, _f32(max_norm),
                       _addr(partial),
                       _addr(_done_counter(dev, stream.value)), _addr(out), stream)
    _build.check(lib, rc, "clip_norm")
    return (out[0], out[1]), 1


def grad_clip_scale(grads: Sequence[torch.Tensor], max_norm: float):
    """The global-norm clip of a step: (min(1, max_norm / (norm + 1e-6)),
    norm) over every gradient leaf, as 0-dim f32 tensors on their device
    (no host sync). CUDA tensors launch ``clip_norm`` once (a fixed order of
    sums: two calls are bit-equal); CPU tensors take
    :func:`grad_clip_scale_plain`."""
    grads = list(grads)
    if not grads[0].is_cuda:
        return grad_clip_scale_plain(grads, max_norm)
    out, launches = _launch_norm(grads, max_norm)
    grad_clip_scale.launches += launches
    return out


grad_clip_scale.launches = 0
