"""Fused softmax cross-entropy over the last axis: per-row loss forward and
dlogits backward, from raw logits and integer targets.

Replaces the TPU kernels ``mila_tpu/kernels/softmax_ce.py:_ce_fwd_kernel``
and ``_ce_bwd_kernel`` (entry ``fused_softmax_cross_entropy``, a custom
VJP). ``ops.softmax_cross_entropy`` routes here on every device, so the
trainer's loss runs these kernels on the card (JAX's trainer reaches the
same function as an XLA fusion of ``ops.softmax_cross_entropy``; the port
has no XLA to fuse it). CUDA tensors launch ``csrc/softmax_ce.cu``; CPU
tensors take the plain versions below.

What bounds it on the H100: bytes. The forward reads each logit once (824
MB of bf16 at GPT-2's [8192, 50304]); the backward reads it and writes its
gradient, recomputing the softmax from the logits as the TPU kernel does
rather than storing probabilities. One block per row. The backward holds
its row in shared memory, so the row is read from device memory once, where
the row fits the budget (``CE_RESIDENT_BYTES``: two blocks an SM) and its
bytes are a multiple of 16; else it streams the row twice
(:func:`ce_bwd_variant`). Short rows (the MNIST and CNN steps' V 10) take
a forward of their own, a warp per row or several rows a warp, reduced by
shuffles (:func:`ce_fwd_variant`); see the source.

The entry keeps JAX's signature: ``block_rows`` and ``interpret`` are the
TPU's tiling and interpreter and are not read, and JAX's gate (M % 8, V %
128, else its jnp reference) does not exist here: the kernel takes any M
and V, so the route is the same op at every shape. Rows whose target is
``ignore_index`` give loss 0 and gradient 0.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from mila_tpu_torch.kernels import _build


def fused_softmax_cross_entropy_plain(logits2: torch.Tensor, targets: torch.Tensor,
                                      ignore_index: int = -100) -> torch.Tensor:
    """Plain forward: logits [M, V], targets [M] -> loss f32 [M]."""
    fused_softmax_cross_entropy_plain.calls += 1
    x = logits2.float()
    m = x.amax(dim=-1, keepdim=True)
    lse = torch.log(torch.exp(x - m).sum(dim=-1, keepdim=True)) + m
    ignored = targets == ignore_index
    picked = torch.gather(x, 1, torch.where(ignored, 0, targets).long()[:, None])
    return torch.where(ignored, 0.0, (lse - picked)[:, 0])


fused_softmax_cross_entropy_plain.calls = 0


def fused_softmax_cross_entropy_bwd_plain(logits2: torch.Tensor, targets: torch.Tensor,
                                          g: torch.Tensor, ignore_index: int = -100):
    """Plain backward: (softmax - onehot) * g * valid in the logits' dtype."""
    fused_softmax_cross_entropy_bwd_plain.calls += 1
    x = logits2.float()
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    probs = e / e.sum(dim=-1, keepdim=True)
    del e
    valid = targets != ignore_index
    onehot = torch.zeros_like(probs).scatter_(1, torch.where(valid, targets, 0).long()[:, None],
                                              1.0)
    d = (probs - onehot) * g.float()[:, None] * valid.float()[:, None]
    return d.to(logits2.dtype)


fused_softmax_cross_entropy_bwd_plain.calls = 0


CE_SHORT_MAX_V = 256  # rows up to this many elements take the short forward
_FWD_VARIANTS = {"row": 0, "short": 1}  # csrc/softmax_ce.cu


def ce_fwd_variant(V: int, itemsize: int) -> str:
    """The forward kernel's variant for rows of V elements of ``itemsize``
    bytes: "short" (a warp per row, 32 / L rows a warp where V <= 16, shuffles
    only) up to ``CE_SHORT_MAX_V`` elements, "row" (a 256-thread block per
    row) above. The crossover is the card's (``chip_smoke.py``'s
    ``crossover`` phase, PERF.md row 18 (V 10)): at 128 rows the block per row is faster from V
    512, at 2048 rows the warp per row up to V 4096; 256 holds at both, in
    f32 and bf16 alike."""
    del itemsize
    return "short" if V <= CE_SHORT_MAX_V else "row"


CE_RESIDENT_BYTES = 112 * 1024  # a row held in shared memory: two 512-thread blocks an SM
_BWD_VARIANTS = {"resident": 0, "streamed": 1, "scalar": 2}  # csrc/softmax_ce.cu


def ce_bwd_variant(V: int, itemsize: int, smem: int = CE_RESIDENT_BYTES) -> str:
    """The backward kernel's variant for rows of V elements of ``itemsize``
    bytes: "resident" (the row read once into shared memory) where the row
    is a whole number of 16-byte chunks within ``smem`` bytes, "streamed"
    (read twice, 16-byte loads) where it is larger, "scalar" (read twice,
    one element at a time) where its bytes are not a multiple of 16."""
    row = V * itemsize
    if row % 16:
        return "scalar"
    return "resident" if row <= smem else "streamed"


def _lib() -> ctypes.CDLL:
    lib = _build.library("softmax_ce")
    if not getattr(lib, "_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.softmax_ce_fwd.argtypes = [vp, vp, vp, ci, ci, ci, ci, ci, vp]
        lib.softmax_ce_fwd.restype = ci
        lib.softmax_ce_bwd.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, vp]
        lib.softmax_ce_bwd.restype = ci
        lib._typed = True
    return lib


def _check(logits2: torch.Tensor, targets: torch.Tensor) -> None:
    if logits2.dtype not in _build.DTYPE_CODES:
        raise NotImplementedError(f"softmax_ce takes f32, bf16 or fp16 logits, got "
                                  f"{logits2.dtype}")
    if targets.device != logits2.device:
        raise ValueError("softmax_ce: logits and targets must be on one device")


def _fwd(logits2, t32, ignore_index, variant=None):
    if not logits2.is_cuda:
        return fused_softmax_cross_entropy_plain(logits2, t32, ignore_index)
    _check(logits2, t32)
    M, V = logits2.shape
    variant = variant or ce_fwd_variant(V, logits2.element_size())
    loss = torch.empty(M, device=logits2.device, dtype=torch.float32)
    lib = _lib()
    rc = lib.softmax_ce_fwd(_build.ptr(logits2), _build.ptr(t32), _build.ptr(loss), M, V,
                            ignore_index, _build.DTYPE_CODES[logits2.dtype],
                            _FWD_VARIANTS[variant], _build.stream_of(logits2))
    _build.check(lib, rc, "softmax_ce_fwd")
    fused_softmax_cross_entropy.launches += 1
    return loss


def fused_softmax_cross_entropy_bwd(logits2: torch.Tensor, targets: torch.Tensor,
                                    g: torch.Tensor, ignore_index: int = -100) -> torch.Tensor:
    """dlogits [M, V] in the logits' dtype for logits [M, V], int targets
    [M] and the loss rows' cotangent g [M]. CUDA tensors launch
    ``softmax_ce_bwd``; CPU tensors take the plain version."""
    t32 = targets.to(torch.int32).contiguous()
    g32 = g.float().contiguous()
    logits2 = logits2.contiguous()
    if not logits2.is_cuda:
        return fused_softmax_cross_entropy_bwd_plain(logits2, t32, g32, ignore_index)
    _check(logits2, t32)
    M, V = logits2.shape
    variant = ce_bwd_variant(V, logits2.element_size())
    if variant != "scalar" and logits2.data_ptr() % 16:  # 16-byte copies and loads
        logits2 = logits2.clone()
    d = torch.empty_like(logits2)
    lib = _lib()
    rc = lib.softmax_ce_bwd(_build.ptr(logits2), _build.ptr(t32), _build.ptr(g32), _build.ptr(d),
                            M, V, ignore_index, _build.DTYPE_CODES[logits2.dtype],
                            _BWD_VARIANTS[variant], _build.stream_of(logits2))
    _build.check(lib, rc, "softmax_ce_bwd")
    fused_softmax_cross_entropy_bwd.launches += 1
    return d


fused_softmax_cross_entropy_bwd.launches = 0


class _CEFn(torch.autograd.Function):
    """JAX's ``fused_softmax_cross_entropy`` custom VJP: the backward
    recomputes the softmax from the saved logits."""

    @staticmethod
    def forward(ctx, logits, targets, ignore_index):
        V = logits.shape[-1]
        logits2 = logits.reshape(-1, V).contiguous()
        t32 = targets.reshape(-1).to(torch.int32).contiguous()
        ctx.save_for_backward(logits2, t32)
        ctx.ignore_index = ignore_index
        ctx.shape = logits.shape
        return _fwd(logits2, t32, ignore_index).reshape(logits.shape[:-1])

    @staticmethod
    def backward(ctx, g):
        logits2, t32 = ctx.saved_tensors
        d = fused_softmax_cross_entropy_bwd(logits2, t32, g.reshape(-1), ctx.ignore_index)
        return d.reshape(ctx.shape), None, None


def fused_softmax_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                                ignore_index: int = -100, block_rows: int = 8,
                                interpret: Optional[bool] = None) -> torch.Tensor:
    """Per-example CE over the last axis: logits [..., V] (bf16, fp16 or f32),
    targets [...] int -> loss f32 [...], differentiable in the logits."""
    return _CEFn.apply(logits, targets, ignore_index)


fused_softmax_cross_entropy.launches = 0
