"""Dense layer (port of ``mila_tpu/ops/linear.py``): y = x @ w (+ b) with
weights [in, out], accumulated in f32 and returned in x's dtype, with JAX's
manual VJP as a ``torch.autograd.Function``:

    dx = (g @ w^T).to(x.dtype),  dw = (x^T @ g).to(w.dtype),
    db = sum(g, batch axes, f32).to(g.dtype)

every product accumulated in f32. A plain matrix product outside any
kernel (the JAX package leaves it to XLA). On the CPU the operands are
widened to f32 first; on the card a bf16 or fp16 product runs as such on
cuBLAS with reduced-precision reductions switched off for the call
(PyTorch allows them by default, and a split-K product, likely for the
weight gradient's reduction over B·T rows, would then sum its partial
products in the operands' dtype). So cuBLAS accumulates in f32 and rounds
once to the operands' dtype, the same result as JAX's
``preferred_element_type=f32`` then ``astype`` up to summation order. f32
operands run in full f32 (``torch.backends.cuda.matmul.allow_tf32`` stays
at its default, False), as JAX's ``Precision.HIGHEST`` does.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

_HALF = (torch.bfloat16, torch.float16)


@contextlib.contextmanager
def _f32_reduction():
    """cuBLAS half-precision products inside sum their split-K partials in f32."""
    flags = torch.backends.cuda.matmul
    saved = (flags.allow_bf16_reduced_precision_reduction,
             flags.allow_fp16_reduced_precision_reduction)
    flags.allow_bf16_reduced_precision_reduction = False
    flags.allow_fp16_reduced_precision_reduction = False
    try:
        yield
    finally:
        (flags.allow_bf16_reduced_precision_reduction,
         flags.allow_fp16_reduced_precision_reduction) = saved


def matmul(a: torch.Tensor, b: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """a @ b accumulated in f32, rounded once to ``out_dtype``."""
    if a.is_cuda and a.dtype == b.dtype and a.dtype in _HALF:
        with _f32_reduction():
            y = torch.matmul(a, b)
        return y if out_dtype == a.dtype else y.to(out_dtype)
    return torch.matmul(a.float(), b.float()).to(out_dtype)


def _forward(x, w, b):
    if b is None:
        return matmul(x, w, x.dtype)
    if x.is_cuda and x.dtype == w.dtype and x.dtype in _HALF and b.dtype == x.dtype:
        # The bias joins cuBLAS's f32 epilogue before the one rounding.
        with _f32_reduction():
            y = torch.addmm(b, x.reshape(-1, x.shape[-1]), w)
        return y.reshape(*x.shape[:-1], w.shape[1])
    return (matmul(x, w, torch.float32) + b.float()).to(x.dtype)


class _LinearFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        ctx.has_bias = b is not None
        return _forward(x, w, b)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        x2 = x.reshape(-1, x.shape[-1])
        dx = matmul(g, w.t(), x.dtype) if ctx.needs_input_grad[0] else None
        if w.dim() == 2 and not w.is_contiguous() and w.t().is_contiguous():
            # w is a transposed view (a tied head's wte^T): dw in the layout
            # of the tensor it views, so the view's backward hands that
            # parameter a contiguous gradient (AdamW's kernels read it as is).
            dw = matmul(g2.t(), x2, w.dtype).t()
        else:
            dw = matmul(x2.t(), g2, w.dtype)
        db = g2.sum(dim=0, dtype=torch.float32).to(g.dtype) if ctx.has_bias else None
        return dx, dw, db


def linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [..., in] @ w [in, out] (+ b [out]) -> [..., out] in x's dtype."""
    return _LinearFn.apply(x, w, b)


def linear_gelu(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
                approximation: str = "tanh") -> torch.Tensor:
    """Linear then GELU (JAX's ``"FusedOp"``): two ops, each with its VJP."""
    from mila_tpu_torch.ops.gelu import gelu

    return gelu(linear(x, w, b), approximation)
