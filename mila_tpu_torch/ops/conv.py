"""2-D convolution and pooling in NHWC with HWIO weights (port of
``mila_tpu/ops/conv.py``).

JAX computes these outside any Pallas kernel (``lax.conv_general_dilated``
and ``lax.reduce_window``), so the port calls PyTorch's own: ``F.conv2d``
(cuDNN on the card), ``F.max_pool2d`` and ``F.avg_pool2d``, on NCHW-shaped
views of the NHWC tensors (channels-last strides, no copy).

``conv2d`` widens x and w to f32, adds the bias in f32 and rounds once to
x's dtype, as JAX's ``preferred_element_type=f32`` then ``astype`` does. Its
backward is a ``torch.autograd.Function`` of its own, so that both
directions run in true f32 on the card: cuDNN may use TF32 for f32
convolutions (``torch.backends.cudnn.allow_tf32`` defaults to True), and
the flag is switched off for each call and restored after it, as
``ops/linear.py`` does for cuBLAS's reduced-precision sums. SAME padding
is JAX's: per spatial axis the output is ceil(size / stride) and the
padding total (out - 1) * stride + k - size splits as lo = total // 2, hi
= total - lo, padded explicitly (PyTorch's ``padding="same"`` refuses a
stride above 1).

``max_pool2d`` sends each window's gradient to its first maximum in
row-major order, as XLA's select-and-scatter does (PyTorch keeps the
first of equal values); ``avg_pool2d`` is the window's sum over its size.
Both use VALID windows and differentiate through PyTorch's autograd.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def _true_f32():
    """cuDNN's f32 convolutions inside run without TF32."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def _same_pad(size: int, k: int, s: int) -> tuple[int, int]:
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _nchw32(x: torch.Tensor, pads: tuple[int, int, int, int]) -> torch.Tensor:
    """NHWC x -> f32 NCHW (a view unless padded); pads (hlo, hhi, wlo, whi)."""
    y = x.float().permute(0, 3, 1, 2)
    if any(pads):
        hlo, hhi, wlo, whi = pads
        y = F.pad(y, (wlo, whi, hlo, hhi))
    return y


class _Conv2dFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, stride, pads):
        w32 = w.float().permute(3, 2, 0, 1)  # HWIO -> OIHW
        with _true_f32():
            y = F.conv2d(_nchw32(x, pads), w32, None, stride)
        if b is not None:
            y = y + b.float()[:, None, None]
        ctx.save_for_backward(x, w)
        ctx.cfg = (stride, pads, None if b is None else b.dtype)
        return y.permute(0, 2, 3, 1).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride, pads, b_dtype = ctx.cfg
        g32 = g.float().permute(0, 3, 1, 2)
        need_x, need_w = ctx.needs_input_grad[:2]
        with _true_f32():
            dx, dw, _ = torch.ops.aten.convolution_backward(
                g32, _nchw32(x, pads), w.float().permute(3, 2, 0, 1), None, list(stride),
                [0, 0], [1, 1], False, [0, 0], 1, [need_x, need_w, False])
        if dx is not None:
            hlo, _, wlo, _ = pads
            H, W = x.shape[1], x.shape[2]
            dx = dx[:, :, hlo:hlo + H, wlo:wlo + W].permute(0, 2, 3, 1).to(x.dtype)
        if dw is not None:
            dw = dw.permute(2, 3, 1, 0).to(w.dtype)
        db = None if b_dtype is None else g32.sum(dim=(0, 2, 3)).to(b_dtype)
        return dx, dw, db, None, None


def conv2d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None, *,
           stride: int | tuple[int, int] = 1, padding: str = "SAME") -> torch.Tensor:
    """x [B, H, W, Cin], w [KH, KW, Cin, Cout], b [Cout] -> [B, OH, OW, Cout]
    in x's dtype."""
    if isinstance(stride, int):
        stride = (stride, stride)
    if padding == "SAME":
        pads = (*_same_pad(x.shape[1], w.shape[0], stride[0]),
                *_same_pad(x.shape[2], w.shape[1], stride[1]))
    elif padding == "VALID":
        pads = (0, 0, 0, 0)
    else:
        raise ValueError(f"padding must be SAME or VALID, got {padding!r}")
    return _Conv2dFn.apply(x, w, b, tuple(stride), pads)


def max_pool2d(x: torch.Tensor, window: int = 2, stride: Optional[int] = None) -> torch.Tensor:
    """VALID max pooling over H and W of x [B, H, W, C]."""
    stride = stride or window
    return F.max_pool2d(x.permute(0, 3, 1, 2), window, stride).permute(0, 2, 3, 1)


def avg_pool2d(x: torch.Tensor, window: int = 2, stride: Optional[int] = None) -> torch.Tensor:
    """VALID mean pooling over H and W of x [B, H, W, C]."""
    stride = stride or window
    return F.avg_pool2d(x.permute(0, 3, 1, 2), window, stride).permute(0, 2, 3, 1)
