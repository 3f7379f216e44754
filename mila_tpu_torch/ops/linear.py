"""Dense layer forward (port of ``mila_tpu/ops/linear.py``): x @ w (+ b)
with weights [in, out], accumulated in f32 and returned in x's dtype.

A plain matrix product outside any kernel; f32 inputs run in full f32
(``torch.backends.cuda.matmul.allow_tf32`` stays at its default, False),
as JAX's ``Precision.HIGHEST`` does.
"""

from __future__ import annotations

from typing import Optional

import torch


def linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    y = torch.matmul(x.float(), w.float())
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype)
