"""RGB framebuffer and heatmap rendering, ASCII and PPM (port of
``mila_tpu/viz/framebuffer.py``).

Rendering is host work: a tensor is copied to the host once
(``tensor.tensor_ops.to_host``, float32) and everything after is the same
numpy arithmetic as JAX's, so the PPM bytes and the ASCII text are JAX's
for the same values.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np

from mila_tpu_torch.tensor.tensor_ops import to_host

ASCII_RAMP = " .:-=+*#%@"


class FrameBuffer:
    """RGB8 framebuffer: ``pixels`` [height, width, 3] uint8."""

    def __init__(self, width: int, height: int):
        if width <= 0 or height <= 0:
            raise ValueError("framebuffer dims must be positive")
        self.width = width
        self.height = height
        self.pixels = np.zeros((height, width, 3), np.uint8)

    def clear(self, rgb=(0, 0, 0)) -> None:
        self.pixels[:] = np.asarray(rgb, np.uint8)

    def set_pixel(self, x: int, y: int, rgb) -> None:
        if 0 <= x < self.width and 0 <= y < self.height:
            self.pixels[y, x] = np.asarray(rgb, np.uint8)

    def blit(self, x: int, y: int, img: np.ndarray) -> None:
        h, w = img.shape[:2]
        x1, y1 = min(x + w, self.width), min(y + h, self.height)
        if x < x1 and y < y1:
            self.pixels[y:y1, x:x1] = img[: y1 - y, : x1 - x]

    def to_ppm(self, path: str | Path) -> None:
        with open(path, "wb") as f:
            f.write(f"P6 {self.width} {self.height} 255\n".encode())
            f.write(self.pixels.tobytes())


# A five-stop viridis-like ramp.
_STOPS = np.array(
    [[68, 1, 84], [59, 82, 139], [33, 145, 140], [94, 201, 98], [253, 231, 37]],
    np.float32,
)


def _host(x) -> np.ndarray:
    return np.asarray(to_host(x) if hasattr(x, "detach") else x, np.float32)


def colormap(values) -> np.ndarray:
    """[H, W] values in [0, 1] -> [H, W, 3] uint8 through the ramp."""
    v = np.clip(_host(values), 0.0, 1.0)
    pos = v * (len(_STOPS) - 1)
    lo = np.floor(pos).astype(int)
    hi = np.minimum(lo + 1, len(_STOPS) - 1)
    frac = (pos - lo)[..., None]
    rgb = _STOPS[lo] * (1 - frac) + _STOPS[hi] * frac
    return rgb.astype(np.uint8)


class HeatMapRenderer:
    """A tensor as a heatmap normalized to its own range, strided down to
    ``max_size`` per side."""

    def __init__(self, max_size: int = 256):
        self.max_size = max_size

    def _prepare(self, tensor) -> np.ndarray:
        arr = _host(tensor)
        if arr.ndim == 1:
            arr = arr[None, :]
        while arr.ndim > 2:
            arr = arr.reshape(-1, arr.shape[-1])
        sy = max(1, arr.shape[0] // self.max_size)
        sx = max(1, arr.shape[1] // self.max_size)
        arr = arr[::sy, ::sx]
        lo, hi = float(arr.min()), float(arr.max())
        return (arr - lo) / (hi - lo + 1e-12)

    def render_rgb(self, tensor) -> np.ndarray:
        return colormap(self._prepare(tensor))

    def render_ascii(self, tensor, width: int = 64) -> str:
        norm = self._prepare(tensor)
        sy = max(1, norm.shape[0] // (width // 2))
        sx = max(1, norm.shape[1] // width)
        small = norm[::sy, ::sx]
        idx = (small * (len(ASCII_RAMP) - 1)).astype(int)
        return "\n".join("".join(ASCII_RAMP[i] for i in row) for row in idx)

    def render_to(self, fb: FrameBuffer, tensor, x: int = 0, y: int = 0) -> None:
        fb.blit(x, y, self.render_rgb(tensor))


def render_training_curve(losses, width: int = 60, height: int = 12,
                          label: str = "loss") -> str:
    """An ASCII plot of per-epoch losses."""
    if not len(losses):
        return "(no data)"
    vals = _host(losses)
    lo, hi = float(vals.min()), float(vals.max())
    span = hi - lo + 1e-12
    cols = np.interp(np.linspace(0, len(vals) - 1, width), np.arange(len(vals)), vals)
    grid = [[" "] * width for _ in range(height)]
    for xcol, v in enumerate(cols):
        yrow = int((1.0 - (v - lo) / span) * (height - 1))
        grid[yrow][xcol] = "*"
    lines = ["".join(r) for r in grid]
    return f"{label}: {hi:.4g} (max)\n" + "\n".join(lines) + f"\n{label}: {lo:.4g} (min)"


def _named_leaves(tree, prefix: tuple = ()) -> list:
    """(path, leaf) in JAX's flatten order: dict keys sorted, list items
    as ``[i]``, a QTensor's fields as ``.q`` and ``.scale``."""
    if isinstance(tree, dict):
        return [nl for k in sorted(tree) for nl in _named_leaves(tree[k], prefix + (str(k),))]
    if hasattr(tree, "_fields"):  # QTensor and other named tuples
        return [nl for f in tree._fields for nl in _named_leaves(getattr(tree, f),
                                                                  prefix + (f".{f}",))]
    if isinstance(tree, (list, tuple)):
        return [nl for i, v in enumerate(tree) for nl in _named_leaves(v, prefix + (f"[{i}]",))]
    return [(prefix, tree)]


def visualize_params(params, renderer: Optional[HeatMapRenderer] = None) -> str:
    """An ASCII heatmap per parameter of at least 4 elements."""
    renderer = renderer or HeatMapRenderer()
    out = []
    for path, leaf in _named_leaves(params):
        if not hasattr(leaf, "shape"):
            continue
        arr = _host(leaf)
        if arr.ndim < 1 or arr.size < 4:
            continue
        out.append(f"--- {'/'.join(path)} {arr.shape} ---")
        out.append(renderer.render_ascii(arr, width=48))
    return "\n".join(out)
