"""Visualization (port of ``mila_tpu/viz``): framebuffer, heatmaps, curves."""

from mila_tpu_torch.viz.framebuffer import (
    FrameBuffer,
    HeatMapRenderer,
    colormap,
    render_training_curve,
    visualize_params,
)

__all__ = [
    "FrameBuffer",
    "HeatMapRenderer",
    "colormap",
    "render_training_curve",
    "visualize_params",
]
