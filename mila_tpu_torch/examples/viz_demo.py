"""Visualization (port of ``examples/viz_demo.py``): train a small MLP,
then print its training curve and a weight heatmap as text, and write the
first layer's weights as a PPM image with ``--ppm-out``.

Usage: python -m mila_tpu_torch.examples.viz_demo [--epochs N] [--ppm-out w.ppm]
"""

from __future__ import annotations

import argparse

import mila_tpu_torch
from mila_tpu_torch.data import MnistReader
from mila_tpu_torch.models import MLPClassifier, MLPClassifierConfig, Model, ModelConfig
from mila_tpu_torch.runtime import default_context
from mila_tpu_torch.utils.rng import generator
from mila_tpu_torch.viz import (
    FrameBuffer,
    HeatMapRenderer,
    render_training_curve,
    visualize_params,
)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--ppm-out", default="", help="write weight heatmap PPM here")
    args = ap.parse_args()

    mila_tpu_torch.initialize(0)
    train = MnistReader(batch_size=128, synthetic_n=2048)
    dev = default_context().device
    model = Model(
        MLPClassifier(MLPClassifierConfig(hidden_dims=(64, 32))),
        config=ModelConfig(epochs=args.epochs, verbose=False),
        device=dev,
    )
    model.build(generator(0, dev), (128, 784))
    model.train(train)

    print(render_training_curve(model.history.train_losses, label="train loss"))
    print()
    print(visualize_params({"fc1": model.params["fc1"]}))

    if args.ppm_out:
        fb = FrameBuffer(512, 256)
        HeatMapRenderer(max_size=256).render_to(fb, model.params["fc1"]["weight"])
        fb.to_ppm(args.ppm_out)
        print(f"wrote {args.ppm_out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
