"""MNIST MLP training (port of ``examples/mnist_train.py``): the
784-128-64-10 classifier through ``Model`` with AdamW, on the MNIST files
when ``--data-dir`` holds them and on the synthetic surrogate otherwise.
Exits 1 unless the test accuracy reaches 97.5 %.

Usage: python -m mila_tpu_torch.examples.mnist_train [--epochs N]
       [--batch-size B] [--device auto|gpu|cuda:N|cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

import mila_tpu_torch
from mila_tpu_torch.data import MnistReader
from mila_tpu_torch.models import (
    MLPClassifier,
    MLPClassifierConfig,
    Model,
    ModelConfig,
    accuracy,
)
from mila_tpu_torch.optim import AdamW, AdamWConfig
from mila_tpu_torch.runtime import get_device
from mila_tpu_torch.runtime.device import platform_of
from mila_tpu_torch.utils.logging import Logger
from mila_tpu_torch.utils.rng import generator


def main() -> int:
    ap = argparse.ArgumentParser(description="MNIST MLP (784-128-64-10) training")
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default="auto")
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--synthetic-n", type=int, default=12000)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--checkpoint", default="")
    args = ap.parse_args()

    mila_tpu_torch.initialize(seed=args.seed)
    dev = get_device(args.device)
    Logger.info("training on {} ({})", dev, platform_of(dev))

    train = MnistReader(
        batch_size=args.batch_size, split="train",
        data_dir=args.data_dir, synthetic_n=args.synthetic_n, seed=args.seed,
    )
    test = MnistReader(
        batch_size=512, split="test", data_dir=args.data_dir,
        synthetic_n=args.synthetic_n // 5, shuffle=False, drop_last=False,
    )
    Logger.info(
        "dataset: {} train / {} test examples{}",
        len(train), len(test), " (synthetic surrogate)" if train.is_synthetic else "",
    )

    model = Model(
        MLPClassifier(MLPClassifierConfig(name="mnist")),
        AdamW(AdamWConfig(learning_rate=args.lr)),
        ModelConfig(name="mnist", epochs=args.epochs),
        device=dev,
    )
    model.build(generator(args.seed, dev), (args.batch_size, 784))
    Logger.info("model parameters: {}", model.parameter_count())

    t0 = time.monotonic()
    model.train(train)
    Logger.info("training wall time: {:.1f}s", time.monotonic() - t0)

    logits, targets = [], []
    for xb, yb in test:
        logits.append(model.predict(xb))
        targets.append(yb)
    acc = accuracy(torch.cat(logits), np.concatenate(targets))
    thr = np.mean(model.history.samples_per_sec[1:]) if args.epochs > 1 else (
        model.history.samples_per_sec[0]
    )
    print(f"final test accuracy: {acc * 100:.2f}%")
    print(f"training throughput: {thr:,.0f} samples/sec (reference: ~136,000 on CUDA)")

    if args.checkpoint:
        path = model.save_checkpoint(args.checkpoint, epoch=args.epochs - 1)
        Logger.info("checkpoint saved: {}", path)
    return 0 if acc >= 0.975 else 1


if __name__ == "__main__":
    raise SystemExit(main())
