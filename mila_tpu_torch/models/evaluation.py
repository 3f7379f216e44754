"""Evaluation over batch iterables (port of ``mila_tpu/models/evaluation.py``):
mean loss, perplexity, the perplexity gap between two parameterizations of
one model (the quantization gate) and top-1 accuracy. Losses go through
``ops.softmax_cross_entropy`` (K13's forward on the card). Batches move to
the device of the params' first leaf; no gradients are taken."""

from __future__ import annotations

import math
from typing import Any, Iterable

import numpy as np
import torch

from mila_tpu_torch.ops import softmax_cross_entropy
from mila_tpu_torch.utils.tree import tree_leaves


def _device(params) -> torch.device:
    return next(p.device for p in tree_leaves(params) if isinstance(p, torch.Tensor))


def _put(a, device) -> torch.Tensor:
    t = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
    return t.to(device)


@torch.no_grad()
def dataset_loss(model, params: Any, batches: Iterable, *, max_batches: int = 0) -> float:
    """Mean softmax cross-entropy over (inputs, int targets) batches."""
    dev = _device(params)
    losses = []
    for i, (xb, yb) in enumerate(batches):
        if max_batches and i >= max_batches:
            break
        logits = model.apply(params, _put(xb, dev))
        losses.append(softmax_cross_entropy(logits, _put(yb, dev)).mean())
    if not losses:
        raise ValueError("no batches to evaluate")
    return float(torch.stack(losses).mean())


def perplexity(model, params: Any, batches: Iterable, *, max_batches: int = 0) -> float:
    """exp(mean cross-entropy), the exponent capped at 30."""
    return math.exp(min(dataset_loss(model, params, batches, max_batches=max_batches), 30.0))


def perplexity_delta(model, params_ref: Any, params_test: Any, batches_factory, *,
                     max_batches: int = 8) -> dict:
    """Perplexity of two parameterizations of ``model`` and their gap;
    ``batches_factory()`` gives a fresh batch iterator each call."""
    ppl_ref = perplexity(model, params_ref, batches_factory(), max_batches=max_batches)
    ppl_test = perplexity(model, params_test, batches_factory(), max_batches=max_batches)
    return {"ppl_ref": ppl_ref, "ppl_test": ppl_test, "delta": ppl_test - ppl_ref,
            "rel_delta": (ppl_test - ppl_ref) / ppl_ref}


@torch.no_grad()
def top1_accuracy(model, params: Any, batches: Iterable, *, max_batches: int = 0) -> float:
    """The mean over batches of each batch's top-1 accuracy."""
    dev = _device(params)
    accs = []
    for i, (xb, yb) in enumerate(batches):
        if max_batches and i >= max_batches:
            break
        pred = model.apply(params, _put(xb, dev)).argmax(dim=-1)
        accs.append((pred == _put(yb, dev)).float().mean())
    return float(torch.stack(accs).mean())
