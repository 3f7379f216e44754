"""GPT-2 training over tokenized shards, llm.c style (port of
``examples/gpt2_train.py``): ``TokenReader`` shards (byte-level
TinyShakespeare tokens when no shards are given), AdamW with a clip and a
warmup-cosine schedule, validation every ``--val-every`` steps, a
checkpoint, and ``--quant-eval``'s perplexity gap of int8, fp8 and int4
weight-only quantization on the validation batches.

JAX jits ``train_step`` and ``val_loss_fn``; here they run eagerly
(autograd through the port's GPT-2: softmax-CE and AdamW run their CUDA
kernels on the GPU, and quantized weights the int8/fp8 GEMM).

Usage:
  python -m mila_tpu_torch.examples.gpt2_train --shards "data/*.bin" --steps 2000
  python -m mila_tpu_torch.examples.gpt2_train --steps 500    # byte-level fallback
"""

from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch

import mila_tpu_torch
from mila_tpu_torch.data import TokenReader, load_tiny_shakespeare
from mila_tpu_torch.data.loader import DatasetReader
from mila_tpu_torch.models.gpt2 import GPT2, GPT2Config
from mila_tpu_torch.models.model import value_and_grad
from mila_tpu_torch.ops import softmax_cross_entropy
from mila_tpu_torch.optim import AdamW, AdamWConfig, warmup_cosine
from mila_tpu_torch.runtime import default_context
from mila_tpu_torch.serialization import save_checkpoint
from mila_tpu_torch.utils.logging import Logger
from mila_tpu_torch.utils.rng import generator


class _ByteReader(DatasetReader):
    """Byte-level token stream over TinyShakespeare (the fallback corpus):
    the first 90 % for "train", the rest for "val"."""

    def __init__(self, batch_size, seq_len, split="train", **kw):
        super().__init__(batch_size, **kw)
        data = load_tiny_shakespeare()
        if data is None:
            raise FileNotFoundError("no corpus available")
        n = len(data)
        cut = int(n * 0.9)
        raw = data[:cut] if split == "train" else data[cut:]
        self.tokens = np.frombuffer(raw, np.uint8).astype(np.int32)
        self.seq_len = seq_len
        n_windows = (len(self.tokens) - 1) // seq_len
        self._starts = (np.arange(n_windows) * seq_len)[
            self.process_rank:: self.num_processes
        ]

    def __len__(self):
        return len(self._starts)

    def next_batch(self, index):
        lo = index * self.batch_size
        sel = self._starts[lo: lo + self.batch_size]
        idx = sel[:, None] + np.arange(self.seq_len + 1)[None]
        chunk = self.tokens[idx]
        return chunk[:, :-1], chunk[:, 1:]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shards", default="", help="glob of tokenized .bin shards")
    ap.add_argument("--val-shards", default="")
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--layers", type=int, default=6)
    ap.add_argument("--dim", type=int, default=384)
    ap.add_argument("--heads", type=int, default=6)
    ap.add_argument("--val-every", type=int, default=250)
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--quant-eval", action="store_true",
        help="after training, report BF16-vs-quantized val perplexity deltas "
             "(the BASELINE config-3 gate, runnable at 124M scale)",
    )
    args = ap.parse_args()

    mila_tpu_torch.initialize(seed=args.seed)
    dev = default_context().device
    if args.shards:
        train = TokenReader(args.shards, args.batch_size, args.seq_len, shuffle=True)
        val = TokenReader(args.val_shards or args.shards, args.batch_size, args.seq_len)
        vocab = int(train.tokens.max()) + 1
    else:
        train = _ByteReader(args.batch_size, args.seq_len, "train")
        val = _ByteReader(args.batch_size, args.seq_len, "val")
        vocab = 256
    Logger.info("corpus: {} train windows, vocab {}", len(train), vocab)

    cfg = GPT2Config(
        name="gpt2-train", vocab_size=vocab, max_seq_len=args.seq_len,
        num_layers=args.layers, num_heads=args.heads, embedding_dim=args.dim,
    )
    model = GPT2(cfg, device=dev)
    params = model.init(generator(args.seed, dev), (args.batch_size, args.seq_len))
    opt = AdamW(AdamWConfig(learning_rate=args.lr, grad_clip_norm=1.0))
    opt_state = opt.init(params)
    sched = warmup_cosine(args.lr, max(args.steps // 20, 1), args.steps)

    def train_step(params, opt_state, xb, yb):
        loss, grads = value_and_grad(
            lambda p: softmax_cross_entropy(model.apply(p, xb), yb).mean(), params)
        return *opt.step(opt_state, params, grads, lr=sched(opt_state.step)), loss

    @torch.no_grad()
    def val_loss_fn(params, xb, yb):
        return softmax_cross_entropy(model.apply(params, xb), yb).mean()

    step, t0 = 0, time.monotonic()
    while step < args.steps:
        train.reset()
        for xb, yb in train:
            params, opt_state, loss = train_step(
                params, opt_state, torch.as_tensor(xb, device=dev), torch.as_tensor(yb, device=dev))
            if step % args.val_every == 0:
                vl = float(
                    torch.stack(
                        [val_loss_fn(params, torch.as_tensor(x, device=dev),
                                     torch.as_tensor(y, device=dev))
                         for x, y in [val.next_batch(i) for i in range(4)]]
                    ).mean()
                )
                Logger.info(
                    "step {}: train_loss={:.4f} val_loss={:.4f} val_ppl={:.2f}",
                    step, float(loss), vl, math.exp(min(vl, 20)),
                )
            step += 1
            if step >= args.steps:
                break
    dt = time.monotonic() - t0
    tokens = args.steps * args.batch_size * args.seq_len
    print(f"trained {args.steps} steps, {tokens/dt:,.0f} tokens/sec (incl. compile)")
    print(f"final train loss {float(loss):.4f}")
    if args.checkpoint:
        save_checkpoint(args.checkpoint, params, opt_state=opt_state, model_config=cfg)
        Logger.info("checkpoint: {}", args.checkpoint)

    if args.quant_eval:
        from mila_tpu_torch.inference.quantize import quantize_model_params
        from mila_tpu_torch.models.evaluation import perplexity_delta

        def batches():
            for i in range(8):
                yield val.next_batch(i)

        for qdt in ("int8", "fp8_e4m3", "int4"):
            qparams = quantize_model_params(params, qdt, min_size=4096, device=dev)
            report = perplexity_delta(model, params, qparams, batches)
            print(
                f"quantization gate [{qdt}]: ppl bf16={report['ppl_ref']:.4f} "
                f"{qdt}={report['ppl_test']:.4f} delta={report['delta']:+.4f} "
                f"({report['rel_delta']*100:+.2f}%)"
            )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
