"""Character language model on TinyShakespeare (port of
``examples/charlm_train.py``): the char_lm GPT-2 preset trained with AdamW
under a warmup-cosine schedule, printing loss and perplexity, then a
sample through the KV-cache ``Generator``; ``--quant-eval`` reports the
perplexity gap of int8, fp8 and int4 weight-only quantization.

JAX jits the train step; here it runs eagerly (autograd through the
port's ops: softmax-CE and AdamW run their CUDA kernels on the GPU).

Usage: python -m mila_tpu_torch.examples.charlm_train [--steps N] [--sample N]
"""

from __future__ import annotations

import argparse
import math
import time

import torch

import mila_tpu_torch
from mila_tpu_torch.data import CharReader, load_tiny_shakespeare
from mila_tpu_torch.inference import Generator, SamplingConfig
from mila_tpu_torch.models.gpt2 import GPT2, GPT2Config
from mila_tpu_torch.models.model import value_and_grad
from mila_tpu_torch.ops import softmax_cross_entropy
from mila_tpu_torch.optim import AdamW, AdamWConfig, warmup_cosine
from mila_tpu_torch.runtime import default_context
from mila_tpu_torch.utils.logging import Logger
from mila_tpu_torch.utils.rng import generator
from mila_tpu_torch.utils.tree import tree_leaves


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--sample", type=int, default=200, help="chars to sample at end")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--checkpoint", default="", help="save final weights here")
    ap.add_argument(
        "--quant-eval", action="store_true",
        help="report BF16 vs INT8 weight-only perplexity delta (BASELINE gate)",
    )
    ap.add_argument("--layers", type=int, default=0, help="0 = char_lm preset")
    ap.add_argument("--dim", type=int, default=0)
    ap.add_argument("--heads", type=int, default=0)
    args = ap.parse_args()

    mila_tpu_torch.initialize(seed=args.seed)
    dev = default_context().device
    text = load_tiny_shakespeare()
    if text is None:
        Logger.error("TinyShakespeare corpus not found")
        return 2
    reader = CharReader(text, args.batch_size, args.seq_len, seed=args.seed)
    V = reader.vocab.size
    Logger.info("corpus: {} chars, vocab {}", len(text), V)

    cfg = GPT2Config.char_lm(vocab_size=V).replace(max_seq_len=max(args.seq_len * 2, 256))
    if args.layers:
        cfg = cfg.replace(num_layers=args.layers)
    if args.dim:
        cfg = cfg.replace(embedding_dim=args.dim)
    if args.heads:
        cfg = cfg.replace(num_heads=args.heads)
    model = GPT2(cfg, device=dev)
    params = model.init(generator(args.seed, dev), (args.batch_size, args.seq_len))
    opt = AdamW(AdamWConfig(learning_rate=args.lr, grad_clip_norm=1.0))
    opt_state = opt.init(params)
    sched = warmup_cosine(args.lr, args.steps // 10 + 1, args.steps)
    n_params = sum(p.numel() for p in tree_leaves(params))
    Logger.info("model parameters: {:,}", n_params)

    def train_step(params, opt_state, xb, yb):
        loss, grads = value_and_grad(
            lambda p: softmax_cross_entropy(model.apply(p, xb), yb).mean(), params)
        params, opt_state = opt.step(opt_state, params, grads, lr=sched(opt_state.step))
        return params, opt_state, loss

    t0 = time.monotonic()
    step = 0
    tokens_seen = 0
    while step < args.steps:
        reader.reset()
        for xb, yb in reader:
            params, opt_state, loss = train_step(
                params, opt_state, torch.as_tensor(xb, device=dev), torch.as_tensor(yb, device=dev))
            tokens_seen += xb.size
            if step % 50 == 0:
                ppl = math.exp(min(float(loss), 20.0))
                Logger.info("step {}: loss={:.4f} perplexity={:.3f}", step, float(loss), ppl)
            step += 1
            if step >= args.steps:
                break
    dt = time.monotonic() - t0
    final_ppl = math.exp(min(float(loss), 20.0))
    print(f"final loss {float(loss):.4f}, char perplexity {final_ppl:.3f} "
          f"(reference target < 2.0 after full training)")
    print(f"throughput: {tokens_seen / dt:,.0f} tokens/sec")

    if args.checkpoint:
        from mila_tpu_torch.models.export import export_model

        export_model(args.checkpoint, model, params)
        Logger.info("weights exported to {}", args.checkpoint)

    if args.quant_eval:
        from mila_tpu_torch.inference.quantize import quantize_model_params
        from mila_tpu_torch.models.evaluation import perplexity_delta

        val = CharReader(text, 16, args.seq_len, shuffle=False, seed=123)

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

    if args.sample > 0:
        gen = Generator(model, params, max_len=cfg.max_seq_len)
        prompt = torch.as_tensor(reader.vocab.encode("ROMEO:"), dtype=torch.int32)[None]
        out = gen.generate(
            prompt, args.sample, generator=torch.Generator(device=dev).manual_seed(0),
            sampling=SamplingConfig(temperature=0.8, top_k=40),
        )
        print("--- sample ---")
        print(reader.vocab.decode(out[0].cpu().numpy()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
