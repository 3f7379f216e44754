"""GPT-2 generation (port of ``examples/gpt2_generate.py``): load an llm.c
checkpoint (or draw random weights), optionally quantize the weights to
int8 or fp8 (weight-only), and generate through the KV-cache
``Generator``, or speculatively with a small random draft
(``--speculative-k``). ``--temperature 0`` is greedy. Prints the token ids,
or the text with ``--tokenizer``.

Usage:
  python -m mila_tpu_torch.examples.gpt2_generate --checkpoint gpt2_124M.bin \\
      --tokenizer gpt2_tokenizer.bin --prompt-ids 464,3290 --tokens 64
  python -m mila_tpu_torch.examples.gpt2_generate --random-init --tokens 32 --quantize int8
  python -m mila_tpu_torch.examples.gpt2_generate --random-init --tokens 32 --speculative-k 4
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

import mila_tpu_torch
from mila_tpu_torch.inference import Generator, SamplingConfig
from mila_tpu_torch.inference.quantize import model_bytes, quantize_model_params
from mila_tpu_torch.models.gpt2 import GPT2, GPT2Config
from mila_tpu_torch.runtime import default_context
from mila_tpu_torch.serialization.checkpoint import to_device_tree
from mila_tpu_torch.serialization.llmc import GPT2Tokenizer, read_gpt2_checkpoint
from mila_tpu_torch.tensor.dtypes import torch_dtype
from mila_tpu_torch.utils.logging import Logger
from mila_tpu_torch.utils.rng import generator
from mila_tpu_torch.utils.tree import tree_leaves


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint", default="", help="llm.c gpt2 .bin checkpoint")
    ap.add_argument("--tokenizer", default="", help="llm.c gpt2_tokenizer.bin")
    ap.add_argument("--random-init", action="store_true")
    ap.add_argument("--prompt-ids", default="50256", help="comma-separated token ids")
    ap.add_argument("--tokens", type=int, default=64)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--top-k", type=int, default=40)
    ap.add_argument("--quantize", default="", choices=["", "int8", "fp8_e4m3"])
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--speculative-k", type=int, default=0,
                    help="draft k tokens per round with a small draft model")
    ap.add_argument("--draft-layers", type=int, default=1,
                    help="layers of the (random-init) draft model")
    args = ap.parse_args()

    mila_tpu_torch.initialize(seed=args.seed)
    dev = default_context().device

    if args.checkpoint:
        Logger.info("loading llm.c checkpoint {}", args.checkpoint)
        cfg, raw_params = read_gpt2_checkpoint(args.checkpoint, device="cpu")
        params = to_device_tree(raw_params, dtype=torch_dtype(args.dtype), device=dev)
        model = GPT2(cfg, device=dev)
    elif args.random_init:
        cfg = GPT2Config(
            name="gpt2-rand", vocab_size=50257, max_seq_len=512,
            num_layers=4, num_heads=8, embedding_dim=256, param_dtype=args.dtype,
        )
        model = GPT2(cfg, device=dev)
        params = model.init(generator(args.seed, dev), (1, 64))
    else:
        Logger.error("pass --checkpoint or --random-init")
        return 2
    n_params = sum(p.numel() for p in tree_leaves(params))
    Logger.info("model: {} ({:,} params)", cfg.name, n_params)

    if args.quantize:
        before = model_bytes(params)
        params = quantize_model_params(params, args.quantize, device=dev)
        Logger.info(
            "quantized weights {} → {:.1f} MB (from {:.1f} MB)",
            args.quantize, model_bytes(params) / 1e6, before / 1e6,
        )

    prompt = np.array([[int(t) for t in args.prompt_ids.split(",")]], np.int32)
    max_len = min(cfg.max_seq_len, prompt.shape[1] + args.tokens + args.speculative_k + 2)
    if args.speculative_k > 0:
        from mila_tpu_torch.inference import SpeculativeGenerator

        draft_cfg = cfg.replace(name=cfg.name + "-draft", num_layers=args.draft_layers)
        draft = GPT2(draft_cfg, device=dev)
        draft_params = draft.init(generator(args.seed + 1, dev), (1, 64))
        gen = SpeculativeGenerator(model, params, draft, draft_params,
                                   k=args.speculative_k, max_len=max_len)
    else:
        gen = Generator(model, params, max_len=max_len)
    t0 = time.monotonic()
    out = gen.generate(
        torch.from_numpy(prompt), args.tokens,
        generator=torch.Generator(device=dev).manual_seed(args.seed),
        sampling=SamplingConfig(temperature=args.temperature, top_k=args.top_k),
    )
    ids = out[0].cpu().numpy()  # waits for the device
    dt = time.monotonic() - t0
    print(f"generated {args.tokens} tokens in {dt:.2f}s "
          f"({args.tokens / dt:.1f} tok/s, incl. compile)")
    if args.speculative_k > 0:
        print(f"speculative acceptance: {gen.acceptance_rate:.2%} "
              f"over {gen.stats['rounds']} rounds")
    if args.tokenizer:
        tok = GPT2Tokenizer(args.tokenizer)
        print(tok.decode(ids))
    else:
        print("token ids:", ids.tolist())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
