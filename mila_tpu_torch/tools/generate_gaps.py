"""GPT-2 124M greedy streams of the port's ``gpt2_generate`` example on the
GPU, every token held to f32 logits, for several draws of the weights.

    python -m mila_tpu_torch.tools.generate_gaps [--draws 1,1 4,1 1,2] [--cpu-tokens 64]

Run it from the repository's root: it calls ``chip_smoke.py``'s
``example_gpt2_generate`` with its gates off. For each draw ``W,B``
(GPT2.init's, with the token embedding, which is also the tied head, times
W and every block's projection weights times B) it
writes the llm.c checkpoint, runs the example in bf16, int8, fp8 e4m3 and
speculative k 4 on the card for 64 tokens and on the CPU for
``--cpu-tokens``, and prints one JSON line a run: the stream's distinct
tokens, the largest logit, and each stream's largest gap below the f32
oracle's top logit over the near-tie bound (``ERR_TOL`` x max |logit|),
card and CPU. The CPU run goes through every kernel's plain version in
bf16, so it is the witness of what bf16 arithmetic does apart from the
card's kernels.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path.cwd()))
import chip_smoke  # noqa: E402 (the repository root's script)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--draws", nargs="+", default=["1,1", "4,1", "1,2"])
    ap.add_argument("--cpu-tokens", type=int, default=chip_smoke.GENERATE_NEW)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("generate_gaps: no CUDA device", file=sys.stderr)
        return 2
    from mila_tpu_torch.kernels import _build

    _build.build_all(["qmm_int8"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = chip_smoke.card_line()
    for draw in args.draws:
        wte_scale, block_scale = (float(v) for v in draw.split(","))
        with tempfile.TemporaryDirectory() as tmp:
            path = chip_smoke.write_gpt2_124m(tmp, wte_scale, block_scale)
            _, lines = chip_smoke.example_gpt2_generate(path, card, args.cpu_tokens,
                                                        gate=False)
        for tag, line in lines.items():
            print(json.dumps({"tool": "generate_gaps", "wte_scale": wte_scale,
                              "block_scale": block_scale, "run": tag,
                              "distinct_tokens": line["distinct_tokens"],
                              "card": line["teacher_forced"], "cpu": line["cpu"],
                              "near_ties": line["near_ties"],
                              "streams_equal": line["streams_equal"]}), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
