"""Loop the three int8 decode GEMV calls of the card test
``test_qgemv_int8_one_launch_a_call`` (``quant_linear_residual`` at K 8192, N
2048; ``rms_quant_linear_swiglu`` and ``rms_quant_linear_argmax`` at K
2048, N 4096; M 8, bf16) for many rounds on the GPU, each round under its own
``torch.profiler`` window as the test takes it.

    python -m mila_tpu_torch.tools.qgemv_launch_loop [--rounds 300]

Per round it counts what the profiler recorded (``qgemv8_kernel`` records,
the argmax index pass, anything else) and the wrappers' launch counters, and
holds every output against the plain version (each within 2e-2 of the
largest reference value; the argmax token's logit within 1e-3 of the row's
max). A round whose profiler saw fewer than three ``qgemv8_kernel`` records
while the counters and outputs are right is a record the profiler dropped,
not a missing launch. Prints one JSON line: the counts of each kind of
round and the first few faulty rounds in full.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from mila_tpu_torch.inference.quantize import quantize
from mila_tpu_torch.kernels import decode_fused as df
from mila_tpu_torch.kernels import quant_matmul as qm


def _rand(shape, seed, scale=1.0, dtype=torch.bfloat16):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * scale).to(
        device="cuda", dtype=dtype)


def _case(M, K, N, seed):
    """The card test's ``_decode_case`` (per-channel int8 scales, bf16)."""
    x = _rand((M, K), seed)
    gamma = 1.0 + _rand((K,), seed + 1, 0.1, torch.float32)
    qt = quantize(_rand((K, N), seed + 2, 0.05, torch.float32), "int8", 0)
    res = _rand((M, N), seed + 3)
    return x, gamma, qt, res


def _rel_err(got, want) -> float:
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        return float("inf")
    return (got - want).abs().max().item() / (want.abs().max().item() + 1e-6)


def _argmax_gap(tok, x, gamma, qt, vocab) -> float:
    """|max logit - the token's logit| over the row's largest |logit|."""
    logits = qm.scaled_partials(df._rms_scaled(x, gamma, 1e-5), qt)[:, :vocab]
    t = tok[:, 0].long()
    if int(t.max()) >= vocab or int(t.min()) < 0:
        return float("inf")
    gap = (logits.max(dim=-1).values - logits.gather(1, t[:, None])[:, 0]).abs().max().item()
    return gap / logits.abs().max().item()


def main() -> None:
    from torch.profiler import ProfilerActivity, profile

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=300)
    args = ap.parse_args()
    x, gamma, qt, res = _case(8, 8192, 2048, 130)
    xh, gh, qh, _ = _case(8, 2048, 4096, 131)
    vocab = 4000
    entries = (df.quant_linear_residual, df.rms_quant_linear_swiglu, df.rms_quant_linear_argmax)
    calls = (lambda: df.quant_linear_residual(x, qt, res),
             lambda: df.rms_quant_linear_swiglu(xh, gh, qh),
             lambda: df.rms_quant_linear_argmax(xh, gh, qh, vocab_size=vocab))
    want = (df.quant_linear_residual_plain(x, qt, res),
            df.rms_quant_linear_swiglu_plain(xh, gh, qh))
    for call in calls:
        call()
    torch.cuda.synchronize()
    tally = {"rounds": args.rounds, "ok": 0, "profiler_short": 0, "profiler_other": 0,
             "counter_short": 0, "wrong_output": 0}
    faults = []
    for r in range(args.rounds):
        before = [f.launches for f in entries]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            outs = [call() for call in calls]
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        n_gemv = sum("qgemv8_kernel" in n for n in names)
        others = [n for n in names if "qgemv8_kernel" not in n]
        counted = [f.launches - b for f, b in zip(entries, before)]
        errs = [_rel_err(outs[0], want[0]), _rel_err(outs[1], want[1]),
                _argmax_gap(outs[2], xh, gh, qh, vocab)]
        wrong = errs[0] > 2e-2 or errs[1] > 2e-2 or errs[2] > 1e-3
        short_counter = counted != [1, 1, 1]
        odd_others = (sum("argmax_index" in n for n in others) != 1
                      or not all("argmax_index" in n or "emset" in n for n in others))
        tally["wrong_output"] += wrong
        tally["counter_short"] += short_counter
        tally["profiler_short"] += n_gemv != 3
        tally["profiler_other"] += odd_others
        if wrong or short_counter or n_gemv != 3 or odd_others:
            if len(faults) < 10:
                faults.append({"round": r, "qgemv8_records": n_gemv, "others": others,
                               "counters": counted, "errs": errs})
        else:
            tally["ok"] += 1
    print(json.dumps({**tally, "faults": faults, "card": torch.cuda.get_device_name(0)}),
          flush=True)


if __name__ == "__main__":
    main()
