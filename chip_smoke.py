"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py [--out results.json]

Phases, each printing one JSON line (any failure raises and the script
exits non-zero without the final line):

  header   the card (nvidia-smi name and power limit), torch and CUDA
           versions, and the time to build the CUDA kernels from
           mila_tpu_torch/csrc (one nvcc per source, all started together);
  kernels  each kernel entry point at the served shapes, kernel against its
           plain PyTorch version on the same inputs on the card: max abs
           error and tolerance, kernel / plain / library ms (CUDA events),
           and the least time the card could take (bound_ms);
  parity   Llama-3.2-1B widths at 2 layers, int8: prefill of 8 prompts and 8
           decode steps through the kernels on the card against the same
           weights through the plain path on the CPU;
  serve    the full 16-layer Llama-3.2-1B int8 (random weights from a seed)
           served by the paged engine: 16 requests, 32 new tokens each,
           max_batch 8, max_len 512, buckets (32, 64, 128), greedy, three
           identical runs (medians reported); every kernel's launch count
           over each run, against the count the path implies; one decode
           step timed eagerly and as a CUDA-graph replay.

Then the kernel summary line ({"kernels": [...]}), the card line, and as
the last line {"ok": true, "device": {...}}. Imports only torch, numpy, the
standard library and mila_tpu_torch.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# Published dense peaks (NVIDIA data sheets): bytes/s of device memory and
# bf16 tensor-core operations/s, by the card's name. A card below its full
# power limit runs slower than these.
PEAKS = (("H200", 4.8e12, 989e12), ("H100 NVL", 3.9e12, 835e12),
         ("H100 PCIe", 2.0e12, 756e12), ("H100", 3.35e12, 989e12))
LAYER_SHAPES = {"wqkv": (2048, 3072), "wo": (2048, 2048), "wgu": (2048, 16384),
                "down": (8192, 2048)}
ERR_TOL = 2e-2  # of the reference's max |value|: one bf16 step is 2^-8 of a value


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def peaks(name: str) -> tuple[float, float, str]:
    for key, bw, ops in PEAKS:
        if key in name:
            return bw, ops, key
    raise RuntimeError(f"no published peaks known for {name!r}")


def bound(bytes_moved: float, ops: float, bw: float, peak_ops: float) -> tuple[float, str]:
    tb, to = bytes_moved / bw * 1e3, ops / peak_ops * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def time_graph(calls, reps: int = 7) -> float:
    """ms per call: capture ``calls`` (closures, each one launch sequence)
    into a CUDA graph, replay it ``reps`` times between CUDA events, take
    the median. The graph removes the host's launch overhead; callers cycle
    through distinct weights so the 50 MB L2 cache does not hold them."""
    for c in calls:
        c()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for c in calls:
            c()
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / len(calls))
    return statistics.median(times)


def time_eager(fn, reps: int = 3) -> float:
    """ms per call of ``fn`` with CUDA events around each call (median)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def max_err(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError("kernel output is not finite")
    return (got - want).abs().max().item(), want.abs().max().item()


def build_params(cfg, seed: int, device):
    from mila_tpu_torch.inference.quantize import quantize_model_params
    from mila_tpu_torch.models.llama import (add_quantized_lm_head, fuse_llama_projections,
                                             init_llama_params)

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = init_llama_params(cfg, gen, device=device)
    params = quantize_model_params(fuse_llama_projections(params), "int8", device=device)
    return add_quantized_lm_head(params, "int8")


def to_cpu(tree):
    from mila_tpu_torch.inference.quantize import QTensor

    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, QTensor):
        return tree.to("cpu")
    return tree.cpu()


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

def phase_kernels(params, cfg, bw, peak_ops, rng):
    from mila_tpu_torch.inference.kv_cache import make_paged_pools
    from mila_tpu_torch.inference.quantize import dequantize
    from mila_tpu_torch.kernels import decode_fused as df
    from mila_tpu_torch.kernels import paged_attention as pa
    from mila_tpu_torch.kernels import quant_matmul as qm

    dev = torch.device("cuda")
    L = cfg.num_layers
    layers = [params[f"h{i}"] for i in range(L)]
    bf16 = torch.bfloat16

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, bf16)

    rows = []

    def copies(nbytes):
        """Distinct weight copies to cycle through so that they exceed L2."""
        return min(L, max(2, int(2e8 // nbytes) + 1))

    def record(entry, shape, got, want, calls, plain, library, nbytes, nops):
        err, ref = max_err(got, want)
        if err > ERR_TOL * ref:
            raise AssertionError(f"{entry}[{shape}]: max abs err {err} > {ERR_TOL} x {ref}")
        b_ms, b_by = bound(nbytes, nops, bw, peak_ops)
        rows.append({"entry": entry, "shape": shape, "max_abs_err": err,
                     "tolerance": ERR_TOL * ref, "ms": time_graph(calls),
                     "plain_ms": time_eager(plain),
                     "library_ms": None if library is None else time_graph(library),
                     "bound_ms": b_ms, "bound_by": b_by})

    # quant_linear at prefill: M = max_batch * largest bucket = 1024 rows.
    M = 8 * 128
    for name in ("wgu", "down"):
        K, N = LAYER_SHAPES[name]
        x = rand(M, K)
        ws = [blk[name]["weight"] for blk in layers]
        w_bf = [dequantize(w, bf16) for w in ws[:copies(K * N * 2)]]
        got = qm.quant_linear(x, ws[0])
        want = qm.quant_linear_plain(x, ws[0])
        record("quant_linear", f"{name} M={M}", got, want,
               [lambda w=w: qm.quant_linear(x, w) for w in ws],
               lambda: qm.quant_linear_plain(x, ws[0]),
               [lambda w=w: torch.matmul(x, w) for w in w_bf],
               M * K * 2 + K * N + N * 4 + M * N * 2, 2 * M * K * N)
        del w_bf

    # decode entry points at M = 8 rows (max_batch decode step).
    M = 8
    gam = [1.0 + 0.1 * rand(LAYER_SHAPES["wqkv"][0]).float() for _ in range(L)]
    head = params["lm_head_q"]
    cases = [
        ("rms_quant_linear", "wqkv", "store"), ("rms_quant_linear", "lm_head", "store"),
        ("quant_linear_residual", "wo", "residual"),
        ("quant_linear_residual", "down", "residual"),
        ("rms_quant_linear_swiglu", "wgu", "swiglu"),
    ]
    for entry, name, mode in cases:
        ws = [head] if name == "lm_head" else [blk[name]["weight"] for blk in layers]
        K, ldq = ws[0].q.shape
        n_out = ldq // 2 if mode == "swiglu" else ldq
        x = rand(M, K)
        res = rand(M, n_out)
        g = gam[0]
        if mode == "store":
            fn, plain = df.rms_quant_linear, df.rms_quant_linear_plain
            calls = [lambda w=w, gi=gi: fn(x, gi, w) for w, gi in zip(ws, gam)]
            args = (x, g, ws[0])
        elif mode == "residual":
            fn, plain = df.quant_linear_residual, df.quant_linear_residual_plain
            calls = [lambda w=w: fn(x, w, res) for w in ws]
            args = (x, ws[0], res)
        else:
            fn, plain = df.rms_quant_linear_swiglu, df.rms_quant_linear_swiglu_plain
            calls = [lambda w=w, gi=gi: fn(x, gi, w) for w, gi in zip(ws, gam)]
            args = (x, g, ws[0])
        w_bf = [dequantize(w, bf16) for w in ws[:copies(K * ldq * 2)]]
        library = [lambda w=w: torch.matmul(x, w) for w in w_bf]
        nbytes = (K * ldq + ws[0].scale.numel() * 4 + M * K * 2 + M * n_out * 2
                  + (K * 4 if mode != "residual" else M * n_out * 2))
        record(entry, f"{name} M={M}", fn(*args), plain(*args), calls,
               lambda: plain(*args), library, nbytes, 2 * M * K * ldq)
        del w_bf

    # paged decode attention: B = 8 rows, ragged lengths up to 384 tokens.
    B, NH, NKV, HD, ps, W = 8, cfg.num_heads, cfg.num_kv_heads, cfg.hd, 128, 4
    P = B * W + 1
    pools = make_paged_pools(L, NKV, HD, P, ps, bf16, dev)
    for t in pools.values():
        t.normal_()
    lens_np = rng.integers(1, 385, B).astype(np.int32)
    lens_np[0] = 384
    table_np = (1 + rng.permutation(P - 1)[: B * W]).reshape(B, W).astype(np.int32)
    lens, table = torch.from_numpy(lens_np).to(dev), torch.from_numpy(table_np).to(dev)
    q = rand(B, 1, NH, HD)
    got = pa.paged_decode_attention(q, pools["k"][0], pools["v"][0], table, lens)
    want = pa.paged_decode_attention_plain(q, pools["k"][0], pools["v"][0], table, lens)
    # Library yardstick: SDPA over the same K/V gathered into contiguous
    # [B, NKV, T, HD] beforehand (the gather is not timed).
    T = W * ps

    def gathered(pool):
        return pool[table.long()].permute(0, 2, 1, 4, 3).reshape(B, NKV, T, HD).contiguous()

    kv = [(gathered(pools["k"][i]), gathered(pools["v"][i])) for i in range(L)]
    mask = (torch.arange(T, device=dev)[None, :] < lens[:, None])[:, None, None, :]
    qs = q.transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    live = int(lens_np.sum())
    record("paged_decode_attention", f"B={B} lens<=384", got, want,
           [lambda i=i: pa.paged_decode_attention(q, pools["k"][i], pools["v"][i], table, lens)
            for i in range(L)],
           lambda: pa.paged_decode_attention_plain(q, pools["k"][0], pools["v"][0], table,
                                                   lens),
           [lambda k=k, v=v: sdpa(qs, k, v, attn_mask=mask, enable_gqa=True) for k, v in kv],
           live * NKV * HD * 2 * 2 + 2 * B * NH * HD * 2 + B * W * 4 + B * 4,
           4 * live * NH * HD)
    del pools, kv
    torch.cuda.synchronize()
    return rows


# ---------------------------------------------------------------------------
# parity
# ---------------------------------------------------------------------------

def phase_parity(rng):
    from mila_tpu_torch.models.llama import Llama, LlamaConfig

    cfg = LlamaConfig.llama32_1b().replace(num_layers=2, max_seq_len=512)
    params = build_params(cfg, seed=1, device="cuda")
    cpu_params = to_cpu(params)
    gpu, cpu = Llama(cfg), Llama(cfg, device="cpu")
    B, bucket, ps = 8, 128, 128
    lens = rng.integers(8, 101, B).astype(np.int32)
    tokens = np.zeros((B, bucket), np.int32)
    for i, n in enumerate(lens):
        tokens[i, :n] = rng.integers(0, cfg.vocab_size, n)
    table = (1 + np.arange(B * 4)).reshape(B, 4).astype(np.int32)
    gpools = gpu.init_paged_cache(B * 4 + 1, ps, torch.bfloat16)
    cpools = cpu.init_paged_cache(B * 4 + 1, ps, torch.bfloat16)
    gt, ct = torch.from_numpy(table).cuda(), torch.from_numpy(table)
    glog, gpools = gpu.forward_paged_prefill(params, torch.from_numpy(tokens).cuda(), gpools,
                                             gt, torch.from_numpy(lens).cuda())
    clog, cpools = cpu.forward_paged_prefill(cpu_params, torch.from_numpy(tokens), cpools, ct,
                                             torch.from_numpy(lens))
    steps = []

    def compare(what, g, c):
        g, c = g.float().cpu().reshape(B, -1), c.float().reshape(B, -1)
        if not torch.isfinite(g).all():
            raise AssertionError(f"parity {what}: non-finite logits on the card")
        err, ref = (g - c).abs().max().item(), c.abs().max().item()
        cos = torch.nn.functional.cosine_similarity(g, c, dim=-1).min().item()
        agree = float((g.argmax(-1) == c.argmax(-1)).float().mean())
        steps.append({"what": what, "max_abs_err": err, "max_abs_logit": ref,
                      "min_cosine": cos, "greedy_agree": agree})
        if err > ERR_TOL * ref and cos < 0.999:
            raise AssertionError(f"parity {what}: max |d| {err} > {ERR_TOL} x {ref} and "
                                 f"cosine {cos} < 0.999")
        return g.argmax(-1).to(torch.int32)

    nxt = compare("prefill", glog, clog)
    pos = lens.copy()
    for step in range(8):
        tok = nxt[:, None]
        glog, gpools = gpu.forward_paged_ragged(params, tok.cuda(), gpools, gt,
                                                torch.from_numpy(pos).cuda())
        clog, cpools = cpu.forward_paged_ragged(cpu_params, tok, cpools, ct,
                                                torch.from_numpy(pos))
        nxt = compare(f"decode {step}", glog, clog)
        pos = pos + 1
    del params, cpu_params, gpools, cpools
    return {"layers": cfg.num_layers, "tolerance": f"max|d| <= {ERR_TOL} x max|logit| "
            "or min cosine >= 0.999", "steps": steps,
            "greedy_agree_mean": float(np.mean([s["greedy_agree"] for s in steps]))}


# ---------------------------------------------------------------------------
# serve
# ---------------------------------------------------------------------------

def serve_once(model, params, cfg, prompts, plains):
    """One serving run on a fresh engine; checks outputs and launch counts."""
    from mila_tpu_torch import kernels
    from mila_tpu_torch.inference.engine import EngineConfig, InferenceEngine

    engine = InferenceEngine(model, params, EngineConfig(
        max_batch=8, max_len=512, prefill_buckets=(32, 64, 128), cache_dtype="bfloat16",
        page_size=128))
    plain_before = [f.calls for f in plains]
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.monotonic()
    reqs = [engine.submit(p, max_new_tokens=32) for p in prompts]
    engine.run()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = kernels.launch_counts()
    if [f.calls for f in plains] != plain_before:
        raise AssertionError("a plain version ran during the serve phase")
    for r in reqs:
        if not (r.done and len(r.output) == 32 and all(0 <= t < cfg.vocab_size
                                                       for t in r.output)):
            raise AssertionError(f"request {r.id} did not finish with 32 valid tokens")
    st = engine.stats
    L, it, groups = cfg.num_layers, st["decode_iters"], st["prefill_groups"]
    expected = {"quant_linear": 4 * L * groups, "rms_quant_linear": (L + 1) * it + groups,
                "quant_linear_residual": 2 * L * it, "rms_quant_linear_swiglu": L * it,
                "paged_decode_attention": L * it}
    if counts != expected or min(counts.values()) <= 0:
        raise AssertionError(f"launch counts {counts} != expected {expected}")
    ttft = sorted(r.ttft_s for r in reqs)
    tokens = sum(len(r.output) for r in reqs)
    return counts, {
        "new_tokens": tokens, "wall_s": wall, "tok_s": tokens / wall,
        "ttft_p50_ms": 1e3 * float(np.percentile(ttft, 50)),
        "ttft_p95_ms": 1e3 * float(np.percentile(ttft, 95)),
        "decode_ms_per_step": 1e3 * st["t_decode_s"] / it, "decode_steps": it,
        "prefill_groups": groups, "prefill_s": st["t_prefill_s"],
        "launches_per_decode_step": {k: v / it for k, v in counts.items()
                                     if k != "quant_linear"},
    }


def decode_step_times(model, params, cfg, rng):
    """One 8-row decode step (forward_paged_ragged + argmax) timed eagerly
    and as a CUDA-graph replay: the difference is what the host adds."""
    B, ps, W = 8, 128, 4
    pools = model.init_paged_cache(B * W + 1, ps, torch.bfloat16)
    table = torch.from_numpy((1 + np.arange(B * W)).reshape(B, W).astype(np.int32)).cuda()
    pos = torch.from_numpy(rng.integers(40, 130, B).astype(np.int32)).cuda()
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)).cuda()

    def step():
        logits, _ = model.forward_paged_ragged(params, tok, pools, table, pos)
        return torch.argmax(logits[:, -1], dim=-1)

    eager = time_eager(step, reps=5)
    return {"decode_step_eager_ms": eager, "decode_step_graph_ms": time_graph([step])}


def phase_serve(model, params, cfg, rng, repeats: int = 3):
    """``repeats`` identical serving runs (the host clock varies between
    runs more than the device does); medians plus every run."""
    from mila_tpu_torch.kernels import decode_fused as df
    from mila_tpu_torch.kernels import paged_attention as pa
    from mila_tpu_torch.kernels import quant_matmul as qm

    plains = (qm.quant_linear_plain, df.rms_quant_linear_plain,
              df.quant_linear_residual_plain, df.rms_quant_linear_swiglu_plain,
              pa.paged_decode_attention_plain)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(8, 101, 16)]
    runs = []
    for _ in range(repeats):
        counts, run = serve_once(model, params, cfg, prompts, plains)
        runs.append(run)
    med = {k: float(np.median([r[k] for r in runs]))
           for k in ("tok_s", "ttft_p50_ms", "ttft_p95_ms", "decode_ms_per_step", "wall_s")}
    return counts, {"requests": len(prompts), **med, "launches": counts,
                    "launches_per_decode_step": runs[-1]["launches_per_decode_step"],
                    **decode_step_times(model, params, cfg, rng),
                    "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "runs": runs}


SOURCES = {
    "quant_linear": ("mila_tpu_torch/csrc/qmm_int8.cu",
                     "mila_tpu/kernels/quant_matmul.py:74 (_qmm_kernel)"),
    "rms_quant_linear": ("mila_tpu_torch/csrc/qgemv_int8.cu",
                         "mila_tpu/kernels/decode_fused.py:63 (_rms_qmm_kernel)"),
    "quant_linear_residual": ("mila_tpu_torch/csrc/qgemv_int8.cu",
                              "mila_tpu/kernels/decode_fused.py:320 (_qmm_res_kernel)"),
    "rms_quant_linear_swiglu": ("mila_tpu_torch/csrc/qgemv_int8.cu",
                                "mila_tpu/kernels/decode_fused.py:423 (_rms_qmm_swiglu_kernel)"),
    "paged_decode_attention": ("mila_tpu_torch/csrc/paged_decode_attn.cu",
                               "mila_tpu/kernels/paged_attention.py:45 (_paged_kernel)"),
}
# The shape whose numbers head each entry of the summary line.
PRIMARY = {"quant_linear": "wgu", "rms_quant_linear": "lm_head",
           "quant_linear_residual": "down", "rms_quant_linear_swiglu": "wgu",
           "paged_decode_attention": "B=8"}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every phase's results to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    from mila_tpu_torch.kernels import _build
    from mila_tpu_torch.models.llama import Llama, LlamaConfig

    t_start = time.monotonic()
    card = card_line()
    name = torch.cuda.get_device_name(0)
    bw, peak_ops, peak_key = peaks(name)
    t0 = time.monotonic()
    _build.build_all()
    header = {"phase": "header", "card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda, "build_s": time.monotonic() - t0,
              "peaks": {"bytes_per_s": bw, "bf16_ops_per_s": peak_ops, "part": peak_key}}
    emit(header)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    rng = np.random.default_rng(0)
    cfg = LlamaConfig.llama32_1b().replace(max_seq_len=512)
    t0 = time.monotonic()
    params = build_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    setup_s = time.monotonic() - t0

    rows = phase_kernels(params, cfg, bw, peak_ops, rng)
    emit({"phase": "kernels", "card": card, "rows": rows})
    parity = phase_parity(rng)
    emit({"phase": "parity", "card": card, **parity})
    torch.cuda.reset_peak_memory_stats()
    counts, serve = phase_serve(Llama(cfg), params, cfg, rng)
    emit({"phase": "serve", "card": card, "model": "llama-3.2-1b int8, random weights",
          "setup_s": setup_s, **serve})

    summary = []
    for entry, (source, replaces) in SOURCES.items():
        mine = [r for r in rows if r["entry"] == entry]
        top = next(r for r in mine if r["shape"].startswith(PRIMARY[entry]))
        summary.append({
            "name": entry, "route": "cuda", "source": source, "replaces": replaces,
            "launches": counts[entry], "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": top["ms"], "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"], "library_ms": top["library_ms"],
            "shape": top["shape"], "shapes": mine})
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"header": header, "kernels": rows, "parity": parity, "serve": serve,
                       "summary": summary, "total_s": time.monotonic() - t_start}, f, indent=1)
    emit({"kernels": summary})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
