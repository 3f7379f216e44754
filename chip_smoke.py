"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py [--out results.json]
    python3 chip_smoke.py --only flash_rows   # the off-path flash rows alone

Phases, each printing one JSON line (any failure raises and the script
exits non-zero without the final line):

  header   the card (nvidia-smi name and power limit), torch and CUDA
           versions, and the time to build the CUDA kernels from
           mila_tpu_torch/csrc (one nvcc per source, all started together);
  kernels  each kernel entry point at the served shapes, kernel against its
           plain PyTorch version on the same inputs on the card: max abs
           error and tolerance, kernel / plain / library ms (CUDA events),
           and the least time the card could take (bound_ms); the int4
           weight stream, flash attention and int8 pages included; the
           prefill GEMM at every projection for 1024 rows and wgu for 4096
           (with its host us per call), the paged attention over int8 pages
           at B 8 and B 1 and over bf16 pages at B 8, up to 4096 tokens;
           every row carries its weight format (wdtype);
  kernels fp8  the fp8 branches of the one-byte kernels (Llama-3.2-1B
           FP8-E4M3, the prefill GEMM also on e5m2 weights): K1 wgu and
           wqkv at M 1024, K2 wqkv, wo, down, wgu and the head at M 8, K4,
           K7 at a middle and the last layer, the MLP block at layer 0, K8's
           one-layer launch (layer_megakernel) on e4m3 and e5m2 tile
           streams, each beside its plain version, bound and library call;
  kernels pairs  K3 and K5 at the mixed (q, cache) dtype pairs of the GPT-2
           and speculative serving paths:
           an f32 q over bf16 pages at GPT-2 124M's decode, a bf16 q over f32
           pages, the dense entry in both mixed pairs at Llama-3.2-1B's decode
           shape and in bf16 at the speculative tiny draft's heads (HD 32, G
           2), the fused entry with an f32 qkv over bf16 caches; each row
           beside its plain version, bound and SDPA (K/V cast to q's dtype
           beforehand), with its dtype pair;
  crossover one layer's prefill attention at T 512-4096: the flash kernel
           against the plain product (FLASH_MIN_SEQ stays 2048); K13's two
           forwards across V against F.cross_entropy (CE_SHORT_MAX_V);
  parity   Llama-3.2-1B widths at 2 layers (G = 4: the slot head order is
           exercised), int8, kernels on the card against the same weights
           through the plain path on the CPU: the paged prefill of 8 prompts
           and 8 decode steps; the contiguous prefill (forward_with_cache) and
           8 greedy_step_with_cache steps with pack_decode_layers params,
           pack_decode_megalayers params and neither; 8 giga_step steps on
           pack_decode_giga params; 4 forward_with_cache_ragged steps on
           pack_decode_mlp params;
  parity fp8  the same at 2 layers in fp8 e4m3 with an fp8 head: the
           paged protocol and the contiguous steps on pack_decode_layers and
           pack_decode_megalayers params;
  parity long  the same widths at 1 layer with int4 weights and int8
           pages: a paged prefill in a 2048-token bucket (flash on the card,
           the plain product on the CPU) and 8 decode steps;
  decode   the full 16-layer Llama-3.2-1B int8 with pack_decode_layers at the
           JAX bench's decode shape (B 8, prompt 128, cache 512): prefill, 64
           greedy_step_with_cache steps (ms/step eager and as a CUDA-graph
           replay of one step, tok/s, the step's byte bound);
  decode fp8  the same on the 16-layer model in fp8 e4m3 (fp8 head),
           pack_decode_layers over its fp8 params;
  giga     the same shape on pack_decode_giga params: prefill, stack_kv_cache,
           64 giga_step steps (one kernel per step), the same numbers;
  giga bf16  Llama-3.2-1B unquantized (bf16) through
           pack_decode_giga(bf16_stream=True): the whole-step kernel on the
           bf16 stream against its plain version with the giga gate, then
           the giga phase's decode on it;
  mega     the same shape on pack_decode_megalayers params: prefill and 16
           greedy_step_with_cache steps (one kernel per layer), the graph
           step beside its byte bound;
  mega fp8  the same on Llama-3.2-1B FP8-E4M3 (fp8 tile streams);
  generate Generator.generate on the unpacked int8 params and on
           pack_decode_mlp params (B 8, 64-token prompts, 16 new tokens);
  serve    the full 16-layer Llama-3.2-1B int8 (random weights from a seed)
           served by the engine: 16 requests, 32 new tokens each, max_batch
           8, max_len 512, buckets (32, 64, 128), greedy; three identical
           paged runs (medians reported), one contiguous-layout run on the
           packed params and one on the giga params; one paged decode step
           timed eagerly and as a CUDA-graph replay;
  serve fp8  the same 16 requests once on the paged engine over the
           16-layer Llama-3.2-1B FP8-E4M3 with an fp8 head: tok/s, TTFT, one
           decode step eager and as a graph; its launch counts must equal the
           int8 paged run's;
  serve spec  the same model on the paged engine with speculative_k 4 and a
           random bf16 tiny draft (the JAX bench's): 12 of serve's requests,
           64 new tokens; tok/s, acceptance, rounds, t_decode_s; its greedy
           streams against a plain paged run's (equal but for near-ties,
           each printed, and past a split every token a near-tie of the f32
           oracle's argmax on the stream's own prefix);
  parity spec  2 layers at Llama-3.2-1B's widths, INT8, draft == target:
           over f32 activations k 3 (a 32-row verify on K2's fused entries)
           and k 4 (40 rows, K1): acceptance >= 0.9, streams equal to the
           CPU port's but for near-ties; over bf16 activations k 4 against
           the card's plain paged engine, every rejected draft a near-tie
           of the f32 oracle;
  serve long  the 16-layer Llama-3.2-1B with int4 weights served over int8
           KV pages: 8 requests (4 prompts of 2048-4000 tokens, 4 of
           64-1000), 32 new tokens each, max_batch 8, max_len 4224, buckets
           64-4096; tok/s, TTFT of long and short prompts, decode ms/step,
           prefill seconds per bucket, peak memory; one int4 paged decode
           step timed eagerly and as a CUDA-graph replay at short context,
           and one at the run's own lengths split on CUDA events into the
           16 paged attention calls and the rest;
  serve gpt2  GPT-2 124M (f32 params, bf16 pages, random weights) written as
           an llm.c checkpoint and read back equal, then serve's 16 requests
           (32 new tokens): tok/s, TTFT p50/p95, decode ms/step, 12
           paged_decode_attention calls a decode iteration;
  parity gpt2  the same engine at 2 layers, card against the CPU port: the
           first logits within 2e-2 x max |ref|, greedy streams equal but
           for near-ties (checked as serve spec's are);
  generate gpt2  Generator on GPT-2 124M in bf16 at the JAX bench's gpt2
           row (B 8, prompt 128): decode tok/s; no kernel runs there;
  kernels train  the training kernels against their plain versions at the
           training path's shapes: flash forward with statistics and flash
           backward (GPT-2 B 8 T 1024, Llama-3.2-1B's GQA heads at T 2048, D
           128; GPT-2's shape in f32 (the tf32 family) and fp16
           (wgmma), where f32 and fp16 also hold the forward without
           statistics, evaluate's; T 2048, NH 16/8 at D 192 and 256 in bf16
           (wgmma both ways), at D 128, 192 and 256 in f32 (the tf32
           forward; the tf32 backward at D 128, the split kernels at 192
           and 256), at D 320 and 512 in bf16, fp16 and f32 (the forward
           on the column-part kernels of wgmma and tf32 wgmma, the 16-bit
           backward on flash_bwd.cu's wgmma part kernels, f32's on the
           split kernels), these off the model paths timed on the device
           alone;
           every row names its family and the CUDA kernels behind one
           counted call, read from a captured graph (cuda_launches;
           graph_launches); row errors within 5e-3 of the row's max in f32,
           2e-2 otherwise;
           beside SDPA's forward, its
           forward + backward and its backward alone), fused AdamW's
           per-leaf entry on wte with and without stochastic rounding and
           in fp16 (bit-equal), softmax-CE forward and backward at [8192,
           50304] in bf16 and fp16; every row carries its dtype;
  parity train  a 1-layer GPT-2 at full width (B 2, T 1024, bf16 + SR
           masters, flash): loss, every gradient leaf and one Model train
           step's m, v and masters, on the card against the CPU path from the
           same params, batch and noise;
  train    GPT-2 124M (bf16 params, f32 SR masters, grad clip 1.0, flash),
           B 8, T 1024: Model.train over 12 batches of synthetic windows
           (4 fixed sequences, so the loss must fall), then Model.evaluate:
           ms/step, tokens/s, model TFLOP/step and its share of the bf16
           peak (MFU), first and last loss, peak memory, one step split into
           forward, backward and AdamW; AdamW's step as a graph replay
           (adamw_graph_ms; with the noise passed in, adamw_graph_noise_arg_ms)
           and its kernel rows at the model's own leaves: fused_adamw_step
           (one launch per dtype group, JAX's Threefry bits drawn inside)
           bit-equal to its plain twin, grad_clip_scale (the clip's norm, one
           launch) within 1e-6 of its plain one, beside
           torch.optim.AdamW(fused=True) over the same leaves (not the same
           function: no master, no SR) and torch.nn.utils.get_total_norm;
  parity train fp16, train fp16  the same in fp16 (SR masters): 1 layer
           card against CPU at T 512, then 124M over 2 warm-up and 4 timed
           steps (the launch counts of train, the loss falling by 1 nat);
  parity train f32, train f32  the same for GPT-2 as shipped (f32 params,
           flash on tf32 products). Every train phase feeds Model through
           the batch prefetcher at its default depth 2;
  kernels train llama  rows 15-18 at Llama-3.2-1B's training shapes: the
           flash statistics launch and backward at B 2, T 2048, NH 32 / NKV
           8, D 64; AdamW on the tied wte (262.7M elements, SR); the CE at
           [4096, 128256] bf16 (the streamed backward); each beside its
           plain version, bound and library call;
  parity train llama  one layer at Llama-3.2-1B's widths (vocab 128256),
           bf16 + SR masters, flash forced, B 1, T 512, card against CPU
           with parity train's gates;
  train llama  Llama-3.2-1B at full width and depth through Model (bf16
           params, f32 SR masters, clip 1.0, flash), B 2, T 2048, 12 steps
           over 4 fixed sequences, then evaluate: the loss falls by 1 nat;
           ms/step, tokens/s, MFU, peak memory, three steps split as
           train's, and AdamW's graph and kernel rows as train's (146
           leaves);
  train mnist  the reference's MNIST classifier (784-128-64-10 GELU, f32,
           AdamW lr 1e-3) through Model, prefetch depth 2, on the synthetic
           surrogate: K13 (V 10: the short-row forward, the backward's
           scalar branch) and K12's step (the MLP's six f32 leaves, no
           masters, one launch) at the step's shapes against their plain
           versions, beside F.cross_entropy and torch.optim.AdamW(fused=True);
           the JAX e2e test's run (B 128, 4096 samples, 4 epochs: the loss
           halves, >= 0.975 on the 204-sample test split) and bench.py's
           shape (B 2048, 65536 samples, 4 epochs: samples/s, ms/step);
  train cnn  the CNN classifier (conv 32, 64, hidden 128, f32) through
           Model on the surrogate: K12's step over its eight leaves against
           its plain version; train mnist's gate run (the loss halves; test accuracy
           printed) and rate run (samples/s, ms/step);
  resume mnist  2 epochs, a checkpoint, a fresh Model and resume_training for
           2 more, bit-equal to 4 straight (params, moments, predictions);
           prefetch depth 0 against 2 (losses bit-equal); Model.export, and
           export_model + Predictor.from_archive predicting the model's bits;
  resume gpt2  GPT-2 at 2 layers (bf16 + f32 SR masters), B 8, T 1024: 4
           steps straight against 2, save_checkpoint, a fresh Model,
           load_checkpoint and 2 more (params, masters, moments
           bit-equal); the archive's bytes, save and load seconds;
  data     host work: the native IO library loaded (built with g++ beside
           the kernels), native BPE == Python BPE, TokenReader over an
           llm.c shard == numpy windows, an IDX round trip, CharReader;
  runtime  runtime/ and utils/profiling: get_device("auto") is cuda:0,
           DeviceProps.query against torch.cuda.get_device_properties,
           device_memory_stats after a GPT-2 124M Model build, a
           profiling.trace of two of its train steps naming K12's and K13's
           CUDA kernels, Timer.scope(sync=) within 10 % of CUDA events
           (runtime_s);
  examples the five programs of mila_tpu_torch/examples in-process
           (runpy), one line each (gpt2_generate one a run) with its exit
           code, seconds, printed markers, launch counts and rate:
           gpt2_train at GPT-2 124M's widths (L 12, C 768, B 8, T 1024, 20
           steps over llm.c shards of V 50257, validation, --quant-eval:
           the loss falls by 1 nat), gpt2_generate on a GPT-2 124M llm.c
           checkpoint (blocks x 3; 64 greedy tokens in bf16, int8, fp8 e4m3 and
           speculatively with k 4; every token within the near-tie bound of
           f32 logits on dequantized weights, teacher-forced; the first 16
           ids equal those of the same run on the CPU but for near-ties),
           mnist_train with its defaults (its 97.5 % gate), charlm_train on
           the char_lm preset for 200 steps (perplexity and sample lines),
           viz_demo --ppm-out (the file); then examples_s;
  kernels examples  K1 at the shapes the examples give it: GPT-2 124M's
           four projections at M 1 (bf16; int8, fp8 e4m3) and M 8192 (f32;
           int8, fp8 e4m3, int4), each held to quant_linear_plain.
Every phase's line carries at_s, the script's seconds so far (every
kernel row too); kernels pairs, the GPT-2, speculative, MNIST, Llama
training, CNN, resume, data and kernels examples phases also their own
seconds (phase_s), runtime and examples theirs as runtime_s and examples_s.

On every path (decode prefill, decode, decode fp8 prefill, decode fp8,
giga prefill, giga, giga bf16 prefill, giga bf16, mega prefill, mega, mega
fp8 prefill, mega fp8, generate, generate mlp, each serve run, serve fp8,
serve spec and its plain run, parity spec at k 3 and 4 and its bf16 k 4
and plain runs, serve long, serve
gpt2, parity gpt2, generate gpt2, train, evaluate, train and evaluate
in fp16 and f32, train and evaluate llama, train mnist, train mnist rate,
train cnn, train cnn rate, resume mnist, resume gpt2, and each example:
example gpt2_train, example gpt2_generate bf16 / int8 / fp8_e4m3 /
speculative, example mnist_train, example charlm_train, example viz_demo)
the launch counts are set to 0 just before it and must equal, just after
it, the counts the path implies for all twenty entry points (0 for those
it does not reach), and no plain version may run. Then the kernel summary line
({"kernels": [...]}), the card line, and as the last line
{"ok": true, "device": {...}}. Imports only torch, numpy, the standard
library and mila_tpu_torch.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

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
# The flash gate on f32 inputs: tf32 products (a 2^-11 step) stay under it,
# bf16 operands (2^-8) do not.
ERR_TOL_F32 = 5e-3
T_START = time.monotonic()


def emit(obj) -> None:
    """One JSON line; a phase's line carries at_s, the script's seconds so far."""
    if "phase" in obj:
        obj = {**obj, "at_s": time.monotonic() - T_START}
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


def time_back_to_back(fn, calls: int = 20, reps: int = 5) -> float:
    """ms per call of ``fn``: CUDA events around ``calls`` back-to-back
    calls, the median of ``reps`` repeats. For closures a graph cannot hold
    (autograd), and for a kernel timed the same way beside them."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def device_ms(fn, calls: int = 20) -> float:
    """ms of device work per call of ``fn``: the kernels' own times summed
    by the profiler over ``calls`` calls, so a closure whose host work
    cannot keep ahead of the card (autograd) is timed by the card alone.
    The profiler now and then drops a window's records (a row has read
    0.0): such a window is profiled again, three times at most, and the run
    fails if none records device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages())
        if total > 0:
            return total / 1e3 / calls
    raise AssertionError("the profiler recorded no device time in three windows")


def graph_launches(fn, entry) -> int:
    """The CUDA kernels one call of ``fn`` launches: the kernel nodes of a
    CUDA graph that captured the call, read through the driver
    (cuGraphGetNodes, cuGraphNodeGetType). Fails unless ``entry``, the
    wrapper whose count fn adds to, counted one launch in the capture."""
    import ctypes

    cu = ctypes.CDLL("libcuda.so.1")
    cu.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_size_t)]
    cu.cuGraphNodeGetType.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]

    def ok(rc):
        if rc != 0:
            raise RuntimeError(f"CUDA driver error {rc} reading a captured graph")

    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    before = entry.launches
    with torch.cuda.graph(g):
        fn()
    if entry.launches - before != 1:
        raise AssertionError(f"{entry.__name__}: counted {entry.launches - before} launches "
                             "in one captured call")
    n = ctypes.c_size_t(0)
    ok(cu.cuGraphGetNodes(g.raw_cuda_graph(), None, ctypes.byref(n)))
    nodes = (ctypes.c_void_p * n.value)()
    ok(cu.cuGraphGetNodes(g.raw_cuda_graph(), nodes, ctypes.byref(n)))
    kind, kernels = ctypes.c_int(), 0
    for node in nodes:
        ok(cu.cuGraphNodeGetType(node, ctypes.byref(kind)))
        kernels += kind.value == 0  # CU_GRAPH_NODE_TYPE_KERNEL
    del g
    return kernels


def max_err(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max |got - want|, max |want|)."""
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError("kernel output is not finite")
    return (got - want).abs().max().item(), want.abs().max().item()


def max_row_err(got: torch.Tensor, want: torch.Tensor, floor: float = 0.0) -> float:
    """max over rows (the last axis) of |got - want| / max |want row|. The
    flash gate: a query row that attends to n keys holds values of about
    sqrt(e / n), far under the first rows' |v|, so each row is held to its
    own size. ``floor``: each row's scale is at least that fraction of the
    tensor's max |want| (a gradient row whose exact value is 0, dq of query
    0 under the causal mask, holds rounding noise on both sides)."""
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError("kernel output is not finite")
    d = (got - want).abs().amax(dim=-1)
    scale = want.abs().amax(dim=-1).clamp_min(floor * want.abs().max().item() + 1e-30)
    return (d / scale).max().item()


def max_elem_rel_err(got: torch.Tensor, want: torch.Tensor, floor: float,
                     extra: float = 0.0) -> float:
    """max over elements of |got - want| / (|want| + floor x max |want| +
    extra): each element held to its own size, so a small wrong value fails
    too."""
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError("kernel output is not finite")
    scale = want.abs() + (floor * want.abs().max().item() + extra + 1e-30)
    return ((got - want).abs() / scale).max().item()


def run_counted(path: str, fn, expected):
    """Run ``fn`` with every launch count set to 0 just before it; fail
    unless the counts just after equal ``expected`` (a dict, or a function
    of fn's result giving one; entry points it leaves out: 0) and no plain
    version ran. Returns (fn's result, counts)."""
    from mila_tpu_torch import kernels

    torch.cuda.synchronize()
    plain_before = kernels.plain_calls()
    kernels.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    if kernels.plain_calls() != plain_before:
        raise AssertionError(f"{path}: a plain version ran on this path")
    if callable(expected):
        expected = expected(out)
    want = {name: expected.get(name, 0) for name in counts}
    if counts != want:
        raise AssertionError(f"{path}: launch counts {counts} != expected {want}")
    return out, counts


def recorder(rows: list, bw: float, peak_ops: float):
    """record(entry, shape, err, ref, calls, plain, library, nbytes, nops,
    gate=None, **extra) appends one kernel row to ``rows``: ``calls`` and
    ``library`` (lists of closures, or None) are timed as CUDA-graph
    replays, ``plain`` eagerly; ``library_eager`` instead of ``library``:
    a closure a graph cannot hold (autograd, an optimizer's step), timed
    eagerly. ``peak``: the operations' rate where it is not the bf16
    tensor-core one. ``library_timed``: the library call's ms, timed by the
    caller; ``plain_timed`` likewise the plain version's (``plain`` None). gate: the description of a gate the caller has checked already;
    otherwise err must be within ERR_TOL x ref. wdtype: the row's weight
    format (default: the entry's, ENTRY_WDTYPE; None where it reads none)."""
    def record(entry, shape, err, ref, calls, plain, library, nbytes, nops, gate=None,
               library_eager=None, peak=None, library_timed=None, wdtype=None,
               plain_timed=None, **extra):
        if gate is None and err > ERR_TOL * ref:
            raise AssertionError(f"{entry}[{shape}]: max abs err {err} > {ERR_TOL} x {ref}")
        if sum(x is not None for x in (library, library_eager, library_timed)) > 1:
            raise ValueError(f"{entry}: the library call is timed one way")
        b_ms, b_by = bound(nbytes, nops, bw, peak or peak_ops)
        lib_ms = None if library is None else time_graph(library)
        if library_eager is not None:
            lib_ms = time_eager(library_eager)
        if library_timed is not None:
            lib_ms = library_timed
        rows.append({"entry": entry, "shape": shape,
                     "wdtype": wdtype or ENTRY_WDTYPE.get(entry), "max_abs_err": err,
                     "tolerance": gate or ERR_TOL * ref, "ms": time_graph(calls),
                     "plain_ms": plain_timed if plain is None else time_eager(plain),
                     "library_ms": lib_ms,
                     "bound_ms": b_ms, "bound_by": b_by, **extra,
                     "at_s": time.monotonic() - T_START})

    return record


# The weight format each kernel entry's rows read unless a row says another
# (the fp8 rows); entries that read no quantized weight are left out.
ENTRY_WDTYPE = {e: "int8" for e in (
    "quant_linear", "rms_quant_linear", "quant_linear_residual", "rms_quant_linear_swiglu",
    "rms_quant_linear_argmax", "layer_tail_stream", "mlp_qkv_fused", "mlp_block_fused",
    "layer_megakernel", "giga_decode_step")}
ENTRY_WDTYPE["quant_linear_int4"] = "int4"


def with_rate(row: dict, nbytes: float) -> None:
    """Add the K/V bytes a row's kernel read per call, over its time, in GB/s."""
    row["gb_s"] = nbytes / row["ms"] / 1e6


def build_params(cfg, seed: int, device, dtype: str = "int8"):
    from mila_tpu_torch.inference.quantize import quantize_model_params
    from mila_tpu_torch.models.llama import (add_quantized_lm_head, fuse_llama_projections,
                                             init_llama_params)

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = init_llama_params(cfg, gen, device=device)
    params = quantize_model_params(fuse_llama_projections(params), dtype, device=device)
    return add_quantized_lm_head(params, dtype)


def to_cpu(tree):
    from mila_tpu_torch.inference.quantize import QTensor

    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, QTensor):
        return tree.to("cpu")
    if isinstance(tree, tuple):  # LayerStream: tensors and int fields
        return type(tree)(*(v.cpu() if isinstance(v, torch.Tensor) else v for v in tree))
    return tree.cpu()


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

def _sm_count() -> int:
    return torch.cuda.get_device_properties(0).multi_processor_count


def copies(nbytes: int, most: int) -> int:
    """Distinct copies of ``nbytes`` each to cycle through so that they
    exceed L2 (at most ``most``)."""
    return min(most, max(2, int(2e8 // nbytes) + 1))


def prefill_row(record, name, x, ws, wdtype=None) -> None:
    """quant_linear (the prefill GEMM, K1) over x for projection ``name``,
    cycling over the weights ``ws`` (one a layer); host_us_per_call: the
    wrapper's host time per call (checks, two TMA descriptors, the launch),
    enqueued back to back. Library: ``matmul`` on the weight dequantized to
    x's dtype. Bytes: x read and the output written in x's dtype, the
    weight and its scales as stored (int4 packed)."""
    from mila_tpu_torch.inference.quantize import dequantize
    from mila_tpu_torch.kernels import quant_matmul as qm

    (M, K), N, xb = x.shape, ws[0].q.shape[1], x.element_size()
    w_bf = [dequantize(w, x.dtype) for w in ws[:copies(K * N * xb, len(ws))]]
    w_bytes = ws[0].q.numel() * ws[0].q.element_size() + ws[0].scale.numel() * 4
    got = qm.quant_linear(x, ws[0])
    want = qm.quant_linear_plain(x, ws[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for w in ws:
        qm.quant_linear(x, w)
    host_us = (time.perf_counter() - t0) / len(ws) * 1e6
    torch.cuda.synchronize()
    record("quant_linear", f"{name} M={M}", *max_err(got, want),
           [lambda w=w: qm.quant_linear(x, w) for w in ws],
           lambda: qm.quant_linear_plain(x, ws[0]),
           [lambda w=w: torch.matmul(x, w) for w in w_bf],
           M * K * xb + w_bytes + M * N * xb, 2 * M * K * N, host_us_per_call=host_us,
           wdtype=wdtype)


# The decode GEMV rows (K2): (entry, projection, mode).
DECODE_CASES = (
    ("rms_quant_linear", "wqkv", "store"), ("rms_quant_linear", "lm_head", "store"),
    ("quant_linear_residual", "wo", "residual"),
    ("quant_linear_residual", "down", "residual"),
    ("rms_quant_linear_swiglu", "wgu", "swiglu"),
)


def decode_row(record, entry, name, mode, ws, gam, x, res, wdtype=None) -> None:
    """One decode entry point (K2) at x's rows, cycling over the weights
    ``ws`` and gammas ``gam``; library: ``matmul`` on the bf16 weight."""
    from mila_tpu_torch.inference.quantize import dequantize
    from mila_tpu_torch.kernels import decode_fused as df

    M, K = x.shape
    ldq = ws[0].q.shape[1]
    n_out = ldq // 2 if mode == "swiglu" else ldq
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
    w_bf = [dequantize(w, torch.bfloat16) for w in ws[:copies(K * ldq * 2, len(ws))]]
    library = [lambda w=w: torch.matmul(x, w) for w in w_bf]
    nbytes = (K * ldq + ws[0].scale.numel() * 4 + M * K * 2 + M * n_out * 2
              + (K * 4 if mode != "residual" else M * n_out * 2))
    record(entry, f"{name} M={M}", *max_err(fn(*args), plain(*args)), calls,
           lambda: plain(*args), library, nbytes, 2 * M * K * ldq, wdtype=wdtype,
           **df.launch_plan(M, K, ldq, ws[0].block_size, mode, _sm_count()))


def argmax_row(record, head, g, x, V, eps, wdtype=None) -> None:
    """The greedy head (K4): norm_f -> lm_head -> argmax at x's rows. The
    check: the kernel's token carries a plain logit within tolerance of the
    row's largest (f32 sums in another order may swap near-ties)."""
    from mila_tpu_torch.kernels import decode_fused as df
    from mila_tpu_torch.kernels import quant_matmul as qm

    (M, K), N = x.shape, head.q.shape[1]
    tok = df.rms_quant_linear_argmax(x, g, head, vocab_size=V)
    want_tok = df.rms_quant_linear_argmax_plain(x, g, head, vocab_size=V)
    logits = qm.scaled_partials(df._rms_scaled(x, g, eps), head)[:, :V]
    gap = (logits.max(dim=-1).values - logits.gather(1, tok.long())[:, 0]).abs().max().item()
    record("rms_quant_linear_argmax", f"lm_head M={M}", gap, logits.abs().max().item(),
           [lambda: df.rms_quant_linear_argmax(x, g, head, vocab_size=V)],
           lambda: df.rms_quant_linear_argmax_plain(x, g, head, vocab_size=V), None,
           K * N + N * 4 + M * K * 2 + K * 4 + M * 4, 2 * M * K * N, wdtype=wdtype,
           token_agreement=float((tok == want_tok).float().mean()),
           **df.launch_plan(M, K, N, head.block_size, "argmax", _sm_count()))


def tail_err(got, want):
    errs = [max_err(g, w) for g, w in zip(got, want) if g is not None]
    return max(errs, key=lambda e: e[0] / e[1])


def tail_rows(record, stream, att, x, g1, g2, cfg, wdtype=None) -> list:
    """layer_tail_stream (K7) at a middle layer (cycling over layers 0..L-2
    for the timing) and at the last layer; returns the per-layer pack views
    of layers 0..L-2."""
    from mila_tpu_torch.kernels import layer_fused as lf
    from mila_tpu_torch.kernels import layer_stream as ls
    from mila_tpu_torch.kernels.quant_matmul import WFMT

    L, M = stream.n_layers, att.shape[0]
    H, I, bn = stream.h_dim, stream.i_dim, stream.bn
    Nq = stream.n_qkv * bn
    n_full = stream.n_wo + stream.n_gu + stream.n_down + stream.n_qkv
    ops_tail = 2 * M * (H * H + 3 * H * I)

    def tail_bytes(n_tiles, nq):
        return (n_tiles * (H * bn + bn * 4) + 2 * M * H * 2 + 2 * H * 4 + M * H * 2
                + M * nq * 2)

    mid = L // 2 - 1
    views = [ls._pack_view(stream, i, False) for i in range(L - 1)]
    got = ls.layer_tail_stream(att, x, g1, stream, mid, g2)
    want = lf.tail_plain(att[:, 0], x[:, 0], g1, views[mid], g2, eps=cfg.rms_eps)
    record("layer_tail_stream", f"layer {mid} M={M}",
           *tail_err((got[0][:, 0], got[1][:, 0]), want),
           [lambda i=i: ls.layer_tail_stream(att, x, g1, stream, i, g2) for i in range(L - 1)],
           lambda: lf.tail_plain(att[:, 0], x[:, 0], g1, views[mid], g2, eps=cfg.rms_eps),
           None, tail_bytes(n_full, Nq), ops_tail + 2 * M * H * Nq, wdtype=wdtype,
           plan=lf.tail_launch_plan(M, H, I, bn, stream.n_qkv, 0, 0,
                                    WFMT[stream.w.dtype])[2])
    last = ls._pack_view(stream, L - 1, True)
    got = ls.layer_tail_stream(att, x, g1, stream, L - 1, None)
    want = lf.tail_plain(att[:, 0], x[:, 0], g1, last, g2, eps=cfg.rms_eps)
    record("layer_tail_stream", f"layer {L - 1} (last) M={M}",
           *tail_err((got[0][:, 0],), want[:1]),
           [lambda: ls.layer_tail_stream(att, x, g1, stream, L - 1, None)],
           lambda: lf.tail_plain(att[:, 0], x[:, 0], g1, last, g2, eps=cfg.rms_eps),
           None, tail_bytes(n_full - stream.n_qkv, 0), ops_tail, wdtype=wdtype)
    return views


def mlp_row(record, mps, att, x, g1, cfg, wdtype=None) -> None:
    """mlp_block_fused (K7's MLP entry) at layer 0, cycling over the packs
    ``mps`` (one a layer) for the timing."""
    from mila_tpu_torch.kernels import decode_mlp as dm
    from mila_tpu_torch.kernels import layer_fused as lf
    from mila_tpu_torch.kernels.quant_matmul import WFMT

    M, H, I, bn = att.shape[0], mps[0].h_dim, mps[0].i_dim, mps[0].bn
    n_mlp = mps[0].n_wo + mps[0].n_gu + mps[0].n_down
    got = dm.mlp_block_fused(att, x, g1, mps[0])
    want = dm.mlp_block_plain(att[:, 0], x[:, 0], g1, mps[0], eps=cfg.rms_eps)
    record("mlp_block_fused", f"layer 0 M={M} bn={bn}", *max_err(got[:, 0], want),
           [lambda p=p: dm.mlp_block_fused(att, x, g1, p) for p in mps],
           lambda: dm.mlp_block_plain(att[:, 0], x[:, 0], g1, mps[0], eps=cfg.rms_eps), None,
           n_mlp * (H * bn + bn * 4) + 3 * M * H * 2 + H * 4, 2 * M * (H * H + 3 * H * I),
           wdtype=wdtype, plan=lf.tail_launch_plan(M, H, I, bn, 0, 0, 0, WFMT[mps[0].w.dtype])[2])


def mega_row(record, megas, caches, old, qkv, xm, g1, g2, cfg, mid, wdtype=None) -> None:
    """K8's one-layer launch (layer_megakernel) at layer ``mid`` against its
    plain version: B rows, old rows ``old`` in T-row caches, q in slot
    order; timed cycling over ``megas`` and their caches (all but the last
    layer's). Bound: the layer's tiles and scale rows, the K/V rows read and
    the activations, once."""
    from mila_tpu_torch.kernels import layer_mega as lm
    from mila_tpu_torch.models.llama import Llama

    dev = old.device
    B, (T, NKV, HD) = old.shape[0], caches[0][0].shape[1:]
    NH, KD = cfg.num_heads, NKV * HD
    NQ = NH * HD
    pk = megas[mid]
    H, I, bn = pk.h_dim, pk.i_dim, pk.bn
    Nq = pk.n_qkv * bn
    n_full = pk.n_wo + pk.n_gu + pk.n_down + pk.n_qkv
    live_old = int(old.sum())
    cos, sin = Llama(cfg)._rope(old[:, None].long())
    cos_t, sin_t = Llama._tiled_tables(cos, sin, NKV)
    kg, vg = (t.clone() for t in caches[mid])
    kp, vp = (t.clone() for t in caches[mid])
    got = lm.layer_megakernel(qkv, xm, g1, pk, kg, vg, old, cos_t, sin_t, g2, num_heads=NH)
    want = lm.layer_megakernel_plain(qkv, xm, g1, pk, kp, vp, old, cos_t, sin_t, g2,
                                     num_heads=NH, eps=cfg.rms_eps, scale=HD ** -0.5)
    rows_b = torch.arange(B, device=dev)
    errs = [max_err(got[0], want[0]), max_err(got[1], want[1]),
            max_err(kg[rows_b, old.long()], kp[rows_b, old.long()]),
            max_err(vg[rows_b, old.long()], vp[rows_b, old.long()])]
    worst = max(errs, key=lambda e: e[0] / e[1])
    grid_m, _, plan_m = lm.step_launch_plan(B, H, I, bn, pk.n_qkv, 0, dev.index or 0, 0,
                                            lm.STREAM_WFMT[pk.w.dtype])
    tail_bytes = n_full * (H * bn + bn * 4) + 2 * B * H * 2 + 2 * H * 4 + B * H * 2 + B * Nq * 2
    ops = 2 * B * (H * H + 3 * H * I) + 2 * B * H * Nq + 4 * (live_old + B) * NH * HD
    record("layer_megakernel", f"layer {mid} B={B} old 128-191 T={T}", *worst,
           [lambda i=i: lm.layer_megakernel(qkv, xm, g1, megas[i], caches[i][0], caches[i][1],
                                            old, cos_t, sin_t, g2, num_heads=NH)
            for i in range(len(megas) - 1)],
           lambda: lm.layer_megakernel_plain(qkv, xm, g1, pk, kp, vp, old, cos_t, sin_t,
                                             g2, num_heads=NH, eps=cfg.rms_eps,
                                             scale=HD ** -0.5), None,
           tail_bytes + live_old * KD * 2 * 2 + B * (NQ + 2 * KD) * 2
           + 2 * B * KD * 2 + 2 * B * KD * 4, ops,
           grid=grid_m, plan=plan_m, wdtype=wdtype,
           errors={"x_out": errs[0][0], "qkv_next": errs[1][0], "k_row": errs[2][0],
                   "v_row": errs[3][0]})


def giga_row(record, gp, wte, tokens, old, kpool, vpool, cfg, wdtype=None) -> None:
    """The whole step (giga_decode_step) at full depth, tokens mode, against
    its plain version (_giga_ref) with the JAX package's gate for this kernel
    (benchmarks/r5_giga.py): tokens agree on >= 7/8 of the rows, logits and
    the written K/V rows within 5e-2 * max(1, L/4) + 5e-2 relative. The
    kernel's f32 residual drifts from the plain version's bf16 one with
    depth, so layer 0's rows (no drift yet: the write, RoPE and slot order)
    must also be within ERR_TOL of their largest value."""
    from mila_tpu_torch.kernels import decode_giga as dg
    from mila_tpu_torch.kernels import layer_mega as lm

    dev = old.device
    L, B, T, KD = kpool.shape
    H, I, HD, NH = gp.h_dim, gp.i_dim, gp.hd, gp.nh
    live_old = int(old.sum())
    rows_b = torch.arange(B, device=dev)
    kw, vw = kpool.clone(), vpool.clone()
    got = dg.giga_decode_step(wte, None, None, old, gp, kpool, vpool, tokens=tokens)
    xe, cos_e, sin_e = dg._embed_rope(wte, tokens, old, gp)
    want = dg.giga_decode_plain(xe, cos_e, sin_e, old, gp, kw, vw, sm_scale=HD ** -0.5)
    agree = int((got[0] == want[0]).sum())
    atol = 5e-2 * max(1.0, L / 4)
    lg, lw = got[1].float(), want[1].float()
    l_err = (lg - lw).abs().max().item()
    written = [(p[:, rows_b, old.long()], r[:, rows_b, old.long()])
               for p, r in ((kpool, kw), (vpool, vw))]  # [L, B, KD] each
    row_errs = [max_err(g, w) for g, w in written]
    first = [max_err(g[0], w[0]) for g, w in written]
    by_layer = [max(max_err(g[i], w[i])[0] for g, w in written) for i in range(L)]
    if agree < (B * 7) // 8 or not torch.isfinite(lg).all() \
            or not torch.allclose(lg, lw, rtol=5e-2, atol=atol) \
            or not all(torch.allclose(g.float(), w.float(), rtol=5e-2, atol=atol)
                       for g, w in written) \
            or any(e > ERR_TOL * r for e, r in first):
        raise AssertionError(f"giga_decode_step[{gp.w.dtype}]: tokens {agree}/{B}, logits max "
                             f"err {l_err} (atol {atol}), K/V rows {row_errs}, layer 0 {first}")
    grid_g, _, plan_g = lm.step_launch_plan(B, H, I, gp.bn, gp.n_qkv, gp.n_head, dev.index or 0,
                                            1, lm.STREAM_WFMT[gp.w.dtype])
    ops_giga = 2 * B * gp.w.numel() + 4 * (live_old + B) * NH * HD * L
    record("giga_decode_step", f"L={L} B={B} old 128-191 T={T} tokens", l_err,
           lw.abs().max().item(),
           [lambda: dg.giga_decode_step(wte, None, None, old, gp, kpool, vpool, tokens=tokens)],
           lambda: dg.giga_decode_plain(xe, cos_e, sin_e, old, gp, kw, vw, sm_scale=HD ** -0.5),
           None, gp.w.nbytes + gp.s.nbytes + live_old * KD * 2 * 2 * L + B * H * 2
           + 2 * L * B * KD * 2 + B * gp.n_head * gp.bn * 2 + B * 4, ops_giga,
           gate=f"tokens >= 7/8; logits, K/V rows atol {atol} rtol 5e-2; layer-0 rows "
                f"{ERR_TOL} x max|ref|",
           token_agreement=agree / B, grid=grid_g, plan=plan_g, wdtype=wdtype,
           errors={"logits": l_err, "k_rows": row_errs[0][0], "v_rows": row_errs[1][0],
                   "kv_rows_by_layer": by_layer})


def phase_kernels(params, packs, params4, cfg, bw, peak_ops, rng):
    from mila_tpu_torch.inference.kv_cache import make_paged_pools
    from mila_tpu_torch.inference.quantize import dequantize
    from mila_tpu_torch.kernels import dense_attention as da
    from mila_tpu_torch.kernels import flash_attention as fa
    from mila_tpu_torch.kernels import layer_fused as lf
    from mila_tpu_torch.kernels import paged_attention as pa
    from mila_tpu_torch.kernels import quant_matmul as qm
    from mila_tpu_torch.models.llama import Llama

    dev = torch.device("cuda")
    L = cfg.num_layers
    layers = [params[f"h{i}"] for i in range(L)]
    bf16 = torch.bfloat16

    # Rows added after a path's gates were set draw from their own stream, so
    # the inputs of every earlier row (and of the phases after) stay as they were.
    extra = np.random.default_rng(6)

    def rand(*shape, gen=None):
        return torch.from_numpy((gen or rng).standard_normal(shape).astype(np.float32)).to(
            dev, bf16)

    rows = []
    record = recorder(rows, bw, peak_ops)

    # quant_linear at prefill: M = max_batch * largest bucket = 1024 rows for
    # every projection, and wgu at 4096 rows (serve long's 4096-token
    # bucket). host_us_per_call: the wrapper's host time per call (checks,
    # two TMA descriptors, the launch), enqueued back to back.
    for name, M in (("wgu", 1024), ("down", 1024), ("wqkv", 1024), ("wo", 1024),
                    ("wgu", 4096)):
        K, N = LAYER_SHAPES[name]
        x = rand(M, K, gen=None if M == 1024 and name in ("wgu", "down") else extra)
        prefill_row(record, name, x, [blk[name]["weight"] for blk in layers])

    # decode entry points at M = 8 rows (max_batch decode step).
    M = 8
    gam = [1.0 + 0.1 * rand(LAYER_SHAPES["wqkv"][0]).float() for _ in range(L)]
    head = params["lm_head_q"]
    for entry, name, mode in DECODE_CASES:
        ws = [head] if name == "lm_head" else [blk[name]["weight"] for blk in layers]
        K, ldq = ws[0].q.shape
        x = rand(M, K)
        res = rand(M, ldq // 2 if mode == "swiglu" else ldq)
        decode_row(record, entry, name, mode, ws, gam, x, res)

    # wqkv at M 32 (m_tile 32: four row tiles of x), from its own stream.
    ws = [blk["wqkv"]["weight"] for blk in layers]
    decode_row(record, "rms_quant_linear", "wqkv", "store", ws, gam,
               rand(32, ws[0].q.shape[0], gen=np.random.default_rng(11)), None)

    # The greedy head: norm_f -> lm_head -> argmax at M = 8.
    V = cfg.vocab_size
    argmax_row(record, head, gam[0], rand(M, head.q.shape[0]), V, cfg.rms_eps)

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
    record("paged_decode_attention", f"B={B} lens<=384", *max_err(got, want),
           [lambda i=i: pa.paged_decode_attention(q, pools["k"][i], pools["v"][i], table, lens)
            for i in range(L)],
           lambda: pa.paged_decode_attention_plain(q, pools["k"][0], pools["v"][0], table,
                                                   lens),
           [lambda k=k, v=v: sdpa(qs, k, v, attn_mask=mask, enable_gqa=True) for k, v in kv],
           live * NKV * HD * 2 * 2 + 2 * B * NH * HD * 2 + B * W * 4 + B * 4,
           4 * live * NH * HD)
    del pools, kv

    # Contiguous-cache attention: B = 8 rows, lengths 129-192 in a T = 512
    # cache (the bench's decode shape), one cache per layer.
    T = 512
    KD, NQ = NKV * HD, NH * HD
    caches = [(rand(B, T, NKV, HD), rand(B, T, NKV, HD)) for _ in range(L)]
    lens_np = rng.integers(129, 193, B).astype(np.int32)
    lens = torch.from_numpy(lens_np).to(dev)
    live = int(lens_np.sum())
    q = rand(B, 1, NH, HD)
    k0, v0 = caches[0]
    got = da.dense_decode_attention(q, k0, v0, lens)
    want = da.dense_decode_attention_plain(q, k0, v0, lens)
    kvt = [(k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()) for k, v in caches]
    mask = (torch.arange(T, device=dev)[None, :] < lens[:, None])[:, None, None, :]
    qs = q.transpose(1, 2)
    record("dense_decode_attention", f"B={B} lens 129-192 T={T}", *max_err(got, want),
           [lambda k=k, v=v: da.dense_decode_attention(q, k, v, lens) for k, v in caches],
           lambda: da.dense_decode_attention_plain(q, k0, v0, lens),
           [lambda k=k, v=v: sdpa(qs, k, v, attn_mask=mask, enable_gqa=True) for k, v in kvt],
           live * KD * 2 * 2 + 2 * B * NQ * 2 + B * 4, 4 * live * NH * HD,
           splits=da.plan_splits(B, NKV, T, _sm_count()))
    with_rate(rows[-1], live * KD * 2 * 2)
    del kvt

    # Fused attention: RoPE from the raw qkv row, old rows = lens - 1, the
    # new row written in place. Compared: att, k_new and both caches whole.
    old = lens - 1
    cos, sin = Llama(cfg)._rope(old[:, None].long())
    c2, s2 = cos.reshape(B, HD // 2), sin.reshape(B, HD // 2)
    cos_t = torch.cat([c2, c2], -1).repeat(1, NKV)
    sin_t = torch.cat([-s2, s2], -1).repeat(1, NKV)
    qkv = rand(B, NQ + 2 * KD)
    kg, vg, kp, vp = k0.clone(), v0.clone(), k0.clone(), v0.clone()
    att, k_new, _, _ = da.fused_decode_attention(qkv, None, cos_t, sin_t, kg, vg, old,
                                                 num_heads=NH)
    watt, wk_new, _, _ = da.fused_decode_attention_plain(qkv, cos_t, sin_t, kp, vp, old,
                                                         num_heads=NH)
    errs = [max_err(att, watt), max_err(k_new, wk_new), max_err(kg, kp), max_err(vg, vp)]
    worst = max(errs, key=lambda e: e[0] / e[1])
    live_old = live - B
    record("fused_decode_attention", f"B={B} old 128-191 T={T}", *worst,
           [lambda k=k, v=v: da.fused_decode_attention(qkv, None, cos_t, sin_t, k, v, old,
                                                       num_heads=NH) for k, v in caches],
           lambda: da.fused_decode_attention_plain(qkv, cos_t, sin_t, kp, vp, old,
                                                   num_heads=NH), None,
           live_old * KD * 2 * 2 + B * (NQ + 2 * KD) * 2 + 2 * B * KD * 4 + B * NQ * 2
           + B * KD * 2 + 2 * B * KD * 2, 4 * live * NH * HD,
           errors={"att": errs[0][0], "k_new": errs[1][0], "k_cache": errs[2][0],
                   "v_cache": errs[3][0]}, splits=da.plan_splits(B, NKV, T, _sm_count()))
    with_rate(rows[-1], live_old * KD * 2 * 2)
    del caches, kg, vg, kp, vp

    # One long request in the contiguous cache: B 1, 4096 live rows of a
    # 4096-row cache, cycling over distinct caches (the paged B 1 row's
    # request, without the page table).
    T1 = 4096
    tgen = torch.Generator(device=dev).manual_seed(10)
    caches = [(torch.randn(1, T1, NKV, HD, device=dev, generator=tgen).to(bf16),
               torch.randn(1, T1, NKV, HD, device=dev, generator=tgen).to(bf16))
              for _ in range(copies(T1 * KD * 2 * 2, L))]
    lens1 = torch.full((1,), T1, dtype=torch.int32, device=dev)
    q1 = rand(1, 1, NH, HD, gen=np.random.default_rng(10))
    k0, v0 = caches[0]
    kvt = [(k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()) for k, v in caches]
    mask = (torch.arange(T1, device=dev)[None, :] < lens1[:, None])[:, None, None, :]
    qs = q1.transpose(1, 2)
    record("dense_decode_attention", f"B=1 len={T1} T={T1}",
           *max_err(da.dense_decode_attention(q1, k0, v0, lens1),
                    da.dense_decode_attention_plain(q1, k0, v0, lens1)),
           [lambda k=k, v=v: da.dense_decode_attention(q1, k, v, lens1) for k, v in caches],
           lambda: da.dense_decode_attention_plain(q1, k0, v0, lens1),
           [lambda k=k, v=v: sdpa(qs, k, v, attn_mask=mask, enable_gqa=True) for k, v in kvt],
           T1 * KD * 2 * 2 + 2 * NQ * 2 + 4, 4 * T1 * NH * HD,
           splits=da.plan_splits(1, NKV, T1, _sm_count()))
    with_rate(rows[-1], T1 * KD * 2 * 2)
    del caches, kvt

    # The layer tail over the packed stream: a middle layer (cycling over
    # layers 0..L-2 for the timing) and the last layer; mlp_qkv_fused over
    # per-layer pack views of the same stream.
    stream = packs["layer_stream"]["layer_stream"]
    H, I, bn = stream.h_dim, stream.i_dim, stream.bn
    Nq = stream.n_qkv * bn
    att, x = rand(M, 1, H), rand(M, 1, H)
    g1, g2 = gam[1], gam[2]
    n_full = stream.n_wo + stream.n_gu + stream.n_down + stream.n_qkv
    ops_tail = 2 * M * (H * H + 3 * H * I)

    def tail_bytes(n_tiles, nq):
        return (n_tiles * (H * bn + bn * 4) + 2 * M * H * 2 + 2 * H * 4 + M * H * 2
                + M * nq * 2)

    mid = L // 2 - 1
    views = tail_rows(record, stream, att, x, g1, g2, cfg)
    got = lf.mlp_qkv_fused(att, x, g1, views[0], g2)
    want = lf.tail_plain(att[:, 0], x[:, 0], g1, views[0], g2, eps=cfg.rms_eps)
    record("mlp_qkv_fused", f"layer 0 M={M}", *tail_err((got[0][:, 0], got[1][:, 0]), want),
           [lambda v=v: lf.mlp_qkv_fused(att, x, g1, v, g2) for v in views],
           lambda: lf.tail_plain(att[:, 0], x[:, 0], g1, views[0], g2, eps=cfg.rms_eps),
           None, tail_bytes(n_full, Nq), ops_tail + 2 * M * H * Nq)

    # The MLP-block stream (bn 2048, no next wqkv) at layer 0, M = 8,
    # cycling over the 16 layers' packs for the timing.
    mlp_row(record, [packs["mlp"][f"h{i}"]["mlp_pack"] for i in range(L)], att, x, g1, cfg)

    # The per-layer megakernel at layer 7 (B 8, old rows 128-191 in a T 512
    # cache, q in slot order), cycling over layers 0..14 and their caches.
    T = 512
    megas = [packs["mega"][f"h{i}"]["mega_pack"] for i in range(L)]
    caches = [(rand(B, T, NKV, HD), rand(B, T, NKV, HD)) for _ in range(L)]
    old = torch.from_numpy(rng.integers(128, 192, B).astype(np.int32)).to(dev)
    qkv, xm = rand(B, NQ + 2 * KD), rand(B, H)
    mega_row(record, megas, caches, old, qkv, xm, g1, g2, cfg, mid)
    del caches

    # The whole step (giga) at full depth, tokens mode: B 8, old rows
    # 128-191 in T 512 pools, with the giga gate (giga_row).
    gp = packs["giga"]["giga_pack"]
    tokens = torch.from_numpy(rng.integers(0, V, B).astype(np.int32)).to(dev)
    giga_row(record, gp, params["embed"]["wte"], tokens, old, rand(L, B, T, KD),
             rand(L, B, T, KD), cfg)

    # Packed int4 weights (the long path's decode projections and head) at
    # M 8, and wqkv at M 32, cycling over the 16 layers' weights.
    layers4 = [params4[f"h{i}"] for i in range(L)]
    for name, M4 in (("wqkv", 8), ("wo", 8), ("wgu", 8), ("down", 8), ("lm_head", 8),
                     ("wqkv", 32)):
        ws = ([params4["lm_head_q"]] if name == "lm_head"
              else [blk[name]["weight"] for blk in layers4])
        K, N = ws[0].packed_rows, ws[0].q.shape[1]
        x = rand(M4, K)
        w_bf = [dequantize(w, bf16) for w in ws[:copies(K * N * 2, L)]]
        record("quant_linear_int4", f"{name} M={M4}",
               *max_err(qm.quant_linear_int4(x, ws[0]), qm.quant_linear_int4_plain(x, ws[0])),
               [lambda w=w: qm.quant_linear_int4(x, w) for w in ws],
               lambda: qm.quant_linear_int4_plain(x, ws[0]),
               [lambda w=w: torch.matmul(x, w) for w in w_bf],
               K // 2 * N + ws[0].scale.numel() * 4 + M4 * K * 2 + M4 * N * 2, 2 * M4 * K * N)
        del w_bf

    # Flash attention (causal, bf16): Llama-3.2-1B's heads at B 1 T 4096 and
    # B 4 T 2048, a D 128 case (Llama-3.2-3B's 24 heads over 8), a kv_offset
    # window (Tq 512 over Tkv 2048). Bound: the causal pairs' operations (4
    # per pair and head dim) against q, k, v and out read or written once.
    # Gate: each (b, t, head) row within ERR_TOL of its own largest value.
    from mila_tpu_torch.ops import causal_mask
    for Bf, Tkv, Tq, NHf, NKVf, Df in ((1, 4096, 4096, NH, NKV, HD), (4, 2048, 2048, NH, NKV, HD),
                                       (1, 2048, 2048, 24, 8, 128), (1, 2048, 512, NH, NKV, HD)):
        off = Tkv - Tq
        q, k, v = rand(Bf, Tq, NHf, Df), rand(Bf, Tkv, NKVf, Df), rand(Bf, Tkv, NKVf, Df)
        got = fa.flash_attention(q, k, v, kv_offset=off)
        want = fa.flash_attention_plain(q, k, v, kv_offset=off)
        err, row_err = max_err(got, want), max_row_err(got, want)
        shape = (f"B={Bf} T={Tkv} NH={NHf} NKV={NKVf} D={Df}"
                 + (f" Tq={Tq} kv_offset={off}" if off else ""))
        if row_err > ERR_TOL:
            raise AssertionError(f"flash_attention[{shape}]: a row's max abs err is "
                                 f"{row_err} > {ERR_TOL} of its largest value")
        pairs = sum(min(Tkv, i + off + 1) for i in range(Tq))
        # SDPA: is_causal where Tq == Tkv (its diagonal is top-left); the
        # kv_offset window takes the same causal mask as an explicit one.
        qs, ks, vs = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        cm = None if off == 0 else causal_mask(Tq, Tkv, off, device=dev)
        library = [lambda: sdpa(qs, ks, vs, attn_mask=cm, is_causal=cm is None,
                                enable_gqa=True)]
        record("flash_attention", shape, *err,
               [lambda q=q, k=k, v=v, o=off: fa.flash_attention(q, k, v, kv_offset=o)],
               lambda: fa.flash_attention_plain(q, k, v, kv_offset=off), library,
               2 * (2 * q.numel() + 2 * k.numel()), 4 * Bf * NHf * Df * pairs,
               gate=f"each (b, t, head) row: max |d| <= {ERR_TOL} x its max |ref|",
               max_row_rel_err=row_err, family=fa.routes(q.dtype, Df)[0],
               cuda_launches=graph_launches(lambda: fa.flash_attention(q, k, v, kv_offset=off),
                                            fa.flash_attention))
        rows[-1]["tflops"] = 4 * Bf * NHf * Df * pairs / rows[-1]["ms"] / 1e9
        del q, k, v, got, want, qs, ks, vs, library

    # Paged decode attention up to 4096 tokens in 128-token pages, cycling
    # over distinct pools: int8 pages at B 8 (one row at 4096) and at B 1
    # (one request of 4096 tokens), bf16 pages at B 8. Library: SDPA over
    # the same K/V (int8 dequantized) gathered to contiguous bf16 first.
    ps, W = 128, 32
    T = W * ps
    for B, dtype in ((8, torch.int8), (1, torch.int8), (8, bf16)):
        gen = rng if (B, dtype) == (8, torch.int8) else extra
        P = B * W + 1
        quant = dtype == torch.int8
        n_pools = copies(2 * P * NKV * HD * ps * (1 if quant else 2), L)
        pools = make_paged_pools(n_pools, NKV, HD, P, ps, dtype, dev)
        tgen = None if gen is rng else torch.Generator(device=dev).manual_seed(B)
        for name in ("k", "v"):
            if quant:
                pools[name].copy_(torch.randint(-127, 128, pools[name].shape, device=dev,
                                                dtype=torch.int8, generator=tgen))
                pools[name + "_scale"].uniform_(0.002, 0.02, generator=tgen)
            else:
                pools[name].normal_(generator=tgen)
        lens_np = gen.integers(1, W * ps + 1, B).astype(np.int32)
        lens_np[0] = W * ps
        table_np = (1 + gen.permutation(P - 1)[: B * W]).reshape(B, W).astype(np.int32)
        lens, table = torch.from_numpy(lens_np).to(dev), torch.from_numpy(table_np).to(dev)
        q = rand(B, 1, NH, HD, gen=gen)

        def layer(i, pools=pools, quant=quant):
            return (pools["k"][i], pools["v"][i],
                    {"k_scale": pools["k_scale"][i], "v_scale": pools["v_scale"][i]}
                    if quant else {})

        kp0, vp0, sc0 = layer(0)
        got = pa.paged_decode_attention(q, kp0, vp0, table, lens, **sc0)
        want = pa.paged_decode_attention_plain(q, kp0, vp0, table, lens, **sc0)

        def dequant_gathered(pool, scale, table=table, B=B):
            deq = pool if scale is None else (pool.float() * scale[:, :, None, :]).to(bf16)
            return deq[table.long()].permute(0, 2, 1, 4, 3).reshape(B, NKV, T, HD).contiguous()

        kv = [(dequant_gathered(pools["k"][i], pools["k_scale"][i] if quant else None),
               dequant_gathered(pools["v"][i], pools["v_scale"][i] if quant else None))
              for i in range(n_pools)]
        mask = (torch.arange(T, device=dev)[None, :] < lens[:, None])[:, None, None, :]
        qs = q.transpose(1, 2)
        live = int(lens_np.sum())
        kv_bytes = live * NKV * (HD + 4) * 2 if quant else live * NKV * HD * 2 * 2
        what = "int8" if quant else "bf16"
        shape = (f"{what} pages B={B} " + ("len=4096" if B == 1 else "lens<=4096")
                 + f" ps={ps}")
        record("paged_decode_attention", shape, *max_err(got, want),
               [lambda i=i, layer=layer, q=q, table=table, lens=lens:
                pa.paged_decode_attention(q, *layer(i)[:2], table, lens, **layer(i)[2])
                for i in range(n_pools)],
               lambda: pa.paged_decode_attention_plain(q, kp0, vp0, table, lens, **sc0),
               [lambda k=k, v=v, qs=qs, mask=mask: sdpa(qs, k, v, attn_mask=mask,
                                                        enable_gqa=True) for k, v in kv],
               kv_bytes + 2 * B * NH * HD * 2 + B * W * 4 + B * 4, 4 * live * NH * HD,
               splits=pa.plan_splits(B, NKV, W, ps, _sm_count()))
        del pools, kv, got, want
    torch.cuda.synchronize()
    return rows


def phase_kernels_fp8(params8, packed8, mlp8, mega8, cfg, bw, peak_ops):
    """The fp8 branches of the one-byte kernels at the served shapes, each
    beside its plain version, its bound (the int8 rows' formula: the weights
    are one byte) and ``matmul`` on a bf16 weight where the int8 row has it:
    K1 wgu at M 1024 in e4m3 and wqkv at M 1024 in e5m2; K2 wqkv, wo, down,
    wgu and the head at M 8, and K4, in e4m3; K7 at a middle and the last
    layer of the e4m3 stream; the MLP block at layer 0; K8's one-layer
    launch at layer 7 of the e4m3 model's pack_decode_megalayers and on a
    3-layer e5m2 pack. Inputs from their own random stream."""
    from mila_tpu_torch.inference.quantize import quantize
    from mila_tpu_torch.kernels.layer_mega import pack_mega_layer

    gen = np.random.default_rng(13)
    dev, bf16, L, M = torch.device("cuda"), torch.bfloat16, cfg.num_layers, 8
    layers = [params8[f"h{i}"] for i in range(L)]

    def rand(*shape):
        return torch.from_numpy(gen.standard_normal(shape).astype(np.float32)).to(dev, bf16)

    rows = []
    record = recorder(rows, bw, peak_ops)
    prefill_row(record, "wgu", rand(1024, LAYER_SHAPES["wgu"][0]),
                [blk["wgu"]["weight"] for blk in layers], "fp8_e4m3")
    K, N = LAYER_SHAPES["wqkv"]
    tgen = torch.Generator(device=dev).manual_seed(13)
    w5 = [quantize(torch.randn(K, N, device=dev, generator=tgen) * 0.02, "fp8_e5m2")
          for _ in range(L)]
    prefill_row(record, "wqkv", rand(1024, K), w5, "fp8_e5m2")
    del w5
    gam = [1.0 + 0.1 * rand(K).float() for _ in range(L)]
    head = params8["lm_head_q"]
    for entry, name, mode in DECODE_CASES:
        ws = [head] if name == "lm_head" else [blk[name]["weight"] for blk in layers]
        Kw, ldq = ws[0].q.shape
        decode_row(record, entry, name, mode, ws, gam, rand(M, Kw),
                   rand(M, ldq // 2 if mode == "swiglu" else ldq), "fp8_e4m3")
    argmax_row(record, head, gam[0], rand(M, head.q.shape[0]), cfg.vocab_size, cfg.rms_eps,
               "fp8_e4m3")
    stream = packed8["layer_stream"]
    H = stream.h_dim
    att, x = rand(M, 1, H), rand(M, 1, H)
    tail_rows(record, stream, att, x, gam[1], gam[2], cfg, "fp8_e4m3")
    mlp_row(record, [mlp8[f"h{i}"]["mlp_pack"] for i in range(L)], att, x, gam[1], cfg,
            "fp8_e4m3")

    # K8 on fp8 tile streams (B 8, old rows 128-191 in T 512 caches): layer
    # 7 of the e4m3 model, cycling over its layers as the int8 row does,
    # and layer 0 of three random e5m2 layers at the same widths.
    NH, NKV, HD, I = cfg.num_heads, cfg.num_kv_heads, cfg.hd, stream.i_dim
    KD, B, T = NKV * HD, M, 512

    def e5m2(*shape):
        return quantize(torch.randn(*shape, device=dev, generator=tgen) * 0.02, "fp8_e5m2")

    e5 = [pack_mega_layer(e5m2(NH * HD, H), e5m2(H, 2 * I), e5m2(I, H),
                          e5m2(H, NH * HD + 2 * KD), nh=NH, nkv=NKV, hd=HD) for _ in range(3)]
    old = torch.from_numpy(gen.integers(128, 192, B).astype(np.int32)).to(dev)
    for wdt, megas, mid in (("fp8_e4m3", [mega8[f"h{i}"]["mega_pack"] for i in range(L)],
                             L // 2 - 1), ("fp8_e5m2", e5, 0)):
        if megas[mid].w.dtype != (torch.float8_e4m3fn if wdt == "fp8_e4m3"
                                  else torch.float8_e5m2):
            raise AssertionError(f"kernels fp8: the {wdt} mega pack holds {megas[mid].w.dtype}")
        caches = [(rand(B, T, NKV, HD), rand(B, T, NKV, HD)) for _ in megas]
        mega_row(record, megas, caches, old, rand(B, NH * HD + 2 * KD), rand(B, H), gam[1],
                 gam[2], cfg, mid, wdt)
        del caches
    del e5
    torch.cuda.synchronize()
    return rows


def phase_kernels_pairs(cfg, bw, peak_ops):
    """K3 and K5 at the mixed (q, cache) dtype pairs of the GPT-2 and
    speculative serving paths, each beside its plain version, its bound and
    SDPA: K3 with an f32
    q over bf16 pages at GPT-2 124M's decode (B 8, NH 12 = NKV, lens <= 384)
    and a bf16 q over f32 pages at Llama-3.2-1B's heads; K5 (dense) with an
    f32 q over a bf16 cache and the reverse at Llama-3.2-1B's decode shape
    (B 8, lens 129-192, T 512) and bf16 at the speculative tiny draft's
    heads (NH 4, NKV 2, HD 32: JAX sends that shape to XLA); the fused entry
    with an f32 qkv over a bf16 cache. SDPA takes one dtype: it reads K/V
    cast to q's dtype (and gathered, for pages) beforehand, not timed.
    Inputs from their own random stream; every row carries its dtype pair."""
    from mila_tpu_torch.inference.kv_cache import make_paged_pools
    from mila_tpu_torch.kernels import dense_attention as da
    from mila_tpu_torch.kernels import paged_attention as pa
    from mila_tpu_torch.models.llama import Llama

    dev, f32, bf16 = torch.device("cuda"), torch.float32, torch.bfloat16
    gen = np.random.default_rng(30)
    tgen = torch.Generator(device=dev).manual_seed(30)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = []
    record = recorder(rows, bw, peak_ops)

    def rand(*shape, dtype=bf16):
        return torch.randn(*shape, device=dev, generator=tgen).to(dtype)

    def name(qd, kd):
        return f"q {str(qd)[6:]} / kv {str(kd)[6:]}"

    # Paged: L layers of pools, cycled for the timing.
    for qd, kd, NH, NKV, L in ((f32, bf16, 12, 12, 12), (bf16, f32, 32, 8, 16)):
        B, HD, ps, W = 8, 64, 128, 4
        P, T = B * W + 1, W * ps
        pools = make_paged_pools(L, NKV, HD, P, ps, kd, dev)
        for t in pools.values():
            t.copy_(rand(*t.shape, dtype=kd))
        lens_np = gen.integers(1, T - 127, B).astype(np.int32)
        lens_np[0] = T - 128
        table_np = (1 + gen.permutation(P - 1)[: B * W]).reshape(B, W).astype(np.int32)
        lens, table = torch.from_numpy(lens_np).to(dev), torch.from_numpy(table_np).to(dev)
        q = rand(B, 1, NH, HD, dtype=qd)
        got = pa.paged_decode_attention(q, pools["k"][0], pools["v"][0], table, lens)
        want = pa.paged_decode_attention_plain(q, pools["k"][0], pools["v"][0], table, lens)
        if got.dtype != qd:
            raise AssertionError(f"paged {name(qd, kd)}: output in {got.dtype}")

        def gathered(pool):
            return (pool[table.long()].permute(0, 2, 1, 4, 3).reshape(B, NKV, T, HD)
                    .to(qd).contiguous())

        kv = [(gathered(pools["k"][i]), gathered(pools["v"][i])) for i in range(L)]
        mask = (torch.arange(T, device=dev)[None, :] < lens[:, None])[:, None, None, :]
        qs = q.transpose(1, 2)
        live, qb, kb = int(lens_np.sum()), q.element_size(), pools["k"].element_size()
        record("paged_decode_attention", f"B={B} lens<={T - 128} NH={NH} NKV={NKV} "
               f"{name(qd, kd)}", *max_err(got, want),
               [lambda i=i: pa.paged_decode_attention(q, pools["k"][i], pools["v"][i], table,
                                                      lens) for i in range(L)],
               lambda: pa.paged_decode_attention_plain(q, pools["k"][0], pools["v"][0], table,
                                                       lens),
               [lambda k=k, v=v: sdpa(qs, k, v, attn_mask=mask, enable_gqa=True)
                for k, v in kv],
               live * NKV * HD * kb * 2 + 2 * B * NH * HD * qb + B * W * 4 + B * 4,
               4 * live * NH * HD, dtype=name(qd, kd),
               splits=pa.plan_splits(B, NKV, W, ps, _sm_count()))
        with_rate(rows[-1], live * NKV * HD * kb * 2)
        del pools, kv

    # Dense: Llama-3.2-1B's decode shape in both mixed pairs, the tiny
    # draft's heads in bf16.
    B, T = 8, 512
    for qd, kd, NH, NKV, HD, L in ((f32, bf16, 32, 8, 64, 16), (bf16, f32, 32, 8, 64, 16),
                                   (bf16, bf16, 4, 2, 32, 2)):
        KD = NKV * HD
        caches = [(rand(B, T, NKV, HD, dtype=kd), rand(B, T, NKV, HD, dtype=kd))
                  for _ in range(copies(B * T * KD * 2 * 4, L))]
        lens_np = gen.integers(129, 193, B).astype(np.int32)
        lens = torch.from_numpy(lens_np).to(dev)
        live, q = int(lens_np.sum()), rand(B, 1, NH, HD, dtype=qd)
        k0, v0 = caches[0]
        got = da.dense_decode_attention(q, k0, v0, lens)
        if got.dtype != qd:
            raise AssertionError(f"dense {name(qd, kd)}: output in {got.dtype}")
        kvt = [(k.transpose(1, 2).to(qd).contiguous(), v.transpose(1, 2).to(qd).contiguous())
               for k, v in caches]
        mask = (torch.arange(T, device=dev)[None, :] < lens[:, None])[:, None, None, :]
        qs, kb = q.transpose(1, 2), k0.element_size()
        draft = " tiny draft" if NH == 4 else ""
        record("dense_decode_attention", f"B={B} lens 129-192 T={T} NH={NH} HD={HD} "
               f"{name(qd, kd)}{draft}", *max_err(got, da.dense_decode_attention_plain(
                   q, k0, v0, lens)),
               [lambda k=k, v=v: da.dense_decode_attention(q, k, v, lens) for k, v in caches],
               lambda: da.dense_decode_attention_plain(q, k0, v0, lens),
               [lambda k=k, v=v: sdpa(qs, k, v, attn_mask=mask, enable_gqa=True)
                for k, v in kvt],
               live * KD * kb * 2 + 2 * B * NH * HD * q.element_size() + B * 4,
               4 * live * NH * HD, dtype=name(qd, kd),
               splits=da.plan_splits(B, NKV, T, _sm_count()))
        with_rate(rows[-1], live * KD * kb * 2)
        if NH != 32 or qd != f32:
            del caches, kvt
            continue
        # The fused entry on the same caches: an f32 qkv row over bf16 caches.
        NQ = NH * HD
        old = lens - 1
        cos, sin = Llama(cfg)._rope(old[:, None].long())
        c2, s2 = cos.reshape(B, HD // 2), sin.reshape(B, HD // 2)
        cos_t = torch.cat([c2, c2], -1).repeat(1, NKV)
        sin_t = torch.cat([-s2, s2], -1).repeat(1, NKV)
        qkv = rand(B, NQ + 2 * KD, dtype=f32)
        kg, vg, kp, vp = k0.clone(), v0.clone(), k0.clone(), v0.clone()
        att, k_new, _, _ = da.fused_decode_attention(qkv, None, cos_t, sin_t, kg, vg, old,
                                                     num_heads=NH)
        watt, wk_new, _, _ = da.fused_decode_attention_plain(qkv, cos_t, sin_t, kp, vp, old,
                                                             num_heads=NH)
        errs = [max_err(att, watt), max_err(k_new, wk_new), max_err(kg, kp), max_err(vg, vp)]
        worst = max(errs, key=lambda e: e[0] / e[1])
        live_old = live - B
        record("fused_decode_attention", f"B={B} old 128-191 T={T} {name(f32, bf16)}", *worst,
               [lambda k=k, v=v: da.fused_decode_attention(qkv, None, cos_t, sin_t, k, v, old,
                                                           num_heads=NH) for k, v in caches],
               lambda: da.fused_decode_attention_plain(qkv, cos_t, sin_t, kp, vp, old,
                                                       num_heads=NH), None,
               live_old * KD * 2 * 2 + B * (NQ + 2 * KD) * 4 + 2 * B * KD * 4 + B * NQ * 4
               + B * KD * 4 + 2 * B * KD * 2, 4 * live * NH * HD, dtype=name(f32, bf16),
               errors={"att": errs[0][0], "k_new": errs[1][0], "k_cache": errs[2][0],
                       "v_cache": errs[3][0]}, splits=da.plan_splits(B, NKV, T, _sm_count()))
        with_rate(rows[-1], live_old * KD * 2 * 2)
        del caches, kvt, kg, vg, kp, vp
    torch.cuda.synchronize()
    return rows


def phase_crossover(cfg, rng):
    """One layer's prefill attention (B 1, Llama-3.2-1B's heads, causal,
    bf16) at T 512-4096: the flash kernel against the plain product that
    ``attention_impl="auto"`` runs below FLASH_MIN_SEQ, each timed eagerly
    as the prefill calls it (CUDA events around the call, median of 5)."""
    from mila_tpu_torch.kernels import flash_attention as fa
    from mila_tpu_torch.ops import FLASH_MIN_SEQ, dot_product_attention

    NH, NKV, HD = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    rows = []
    for T in (512, 1024, 2048, 4096):
        q, k, v = (torch.from_numpy(rng.standard_normal((1, T, n, HD)).astype(np.float32))
                   .to("cuda", torch.bfloat16) for n in (NH, NKV, NKV))
        flash_ms = time_eager(lambda: fa.flash_attention(q, k, v), reps=5)
        plain_ms = time_eager(lambda: dot_product_attention(q, k, v, causal=True), reps=5)
        rows.append({"T": T, "flash_ms": flash_ms, "plain_ms": plain_ms,
                     "plain_over_flash": plain_ms / flash_ms,
                     "auto_takes": "flash" if T >= FLASH_MIN_SEQ else "plain"})
        del q, k, v
    return {"batch": 1, "heads": NH, "kv_heads": NKV, "head_dim": HD,
            "flash_min_seq": FLASH_MIN_SEQ, "rows": rows, "ce_fwd": ce_fwd_crossover(rng)}


def ce_fwd_crossover(rng) -> dict:
    """K13's two forwards ("row", a block a row; "short", a warp a row or
    several rows a warp) at M 2048 and 128, V 10, 256 (CE_SHORT_MAX_V), 512
    and 4096, f32 and bf16 logits, every 7th row ignored, beside
    F.cross_entropy: each variant's losses within 1e-4 + 1e-5 |ref| of the
    plain version's, then each call's device time by the profiler (20 calls)
    and as a launch within 50 in one graph replay. Places ce_fwd_variant's
    crossover, CE_SHORT_MAX_V."""
    import torch.nn.functional as F

    from mila_tpu_torch.kernels import softmax_ce as ce

    rows = []
    for dt in (torch.float32, torch.bfloat16):
        for M in (2048, 128):
            for V in (10, 256, 512, 4096):
                x = torch.from_numpy(rng.standard_normal((M, V)).astype(np.float32) * 3).to(
                    "cuda", dt)
                t = torch.from_numpy(rng.integers(0, V, M)).cuda()
                t[::7] = -100
                t32 = t.to(torch.int32)
                want = ce.fused_softmax_cross_entropy_plain(x, t32)
                row = {"dtype": str(dt).replace("torch.", ""), "M": M, "V": V,
                       "chosen": ce.ce_fwd_variant(V, x.element_size())}
                fns = {v: (lambda v=v: ce._fwd(x, t32, -100, v)) for v in ("row", "short")}
                fns["library"] = lambda: F.cross_entropy(x, t, reduction="none")
                for name, fn in fns.items():
                    if name != "library":
                        got = fn()
                        excess = ((got - want).abs() - 1e-5 * want.abs()).max().item()
                        if not torch.isfinite(got).all() or excess > 1e-4:
                            raise AssertionError(f"K13 {name} forward at {dt} M {M} V {V}: a "
                                                 f"loss is {excess} beyond 1e-5 |ref| + 1e-4")
                    row[name] = {"device_ms": device_ms(fn), "graph_ms": time_graph([fn] * 50)}
                rows.append(row)
    return {"short_max_v": ce.CE_SHORT_MAX_V, "rows": rows}


# ---------------------------------------------------------------------------
# parity
# ---------------------------------------------------------------------------

def parity_compare(steps: list, what: str, g: torch.Tensor, c: torch.Tensor, B: int) -> None:
    """The parity gate on one output: max |d| <= ERR_TOL x max |ref| or the
    per-row cosine >= 0.999; records the numbers (and greedy agreement)."""
    g, c = g.float().cpu().reshape(B, -1), c.float().reshape(B, -1)
    if not torch.isfinite(g).all():
        raise AssertionError(f"parity {what}: non-finite values on the card")
    err, ref = (g - c).abs().max().item(), c.abs().max().item()
    cos = torch.nn.functional.cosine_similarity(g, c, dim=-1).min().item()
    steps.append({"what": what, "max_abs_err": err, "max_abs_ref": ref, "min_cosine": cos,
                  "greedy_agree": float((g.argmax(-1) == c.argmax(-1)).float().mean())})
    if err > ERR_TOL * ref and cos < 0.999:
        raise AssertionError(f"parity {what}: max |d| {err} > {ERR_TOL} x {ref} and "
                             f"cosine {cos} < 0.999")


def phase_parity(rng, dtype: str = "int8", seed: int = 1, full: bool = True):
    """Card against CPU at 2 layers in weight format ``dtype``: the paged
    protocol and the contiguous steps on pack_decode_layers and
    pack_decode_megalayers params; with ``full`` also the unpacked params,
    the giga step and the MLP packs."""
    from mila_tpu_torch.models.llama import (Llama, LlamaConfig, pack_decode_giga,
                                             pack_decode_layers, pack_decode_megalayers,
                                             pack_decode_mlp)

    cfg = LlamaConfig.llama32_1b().replace(num_layers=2, max_seq_len=512)
    params = build_params(cfg, seed=seed, device="cuda", dtype=dtype)
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
        parity_compare(steps, what, g, c, B)
        return g.float().cpu().reshape(B, -1).argmax(-1).to(torch.int32)

    nxt = compare("paged prefill", glog, clog)
    pos = lens.copy()
    for step in range(8):
        tok = nxt[:, None]
        glog, gpools = gpu.forward_paged_ragged(params, tok.cuda(), gpools, gt,
                                                torch.from_numpy(pos).cuda())
        clog, cpools = cpu.forward_paged_ragged(cpu_params, tok, cpools, ct,
                                                torch.from_numpy(pos))
        nxt = compare(f"paged decode {step}", glog, clog)
        pos = pos + 1
    del gpools, cpools

    # Contiguous: prefill with forward_with_cache, then greedy steps fed the
    # CPU's tokens; each step's gate is the new K row of the last layer (it
    # depends on every layer before), and a last forward_with_cache step
    # compares logits. "mega": the per-layer megakernel path.
    packed = pack_decode_layers(params)
    mega = pack_decode_megalayers(params, cfg)
    if "layer_stream" not in packed or "mega_pack" not in mega["h0"]:
        raise AssertionError("parity: the 2-layer model did not pack")
    T0, V = 16, cfg.vocab_size
    prompt = torch.from_numpy(rng.integers(0, V, (B, T0)).astype(np.int32))
    agree = {}
    variants = [("packed", packed, to_cpu(packed)), ("mega", mega, to_cpu(mega))]
    if full:
        variants.append(("unpacked", params, cpu_params))
    for variant, gp, cp in variants:
        gc = gpu.init_kv_cache(B, 64, torch.bfloat16)
        cc = cpu.init_kv_cache(B, 64, torch.bfloat16)
        glog, gc = gpu.forward_with_cache(gp, prompt.cuda(), gc, 0)
        clog, cc = cpu.forward_with_cache(cp, prompt, cc, 0)
        tok = compare(f"contiguous {variant} prefill", glog[:, -1], clog[:, -1])[:, None]
        last = f"h{cfg.num_layers - 1}"
        hits = []
        for step in range(8):
            pos = T0 + step
            gtok, gc = gpu.greedy_step_with_cache(gp, tok.cuda(), gc, pos)
            ctok, cc = cpu.greedy_step_with_cache(cp, tok, cc, pos)
            hits.append(float((gtok.cpu() == ctok).float().mean()))
            parity_compare(steps, f"contiguous {variant} step {step} k row",
                           gc[last]["k"][:, pos], cc[last]["k"][:, pos], B)
            tok = ctok
        glog, _ = gpu.forward_with_cache(gp, tok.cuda(), gc, T0 + 8)
        clog, _ = cpu.forward_with_cache(cp, tok, cc, T0 + 8)
        compare(f"contiguous {variant} logits after 8 steps", glog, clog)
        agree[variant] = float(np.mean(hits))
    del packed, mega
    if not full:
        return parity_summary(cfg, steps, agree)

    # Giga: the same prefill, stack_kv_cache, then 8 giga_step steps fed the
    # CPU's tokens (the kernel keeps the residual in f32 where the plain
    # version rounds it to bf16 per layer: the parity gate still holds at 2
    # layers); each step's logits are compared.
    giga = pack_decode_giga(params, cfg)
    if "giga_pack" not in giga:
        raise AssertionError("parity: pack_decode_giga did not pack the 2-layer model")
    cpu_giga = to_cpu(giga)
    gc, cc = gpu.init_kv_cache(B, 64, torch.bfloat16), cpu.init_kv_cache(B, 64, torch.bfloat16)
    glog, gc = gpu.forward_with_cache(giga, prompt.cuda(), gc, 0)
    clog, cc = cpu.forward_with_cache(cpu_giga, prompt, cc, 0)
    tok = compare("giga prefill", glog[:, -1], clog[:, -1])[:, None]
    (gkp, gvp), (ckp, cvp) = gpu.stack_kv_cache(gc), cpu.stack_kv_cache(cc)
    del gc, cc
    hits = []
    for step in range(8):
        lens = torch.full((B,), T0 + step, dtype=torch.int32)
        gtok, glg, gkp, gvp = gpu.giga_step(giga, tok.cuda(), gkp, gvp, lens.cuda())
        ctok, clg, ckp, cvp = cpu.giga_step(cpu_giga, tok, ckp, cvp, lens)
        parity_compare(steps, f"giga step {step} logits", glg, clg, B)
        hits.append(float((gtok.cpu() == ctok).float().mean()))
        tok = ctok
    parity_compare(steps, "giga K pool rows after 8 steps", gkp[:, :, :T0 + 8], ckp[:, :, :T0 + 8],
                   B * cfg.num_layers)
    agree["giga"] = float(np.mean(hits))
    del giga, cpu_giga, gkp, gvp

    # MLP-block packs: prefill, then 4 forward_with_cache_ragged steps at
    # ragged positions (T0 - b % 4), logits compared.
    mlp = pack_decode_mlp(params)
    if "mlp_pack" not in mlp["h0"]:
        raise AssertionError("parity: pack_decode_mlp did not pack the 2-layer model")
    cpu_mlp = to_cpu(mlp)
    gc, cc = gpu.init_kv_cache(B, 64, torch.bfloat16), cpu.init_kv_cache(B, 64, torch.bfloat16)
    glog, gc = gpu.forward_with_cache(mlp, prompt.cuda(), gc, 0)
    clog, cc = cpu.forward_with_cache(cpu_mlp, prompt, cc, 0)
    tok = compare("mlp prefill", glog[:, -1], clog[:, -1])[:, None]
    pos = T0 - torch.arange(B, dtype=torch.int32) % 4
    for step in range(4):
        glog, gc = gpu.forward_with_cache_ragged(mlp, tok.cuda(), gc, pos.cuda())
        clog, cc = cpu.forward_with_cache_ragged(cpu_mlp, tok, cc, pos)
        tok = compare(f"mlp ragged step {step}", glog, clog)[:, None]
        pos = pos + 1
    del params, cpu_params, mlp, cpu_mlp
    return parity_summary(cfg, steps, agree)


def parity_summary(cfg, steps: list, agree: dict) -> dict:
    return {"layers": cfg.num_layers, "tolerance": f"max|d| <= {ERR_TOL} x max|ref| "
            "or min cosine >= 0.999", "steps": steps,
            "greedy_agree_mean": float(np.mean([s["greedy_agree"] for s in steps
                                                if "row" not in s["what"]])),
            "greedy_step_token_agreement": agree}


def phase_parity_long(rng):
    """Llama-3.2-1B widths at 1 layer, int4 weights and int8 pages, on the
    card against the same weights through the plain path on the CPU: a
    paged prefill of 2 prompts in a 2048-token bucket (the card attends
    through the flash kernel, the CPU through the plain product), then 8
    decode steps fed the CPU's tokens; the parity gate on every step."""
    from mila_tpu_torch.kernels import flash_attention as fa
    from mila_tpu_torch.models.llama import Llama, LlamaConfig

    cfg = LlamaConfig.llama32_1b().replace(num_layers=1, max_seq_len=4224)
    params = build_params(cfg, seed=3, device="cuda", dtype="int4")
    cpu_params = to_cpu(params)
    gpu, cpu = Llama(cfg), Llama(cfg, device="cpu")
    B, bucket, ps = 2, 2048, 128
    W = -(-(bucket + 8) // ps)
    lens = np.array([bucket, 1531], np.int32)
    tokens = np.zeros((B, bucket), np.int32)
    for i, n in enumerate(lens):
        tokens[i, :n] = rng.integers(0, cfg.vocab_size, n)
    table = (1 + np.arange(B * W)).reshape(B, W).astype(np.int32)
    gpools = gpu.init_paged_cache(B * W + 1, ps, torch.int8)
    cpools = cpu.init_paged_cache(B * W + 1, ps, torch.int8)
    gt, ct = torch.from_numpy(table).cuda(), torch.from_numpy(table)
    flash0 = fa.flash_attention.launches
    glog, gpools = gpu.forward_paged_prefill(params, torch.from_numpy(tokens).cuda(), gpools, gt,
                                             torch.from_numpy(lens).cuda())
    torch.cuda.synchronize()
    if fa.flash_attention.launches - flash0 != cfg.num_layers:
        raise AssertionError("parity long: the 2048-token prefill did not run the flash kernel")
    clog, cpools = cpu.forward_paged_prefill(cpu_params, torch.from_numpy(tokens), cpools, ct,
                                             torch.from_numpy(lens))
    steps, hits = [], []

    def compare(what, g, c):
        parity_compare(steps, what, g, c, B)
        return c.float().reshape(B, -1).argmax(-1).to(torch.int32)

    nxt = compare("int4 paged prefill (flash)", glog, clog)
    pos = lens.copy()
    for step in range(8):
        tok = nxt[:, None]
        glog, gpools = gpu.forward_paged_ragged(params, tok.cuda(), gpools, gt,
                                                torch.from_numpy(pos).cuda())
        clog, cpools = cpu.forward_paged_ragged(cpu_params, tok, cpools, ct,
                                                torch.from_numpy(pos))
        nxt = compare(f"int4 int8-page decode {step}", glog, clog)
        hits.append(float((glog.float().cpu().reshape(B, -1).argmax(-1) == nxt).float().mean()))
        pos = pos + 1
    del params, cpu_params, gpools, cpools
    return {"layers": cfg.num_layers, "weights": "int4", "cache": "int8 pages",
            "prompt_lens": lens.tolist(), "bucket": bucket,
            "tolerance": f"max|d| <= {ERR_TOL} x max|ref| or min cosine >= 0.999",
            "steps": steps, "greedy_token_agreement": float(np.mean(hits))}


# ---------------------------------------------------------------------------
# decode and generate (the contiguous cache)
# ---------------------------------------------------------------------------

def phase_decode(model, packed, cfg, rng, bw, path: str = "decode"):
    """The JAX bench's decode shape on the packed params: prefill, then 64
    greedy_step_with_cache steps; launch counts per path (named ``path``)."""
    from mila_tpu_torch.models.llama import decode_step_bytes

    B, P, C, STEPS, L = 8, 128, 512, 64, cfg.num_layers
    V = cfg.vocab_size
    prompt = torch.from_numpy(rng.integers(0, V, (B, P)).astype(np.int32)).cuda()
    cache = model.init_kv_cache(B, C, torch.bfloat16)
    t0 = time.monotonic()
    (logits, cache), pre_counts = run_counted(
        f"{path} prefill", lambda: model.forward_with_cache(packed, prompt, cache, 0),
        {"quant_linear": 4 * L + 1})
    prefill_s = time.monotonic() - t0
    tok = torch.argmax(logits[:, -1, :V].float(), dim=-1).to(torch.int32)[:, None]
    del logits
    state = {"tok": tok, "cache": cache}
    out = []

    def loop():
        for s in range(STEPS):
            state["tok"], state["cache"] = model.greedy_step_with_cache(
                packed, state["tok"], state["cache"], P + s)
            out.append(state["tok"])

    t0 = time.monotonic()
    _, counts = run_counted(path, loop, {
        "rms_quant_linear": STEPS, "fused_decode_attention": STEPS * L,
        "layer_tail_stream": STEPS * L, "rms_quant_linear_argmax": STEPS})
    wall = time.monotonic() - t0
    toks = torch.cat(out, dim=1)
    if toks.shape != (B, STEPS) or int(toks.min()) < 0 or int(toks.max()) >= V:
        raise AssertionError(f"{path}: tokens outside the vocabulary")

    def step():
        return model.greedy_step_with_cache(packed, state["tok"], state["cache"], P + STEPS)

    graph_ms = time_graph([step])
    nbytes = decode_step_bytes(packed, cfg, B, C)
    bound_ms = (nbytes["weight_bytes"] + nbytes["kv_read_bytes"]) / bw * 1e3
    eager_ms = 1e3 * wall / STEPS
    return {"batch": B, "prompt": P, "cache": C, "steps": STEPS, "prefill_s": prefill_s,
            "ms_per_step_eager": eager_ms, "tok_s_eager": B / eager_ms * 1e3,
            "ms_per_step_events": time_eager(step, reps=5),
            "ms_per_step_graph": graph_ms,
            "tok_s_graph": B / graph_ms * 1e3, "bound_ms": bound_ms, **nbytes,
            "launches_prefill": pre_counts, "launches": counts,
            "launches_per_step": {k: v / STEPS for k, v in counts.items() if v}}


def phase_giga(model, giga, cfg, rng, bw, path: str = "giga", prefill=None):
    """The JAX bench's decode shape on the giga params: prefill,
    stack_kv_cache, then 64 giga_step steps, exactly one kernel launch each.
    ``prefill``: the prefill's launch counts (default: the int8 model's)."""
    from mila_tpu_torch.models.llama import decode_step_bytes

    B, P, C, STEPS, L = 8, 128, 512, 64, cfg.num_layers
    V = cfg.vocab_size
    prompt = torch.from_numpy(rng.integers(0, V, (B, P)).astype(np.int32)).cuda()
    cache = model.init_kv_cache(B, C, torch.bfloat16)
    t0 = time.monotonic()
    (logits, cache), pre_counts = run_counted(
        f"{path} prefill", lambda: model.forward_with_cache(giga, prompt, cache, 0),
        {"quant_linear": 4 * L + 1} if prefill is None else prefill)
    prefill_s = time.monotonic() - t0
    tok = torch.argmax(logits[:, -1, :V].float(), dim=-1).to(torch.int32)[:, None]
    del logits
    kp, vp = model.stack_kv_cache(cache)
    del cache
    lens = (P + torch.arange(STEPS + 1, dtype=torch.int32, device="cuda"))[:, None].repeat(1, B)
    state = {"tok": tok, "kp": kp, "vp": vp}
    out = []

    def loop():
        for s in range(STEPS):
            state["tok"], _, state["kp"], state["vp"] = model.giga_step(
                giga, state["tok"], state["kp"], state["vp"], lens[s])
            out.append(state["tok"])

    t0 = time.monotonic()
    _, counts = run_counted(path, loop, {"giga_decode_step": STEPS})
    wall = time.monotonic() - t0
    toks = torch.cat(out, dim=1)
    if toks.shape != (B, STEPS) or int(toks.min()) < 0 or int(toks.max()) >= V:
        raise AssertionError(f"{path}: tokens outside the vocabulary")

    def step():
        return model.giga_step(giga, state["tok"], state["kp"], state["vp"], lens[STEPS])

    graph_ms = time_graph([step])
    nbytes = decode_step_bytes(giga, cfg, B, C)
    bound_ms = (nbytes["weight_bytes"] + nbytes["kv_read_bytes"]) / bw * 1e3
    eager_ms = 1e3 * wall / STEPS
    return {"batch": B, "prompt": P, "cache": C, "steps": STEPS, "prefill_s": prefill_s,
            "ms_per_step_eager": eager_ms, "tok_s_eager": B / eager_ms * 1e3,
            "ms_per_step_events": time_eager(step, reps=5), "ms_per_step_graph": graph_ms,
            "tok_s_graph": B / graph_ms * 1e3, "bound_ms": bound_ms, **nbytes,
            "launches_prefill": pre_counts, "launches": counts,
            "launches_per_step": {k: v / STEPS for k, v in counts.items() if v}}


def phase_giga_bf16(cfg, bw, peak_ops):
    """Llama-3.2-1B unquantized (bf16, random weights from seed 5) through
    pack_decode_giga(bf16_stream=True): unit-scale bf16 tiles, the padded
    tied wte^T as the head. The kernel at L 16 against its plain version
    with the giga gate (giga_row), then phase_giga's decode (its prefill
    runs no kernel of the table: bf16 projections are plain matmuls)."""
    from mila_tpu_torch.models.llama import (Llama, fuse_llama_projections, init_llama_params,
                                             pack_decode_giga)

    gen = torch.Generator(device="cuda").manual_seed(5)
    params = fuse_llama_projections(init_llama_params(cfg, gen, device="cuda",
                                                      dtype=torch.bfloat16))
    giga = pack_decode_giga(params, cfg, bf16_stream=True)
    if "giga_pack" not in giga or giga["giga_pack"].w.dtype != torch.bfloat16:
        raise AssertionError("giga bf16: pack_decode_giga did not pack a bf16 stream")
    own = np.random.default_rng(26)
    gp, L, B, T, KD = giga["giga_pack"], cfg.num_layers, 8, 512, cfg.num_kv_heads * cfg.hd
    rows = []

    def draw(*shape):
        return torch.from_numpy(own.standard_normal(shape).astype(np.float32)).to("cuda",
                                                                                 torch.bfloat16)

    old = torch.from_numpy(own.integers(128, 192, B).astype(np.int32)).cuda()
    tokens = torch.from_numpy(own.integers(0, cfg.vocab_size, B).astype(np.int32)).cuda()
    giga_row(recorder(rows, bw, peak_ops), gp, params["embed"]["wte"], tokens, old,
             draw(L, B, T, KD), draw(L, B, T, KD), cfg, "bf16")
    run = phase_giga(Llama(cfg), giga, cfg, own, bw, "giga bf16", prefill={})
    return rows, run


def phase_mega(model, mega, cfg, rng, bw, path: str = "mega"):
    """The decode shape on the per-layer megakernel params: prefill, then 16
    greedy_step_with_cache steps (h0 wqkv, L megakernels, the argmax head);
    the graph step beside the step's byte bound."""
    from mila_tpu_torch.models.llama import decode_step_bytes

    B, P, C, STEPS, L = 8, 128, 512, 16, cfg.num_layers
    V = cfg.vocab_size
    prompt = torch.from_numpy(rng.integers(0, V, (B, P)).astype(np.int32)).cuda()
    cache = model.init_kv_cache(B, C, torch.bfloat16)
    (logits, cache), pre_counts = run_counted(
        f"{path} prefill", lambda: model.forward_with_cache(mega, prompt, cache, 0),
        {"quant_linear": 4 * L + 1})
    state = {"tok": torch.argmax(logits[:, -1, :V].float(), dim=-1).to(torch.int32)[:, None],
             "cache": cache}
    del logits

    def loop():
        for s in range(STEPS):
            state["tok"], state["cache"] = model.greedy_step_with_cache(
                mega, state["tok"], state["cache"], P + s)

    t0 = time.monotonic()
    _, counts = run_counted(path, loop, {
        "rms_quant_linear": STEPS, "layer_megakernel": STEPS * L,
        "rms_quant_linear_argmax": STEPS})
    wall = time.monotonic() - t0
    if int(state["tok"].min()) < 0 or int(state["tok"].max()) >= V:
        raise AssertionError(f"{path}: tokens outside the vocabulary")

    def step():
        return model.greedy_step_with_cache(mega, state["tok"], state["cache"], P + STEPS)

    nbytes = decode_step_bytes(mega, cfg, B, C)
    return {"batch": B, "prompt": P, "cache": C, "steps": STEPS,
            "ms_per_step_eager": 1e3 * wall / STEPS, "ms_per_step_graph": time_graph([step]),
            "bound_ms": (nbytes["weight_bytes"] + nbytes["kv_read_bytes"]) / bw * 1e3,
            **nbytes, "launches_prefill": pre_counts, "launches": counts,
            "launches_per_step": {k: v / STEPS for k, v in counts.items() if v}}


def phase_generate(model, params, cfg, rng, mlp: bool = False):
    """Generator.generate on the unpacked int8 params (the dense decode
    attention with the decode weight streams), or on pack_decode_mlp params
    (the MLP block of each decode layer through mlp_block_fused)."""
    from mila_tpu_torch.inference.generator import Generator

    B, T0, NEW, L = 8, 64, 16, cfg.num_layers
    V = cfg.vocab_size
    prompt = rng.integers(0, V, (B, T0)).astype(np.int32)
    gen = Generator(model, params, max_len=T0 + NEW)
    steps = NEW - 1
    tail = ({"mlp_block_fused": steps * L} if mlp else
            {"quant_linear_residual": steps * 2 * L, "rms_quant_linear_swiglu": steps * L})
    t0 = time.monotonic()
    out, counts = run_counted("generate mlp" if mlp else "generate",
                              lambda: gen.generate(prompt, NEW), {
        "quant_linear": 4 * L + 1, "rms_quant_linear": steps * (L + 1),
        "dense_decode_attention": steps * L, **tail})
    wall = time.monotonic() - t0
    out = out.cpu().numpy()
    if out.shape != (B, T0 + NEW) or not (out[:, :T0] == prompt).all() \
            or out.min() < 0 or out.max() >= V:
        raise AssertionError("generate: bad output shape or tokens")
    return {"batch": B, "prompt": T0, "new_tokens": NEW, "wall_s": wall,
            "tok_s": B * NEW / wall, "launches": counts}


# ---------------------------------------------------------------------------
# serve
# ---------------------------------------------------------------------------

def serve_streams(engine, prompts, new_tokens: int, path: str, expected):
    """Serve ``prompts`` greedily under run_counted; returns (requests,
    counts, seconds)."""
    def run():
        reqs = [engine.submit(p, max_new_tokens=new_tokens) for p in prompts]
        engine.run()
        return reqs

    t0 = time.monotonic()
    reqs, counts = run_counted(path, run, expected)
    wall = time.monotonic() - t0
    V = engine.model.config.vocab_size
    for r in reqs:
        if not (r.done and len(r.output) == new_tokens and all(0 <= t < V for t in r.output)):
            raise AssertionError(f"{path}: request {r.id} did not finish with {new_tokens} "
                                 "valid tokens")
    return reqs, counts, wall


def serve_numbers(engine, reqs, wall: float) -> dict:
    st = engine.stats
    ttft = sorted(r.ttft_s for r in reqs)
    tokens = sum(len(r.output) for r in reqs)
    out = {"requests": len(reqs), "new_tokens": tokens, "wall_s": wall, "tok_s": tokens / wall,
           "ttft_p50_ms": 1e3 * float(np.percentile(ttft, 50)),
           "ttft_p95_ms": 1e3 * float(np.percentile(ttft, 95)), "t_decode_s": st["t_decode_s"],
           "prefill_s": st["t_prefill_s"], "prefill_groups": st["prefill_groups"]}
    if st["decode_iters"]:
        out.update(decode_steps=st["decode_iters"],
                   decode_ms_per_step=1e3 * st["t_decode_s"] / st["decode_iters"])
    return out


def serve_engine(model, params, layout: str = "auto", k: int = 0, draft=None, dparams=None,
                 device=None):
    """serve's engine config (``benchmarks/engine_bench.py``'s: max_batch 8,
    max_len 512, buckets (32, 64, 128), bf16 KV), in ``layout``, with
    ``speculative_k`` k and its draft (0: off), on ``device`` (the GPU)."""
    from mila_tpu_torch.inference.engine import EngineConfig, InferenceEngine

    return InferenceEngine(model, params, EngineConfig(
        max_batch=8, max_len=512, prefill_buckets=(32, 64, 128), cache_dtype="bfloat16",
        page_size=128, kv_layout=layout, speculative_k=k, draft_model=draft,
        draft_params=dparams), device=device)


def paged_expected(engine, L: int) -> dict:
    """Launch counts of a paged int8 serving run, from its stats: each
    prefill group 4L quant_linear and the head's rms_quant_linear; each
    decode iteration the fused decode streams and L paged attention calls."""
    st = engine.stats
    it, groups = st["decode_iters"], st["prefill_groups"]
    return {"quant_linear": 4 * L * groups, "rms_quant_linear": (L + 1) * it + groups,
            "quant_linear_residual": 2 * L * it, "rms_quant_linear_swiglu": L * it,
            "paged_decode_attention": L * it}


def serve_once(model, params, cfg, prompts, layout: str, path: str = ""):
    """One serving run on a fresh engine; checks outputs and launch counts
    (path: the run's name, by default from its layout)."""
    engine = serve_engine(model, params, layout)
    L = cfg.num_layers

    giga = "giga_pack" in params

    def expected(_):
        st = engine.stats
        it, groups = st["decode_iters"], st["prefill_groups"]
        if giga:  # contiguous prefills as below; each decode step one kernel
            small = sum(len(p) <= 32 for p in prompts)
            return {"quant_linear": (4 * L + 1) * (len(prompts) - small),
                    "rms_quant_linear": (L + 1) * small, "quant_linear_residual": 2 * L * small,
                    "rms_quant_linear_swiglu": L * small, "giga_decode_step": it}
        if layout == "paged":
            return paged_expected(engine, L)
        # One prefill per request at its bucket: <= 32 rows take the decode
        # streams (head included), more rows quant_linear over every row.
        small = sum(len(p) <= 32 for p in prompts)
        big = len(prompts) - small
        return {"quant_linear": (4 * L + 1) * big,
                "rms_quant_linear": (L + 1) * small + 2 * it,
                "quant_linear_residual": 2 * L * small, "rms_quant_linear_swiglu": L * small,
                "fused_decode_attention": L * it, "layer_tail_stream": L * it}

    if giga and not engine._use_giga_decode():
        raise AssertionError("serve giga: the engine did not select the giga decode")
    reqs, counts, wall = serve_streams(engine, prompts, 32,
                                       path or f"serve {'giga' if giga else layout}", expected)
    it = engine.stats["decode_iters"]
    return counts, {
        "layout": "contiguous giga" if giga else layout, **serve_numbers(engine, reqs, wall),
        "launches_per_decode_step": {k: v / it for k, v in counts.items()
                                     if v and k != "quant_linear"},
    }


def decode_step_times(model, params, cfg, rng, cache_dtype=torch.bfloat16):
    """One 8-row paged decode step (forward_paged_ragged + argmax) at short
    context (positions 40-130 in a 4-page table row) timed eagerly and as a
    CUDA-graph replay: the difference is what the host adds."""
    B, ps, W = 8, 128, 4
    pools = model.init_paged_cache(B * W + 1, ps, cache_dtype)
    table = torch.from_numpy((1 + np.arange(B * W)).reshape(B, W).astype(np.int32)).cuda()
    pos = torch.from_numpy(rng.integers(40, 130, B).astype(np.int32)).cuda()
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)).cuda()

    def step():
        logits, _ = model.forward_paged_ragged(params, tok, pools, table, pos)
        return torch.argmax(logits[:, -1], dim=-1)

    eager = time_eager(step, reps=5)
    return {"decode_step_eager_ms": eager, "decode_step_graph_ms": time_graph([step])}


def long_step_split(model, params, cfg, lengths):
    """One 8-row int4 decode step over int8 pages at serve long's lengths
    (each prompt plus 16 decoded tokens, a 33-page table row as max_len 4224
    gives), timed eagerly and as a CUDA-graph replay, split on CUDA events:
    the step's L paged attention calls alone (graph replay at the step's
    shapes, lengths and table) and everything else, with their shares."""
    from mila_tpu_torch.inference.kv_cache import paged_attention_read

    B, ps, W, L = len(lengths), 128, 33, cfg.num_layers
    rng, tgen = np.random.default_rng(7), torch.Generator(device="cuda").manual_seed(7)
    pools = model.init_paged_cache(B * W + 1, ps, torch.int8)
    for name in ("k", "v"):
        pools[name].copy_(torch.randint(-127, 128, pools[name].shape, device="cuda",
                                        dtype=torch.int8, generator=tgen))
        pools[name + "_scale"].uniform_(0.002, 0.02, generator=tgen)
    table = torch.from_numpy((1 + np.arange(B * W)).reshape(B, W).astype(np.int32)).cuda()
    pos = torch.tensor([n + 16 for n in lengths], dtype=torch.int32, device="cuda")
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)).cuda()
    q = torch.from_numpy(rng.standard_normal((B, 1, cfg.num_heads, cfg.hd)).astype(
        np.float32)).to("cuda", torch.bfloat16)
    lens = pos + 1

    def step():
        logits, _ = model.forward_paged_ragged(params, tok, pools, table, pos)
        return torch.argmax(logits[:, -1], dim=-1)

    eager = time_eager(step, reps=5)
    graph = time_graph([step])
    attn = time_graph([lambda i=i: paged_attention_read(pools, i, q, table, lens)
                       for i in range(L)]) * L
    del pools
    return {"lens": [int(n) for n in lens.tolist()], "step_eager_ms": eager,
            "step_graph_ms": graph, "paged_attention_ms": attn, "rest_ms": graph - attn,
            "paged_attention_share": attn / graph}


def serve_prompts(cfg, rng) -> list:
    """serve's 16 requests: prompts of 8-100 tokens."""
    return [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
            for n in rng.integers(8, 101, 16)]


def phase_serve(model, params, packed, giga, cfg, rng, prompts, repeats: int = 3):
    """``repeats`` identical paged serving runs (the host clock varies
    between runs more than the device does; medians plus every run), then
    one contiguous-layout run of the same requests on the packed params and
    one on the giga params."""
    runs = []
    for _ in range(repeats):
        counts, run = serve_once(model, params, cfg, prompts, "paged")
        runs.append(run)
    med = {k: float(np.median([r[k] for r in runs]))
           for k in ("tok_s", "ttft_p50_ms", "ttft_p95_ms", "decode_ms_per_step", "wall_s")}
    c_counts, contiguous = serve_once(model, packed, cfg, prompts, "contiguous")
    g_counts, giga_run = serve_once(model, giga, cfg, prompts, "contiguous")
    return counts, c_counts, g_counts, {
        "requests": len(prompts), **med, "launches": counts,
        "launches_per_decode_step": runs[-1]["launches_per_decode_step"],
        **decode_step_times(model, params, cfg, rng),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "runs": runs,
        "contiguous": {**contiguous, "launches": c_counts},
        "giga": {**giga_run, "launches": g_counts}}


def phase_serve_fp8(model, params8, cfg, prompts, int8_counts):
    """One paged serving run of serve's requests on the fp8 model: its
    launch counts must equal the int8 paged run's (the same entry points,
    now through the fp8 branches), and the paged decode step eager and as a
    graph (inputs from their own random stream)."""
    counts, run = serve_once(model, params8, cfg, prompts, "paged", "serve fp8")
    if counts != int8_counts:
        raise AssertionError(f"serve fp8: launch counts {counts} != the int8 paged run's "
                             f"{int8_counts}")
    return counts, {"requests": len(prompts), **run, "launches": counts,
                    **decode_step_times(model, params8, cfg, np.random.default_rng(15))}


def phase_serve_long(model, params, cfg, rng):
    """The long-prompt low-bit path: the 16-layer Llama-3.2-1B with int4
    weights served by the paged engine over int8 pages, max_batch 8,
    max_len 4224, buckets 64-4096, greedy; 4 prompts of 2048-4000 tokens
    and 4 of 64-1000, 32 new tokens each. Launch counts: flash_attention L
    per prefill group of a bucket >= FLASH_MIN_SEQ, quant_linear_int4 4L + 1
    per decode iteration plus each group's head (and 4L per group of <= 32
    rows), quant_linear 4L per group of more rows (after unpack_int4),
    paged_decode_attention L per decode iteration, nothing else."""
    from mila_tpu_torch.inference.engine import EngineConfig, InferenceEngine
    from mila_tpu_torch.ops import FLASH_MIN_SEQ

    mb, L = 8, cfg.num_layers
    engine = InferenceEngine(model, params, EngineConfig(
        max_batch=mb, max_len=4224, prefill_buckets=(64, 128, 256, 512, 1024, 2048, 4096),
        cache_dtype="int8", page_size=128))
    lengths = (4000, 64, 2600, 300, 3300, 700, 2048, 1000)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in lengths]

    def expected(_):
        st = engine.stats
        it, by = st["decode_iters"], st["prefill_by_bucket"]
        groups = sum(e["groups"] for e in by.values())
        small = sum(e["groups"] for b, e in by.items() if mb * b <= 32)
        long_groups = sum(e["groups"] for b, e in by.items() if b >= FLASH_MIN_SEQ)
        return {"flash_attention": L * long_groups,
                "quant_linear_int4": (4 * L + 1) * it + groups + 4 * L * small,
                "quant_linear": 4 * L * (groups - small), "paged_decode_attention": L * it}

    def run():
        reqs = [engine.submit(p, max_new_tokens=32) for p in prompts]
        engine.run()
        return reqs

    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    reqs, counts = run_counted("serve long", run, expected)
    wall = time.monotonic() - t0
    for r in reqs:
        if not (r.done and len(r.output) == 32 and all(0 <= t < cfg.vocab_size
                                                       for t in r.output)):
            raise AssertionError(f"serve long: request {r.id} did not finish with 32 valid "
                                 "tokens")
    if min(counts["flash_attention"], counts["quant_linear_int4"],
           counts["paged_decode_attention"]) <= 0:
        raise AssertionError(f"serve long: a kernel of the path did not run: {counts}")
    st = engine.stats
    it = st["decode_iters"]
    tokens = sum(len(r.output) for r in reqs)

    def ttft(pick):
        t = [r.ttft_s for r in reqs if pick(len(r.prompt))]
        return {"p50_ms": 1e3 * float(np.percentile(t, 50)),
                "p95_ms": 1e3 * float(np.percentile(t, 95))}

    return counts, {
        "requests": len(reqs), "prompt_lens": list(lengths), "new_tokens": tokens,
        "wall_s": wall, "tok_s": tokens / wall,
        "ttft_long": ttft(lambda n: n >= 2048), "ttft_short": ttft(lambda n: n < 2048),
        "decode_ms_per_step": 1e3 * st["t_decode_s"] / it, "decode_steps": it,
        "prefill_s": st["t_prefill_s"],
        "prefill_by_bucket": {str(b): e for b, e in sorted(st["prefill_by_bucket"].items())},
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "launches": counts,
        "launches_per_decode_step": {k: v / it for k, v in counts.items()
                                     if v and k in ("quant_linear_int4", "paged_decode_attention")},
        "int4_int8_page_step": decode_step_times(model, params, cfg, rng, torch.int8),
        "long_step_split": long_step_split(model, params, cfg, lengths)}


# ---------------------------------------------------------------------------
# training: GPT-2 124M (kernel table rows 15's statistics launch, 16-18)
# ---------------------------------------------------------------------------

F32_OPS = 67e12  # H100 SXM f32 outside the tensor cores (NVIDIA data sheet)
TF32_OPS = 495e12  # H100 SXM TF32 tensor-core operations (NVIDIA data sheet)


# ---------------------------------------------------------------------------
# GPT-2 serving and speculative decoding
# ---------------------------------------------------------------------------

def llama_logits_f32(params, cfg, seq: np.ndarray) -> torch.Tensor:
    """The Llama target's logits [T, V] at every position of token sequence
    ``seq`` [T] in f32 arithmetic: the quantized weights dequantized to f32,
    every product and the attention in f32 (tf32 off). The greedy streams'
    near-ties are measured on these, which no serving path computes (each
    rounds to bf16 in its own order)."""
    from mila_tpu_torch import ops
    from mila_tpu_torch.inference.quantize import QTensor, dequantize

    def w(t):
        return dequantize(t, torch.float32) if isinstance(t, QTensor) else t.float()

    NH, NKV, HD = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    tokens = torch.from_numpy(np.asarray(seq, np.int64))[None].cuda()
    T = tokens.shape[1]
    x = params["embed"]["wte"][tokens].float()
    cos, sin = ops.rope_cos_sin(torch.arange(T, device="cuda")[None], HD, cfg.rope_theta,
                                cfg.rope_scaling)
    for i in range(cfg.num_layers):
        bp = params[f"h{i}"]
        h = ops.rms_norm(x, bp["ln_attn"]["gamma"], cfg.rms_eps)
        q, k, v = (h @ w(bp["wqkv"]["weight"])).split([NH * HD, NKV * HD, NKV * HD], dim=-1)
        q = ops.apply_rope(q.reshape(1, T, NH, HD), cos, sin)
        k = ops.apply_rope(k.reshape(1, T, NKV, HD), cos, sin)
        att = ops.dot_product_attention(q, k, v.reshape(1, T, NKV, HD), causal=True)
        x = x + att.reshape(1, T, NH * HD) @ w(bp["wo"]["weight"])
        g, u = (ops.rms_norm(x, bp["ln_mlp"]["gamma"], cfg.rms_eps)
                @ w(bp["wgu"]["weight"])).chunk(2, dim=-1)
        x = x + ops.swiglu(g, u) @ w(bp["down"]["weight"])
    h = ops.rms_norm(x[0], params["norm_f"]["gamma"], cfg.rms_eps)
    return (h @ w(params["lm_head_q"]))[:, :cfg.vocab_size]


def check_streams(path: str, prompts: list, got: list, want: list, oracle,
                  rejected: dict | None = None, tol: float = ERR_TOL) -> dict:
    """Greedy streams ``got`` against ``want`` (lists of token lists), on
    f32 logits: ``oracle(seq)`` gives the logits [T, V] at every position of
    token sequence ``seq``. Where request i's streams differ, one oracle
    forward over its prompt + ``got[i]`` holds, teacher-forced on that
    stream's own prefixes: at the first difference, both streams' tokens
    within ``tol`` x max |logit| of the largest logit (a near-tie, split by
    summation order), and after it, every token of ``got[i]``. ``rejected``
    ({request: [(position, draft token)]}, a speculative run's rejected
    drafts) holds each rejected draft to the same bound at its position:
    a draft == target run rejects only at near-ties. Anything else raises.
    Returns the first differences (printed in the phase line) and what the
    teacher-forced check read."""
    rejected = rejected or {}
    out = {"streams_equal": 0, "near_ties": [], "tokens_checked": 0, "not_argmax": 0,
           "rejected_checked": 0, "max_gap_over_tol": 0.0}

    def gap(lg, tok, where):
        top, bound = lg.max().item(), tol * lg.abs().max().item()
        g = top - lg[tok].item()
        out["max_gap_over_tol"] = max(out["max_gap_over_tol"], g / bound)
        if g > bound:
            raise AssertionError(f"{path}: {where}: token {tok} is {g} below the largest "
                                 f"logit, beyond the near-tie bound {bound}")
        return g

    for i, (g, w) in enumerate(zip(got, want)):
        if len(g) != len(w):
            raise AssertionError(f"{path}: request {i} emitted {len(g)} tokens, want {len(w)}")
        out["streams_equal"] += g == w
        rej = [(j, d) for j, d in rejected.get(i, []) if j < len(g)]
        if g == w and not rej:
            continue
        T0 = len(prompts[i])
        lg = oracle(np.concatenate([prompts[i], np.asarray(g, np.int32)])).float()
        at = lambda j: lg[T0 - 1 + j]  # noqa: E731 (the logits before token j)
        for j, d in rej:
            gap(at(j), d, f"request {i}: rejected draft at {j}")
        out["rejected_checked"] += len(rej)
        if g == w:
            continue
        j0 = next(j for j, (a, b) in enumerate(zip(g, w)) if a != b)
        out["near_ties"].append({
            "request": i, "position": j0, "tokens": [g[j0], w[j0]],
            "gaps": [gap(at(j0), g[j0], f"request {i} at {j0}"),
                     gap(at(j0), w[j0], f"request {i} at {j0}")],
            "tolerance": tol * at(j0).abs().max().item()})
        for j in range(j0 + 1, len(g)):
            out["not_argmax"] += gap(at(j), g[j], f"request {i} at {j} (teacher-forced)") > 0
        out["tokens_checked"] += len(g) - j0
    return out


def record_rejections(engine) -> dict:
    """Wrap ``engine._spec_verify`` to record, per request index in
    submission order, each round's rejected draft and its stream position
    ({request: [(position, token)]}); one more device-to-host copy a round."""
    rejected, verify, k = {}, engine._spec_verify, engine.spec_k

    def wrapped(*args):
        n, d, t_new = verify(*args)
        n_h, d_h = n.cpu().numpy(), d.cpu().numpy()
        for s, req in enumerate(engine._slots):
            if req is not None and n_h[s] < k:
                rejected.setdefault(req.id, []).append(
                    (len(req.output) + int(n_h[s]), int(d_h[s, n_h[s]])))
        return n, d, t_new

    engine._spec_verify = wrapped
    return rejected


def phase_serve_gpt2(rng):
    """GPT-2 124M as the JAX engine bench builds it (f32 params, bf16 pages,
    max_seq_len 512), random weights from a seed, written as an llm.c
    checkpoint and read back (the tree must come back equal), then serve's
    16 requests (8-100 prompt tokens, 32 new) on the paged engine: one
    paged_decode_attention per layer per decode iteration, an f32 q over
    bf16 pages, and nothing else."""
    import os
    import tempfile

    from mila_tpu_torch.models.gpt2 import GPT2, GPT2Config
    from mila_tpu_torch.serialization import read_gpt2_checkpoint, write_gpt2_checkpoint

    cfg = GPT2Config.gpt2_124m().replace(max_seq_len=512)
    params = GPT2(cfg).init(torch.Generator(device="cuda").manual_seed(40), (1, 32))
    t0 = time.monotonic()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "gpt2_124M.bin")
        write_gpt2_checkpoint(path, cfg, params)
        size = os.path.getsize(path)
        cfg2, params2 = read_gpt2_checkpoint(path)
    io_s = time.monotonic() - t0
    fields = ("vocab_size", "vp", "num_layers", "num_heads", "embedding_dim", "max_seq_len")
    if any(getattr(cfg2, f) != getattr(cfg, f) for f in fields):
        raise AssertionError(f"serve gpt2: the checkpoint's config {cfg2} != {cfg}")

    def same(a, b, where=""):
        if isinstance(a, dict):
            if set(a) != set(b):
                raise AssertionError(f"serve gpt2: keys differ at {where}")
            for k in a:
                same(a[k], b[k], f"{where}/{k}")
        elif not (b.is_cuda and b.dtype == torch.float32 and torch.equal(a, b)):
            raise AssertionError(f"serve gpt2: leaf {where} came back different")

    same(params, params2)
    del params
    model, L = GPT2(cfg2), cfg2.num_layers
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(8, 101, 16)]
    engine = serve_engine(model, params2)
    reqs, counts, wall = serve_streams(
        engine, prompts, 32, "serve gpt2",
        lambda _: {"paged_decode_attention": L * engine.stats["decode_iters"]})
    return counts, {"checkpoint_bytes": size, "checkpoint_io_s": io_s, "tree_equal": True,
                    **serve_numbers(engine, reqs, wall), "launches": counts,
                    "launches_per_decode_step": {"paged_decode_attention": L}}


def phase_parity_gpt2(rng):
    """The serve gpt2 engine at 2 layers (full width, f32 params, bf16
    pages) on the card and through the CPU port: the first logits of a
    prefill batch within ERR_TOL x max |ref|, and 8 requests' greedy
    streams (24 new tokens) equal, but for near-ties (``check_streams``:
    the kernel keeps the probabilities in f32 where the plain version
    rounds them to the pages' bf16)."""
    from mila_tpu_torch.models.gpt2 import GPT2, GPT2Config

    cfg = GPT2Config.gpt2_124m().replace(max_seq_len=512, num_layers=2)
    gpu, cpu = GPT2(cfg), GPT2(cfg, device="cpu")
    gp = gpu.init(torch.Generator(device="cuda").manual_seed(41), (1, 32))
    cp = to_cpu(gp)
    V = cfg.vocab_size
    prompts = [rng.integers(0, V, int(n)).astype(np.int32) for n in rng.integers(8, 101, 8)]
    # First logits: one prefill of the 8 prompts in a 128 bucket.
    tokens = np.zeros((8, 128), np.int32)
    for i, p in enumerate(prompts):
        tokens[i, :len(p)] = p
    lens = np.array([len(p) for p in prompts], np.int32)
    table = (1 + np.arange(32)).reshape(8, 4).astype(np.int32)
    glog, _ = gpu.forward_paged_prefill(gp, torch.from_numpy(tokens).cuda(),
                                        gpu.init_paged_cache(33, 128), torch.from_numpy(table)
                                        .cuda(), torch.from_numpy(lens).cuda())
    clog, _ = cpu.forward_paged_prefill(cp, torch.from_numpy(tokens), cpu.init_paged_cache(33, 128),
                                        torch.from_numpy(table), torch.from_numpy(lens))
    err, ref = max_err(glog[:, :V].cpu(), clog[:, :V])
    if err > ERR_TOL * ref:
        raise AssertionError(f"parity gpt2: first logits max |d| {err} > {ERR_TOL} x {ref}")
    L = cfg.num_layers
    geng = serve_engine(gpu, gp)
    greqs, counts, _ = serve_streams(
        geng, prompts, 24, "parity gpt2",
        lambda _: {"paged_decode_attention": L * geng.stats["decode_iters"]})
    ceng = serve_engine(cpu, cp, device="cpu")
    creqs = [ceng.submit(p, max_new_tokens=24) for p in prompts]
    ceng.run()
    got, want = [r.output for r in greqs], [r.output for r in creqs]
    # f32 params: the plain forward is f32 arithmetic.
    oracle = lambda seq: gpu.apply(gp, torch.from_numpy(seq)[None].cuda())[0, :, :V]  # noqa: E731
    return counts, {"layers": L, "first_logits_max_abs_err": err, "first_logits_max_ref": ref,
                    "requests": len(prompts), "new_tokens": 24,
                    **check_streams("parity gpt2", prompts, got, want, oracle),
                    "launches": counts}


def phase_generate_gpt2(rng):
    """Generator on GPT-2 124M in bf16 at the JAX bench's gpt2 row (B 8,
    prompt 128, cache 512; ``bench.py:161-175``): decode tok/s from the
    time of 65 tokens less that of 1 (the prefill). The contiguous GPT-2
    protocol attends through the plain ops, as JAX's does: no kernel runs
    (every launch count 0)."""
    from mila_tpu_torch.inference.generator import Generator
    from mila_tpu_torch.models.gpt2 import GPT2

    cfg = gpt2_config(dtype="bfloat16").replace(max_seq_len=512, attention_impl="auto")
    model = GPT2(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(42), (1, 32))
    B, T0, NEW = 8, 128, 64
    prompt = rng.integers(0, cfg.vocab_size, (B, T0)).astype(np.int32)
    gen = Generator(model, params, max_len=512)
    gen.generate(prompt, 2)  # warm
    torch.cuda.synchronize()
    t0 = time.monotonic()
    gen.generate(prompt, 1)
    torch.cuda.synchronize()
    t_prefill = time.monotonic() - t0
    t0 = time.monotonic()
    out, counts = run_counted("generate gpt2", lambda: gen.generate(prompt, NEW + 1), {})
    wall = time.monotonic() - t0
    out = out.cpu().numpy()
    if out.shape != (B, T0 + NEW + 1) or not (out[:, :T0] == prompt).all() \
            or out.min() < 0 or out.max() >= cfg.vocab_size:
        raise AssertionError("generate gpt2: bad output shape or tokens")
    decode = wall - t_prefill
    return counts, {"batch": B, "prompt": T0, "new_tokens": NEW, "prefill_s": t_prefill,
                    "decode_s": decode, "decode_tok_s": B * NEW / decode,
                    "decode_ms_per_step": 1e3 * decode / NEW, "launches": counts,
                    "note": "no kernel runs on this path (JAX's GPT-2 decode is plain too)"}


def spec_expected(engine, L: int, draft_layers: int, k: int, fused_verify: bool,
                  draft_quantized: bool):
    """Launch counts of a speculative serving run, from its stats: each
    prefill group 4L quant_linear and the head's rms_quant_linear (B rows),
    the draft's prefill over the group's rows (quantized: 4 quant_linear a
    layer and the head's, at more than 32 rows in every run here); each
    round k + 1 draft decode steps (the dense attention a layer; quantized:
    the fused decode streams) and one verify over B (k + 1) rows (the fused
    streams at <= 32 rows, else quant_linear) with a paged attention call a
    layer."""
    def expected(_):
        st = engine.stats
        groups, rounds, steps = st["prefill_groups"], st["spec_rounds"], (k + 1) * st["spec_rounds"]
        want = {"quant_linear": 4 * L * groups, "rms_quant_linear": groups,
                "paged_decode_attention": L * rounds,
                "dense_decode_attention": draft_layers * steps}
        if fused_verify:
            want["rms_quant_linear"] += (L + 1) * rounds
            want["quant_linear_residual"] = 2 * L * rounds
            want["rms_quant_linear_swiglu"] = L * rounds
        else:
            want["quant_linear"] += (4 * L + 1) * rounds
        if draft_quantized:
            want["quant_linear"] += (4 * draft_layers + 1) * groups
            want["rms_quant_linear"] += (draft_layers + 1) * steps
            want["quant_linear_residual"] = (want.get("quant_linear_residual", 0)
                                             + 2 * draft_layers * steps)
            want["rms_quant_linear_swiglu"] = (want.get("rms_quant_linear_swiglu", 0)
                                               + draft_layers * steps)
        return want

    return expected


def phase_serve_spec(model, params, cfg, prompts):
    """Llama-3.2-1B INT8 on the paged engine with speculative_k 4 and the
    JAX bench's draft (LlamaConfig.tiny at the target's vocabulary, bf16,
    random weights from a seed; ``benchmarks/engine_bench.py:88-92``): 12
    requests, 64 new tokens, max_batch 8, max_len 512 (``bench.py:779-782``).
    A random draft accepts almost nothing: the worst case. The greedy
    streams must equal the plain paged engine's on the same prompts but for
    near-ties (K1's and K2's summation orders differ from K2's and K1's at
    other row counts), and past a split every token must be a near-tie of
    the f32 oracle's argmax on the stream's own prefix (``check_streams``)."""
    from mila_tpu_torch.models.llama import Llama, LlamaConfig, init_llama_params

    dcfg = LlamaConfig.tiny(vocab_size=cfg.vocab_size).replace(max_seq_len=512,
                                                               param_dtype="bfloat16")
    draft = Llama(dcfg)
    dparams = init_llama_params(dcfg, torch.Generator(device="cuda").manual_seed(7))
    k, L, reqs12 = 4, cfg.num_layers, prompts[:12]
    plain = serve_engine(model, params)
    p_reqs, p_counts, p_wall = serve_streams(plain, reqs12, 64, "serve spec plain",
                                             lambda _: paged_expected(plain, L))
    engine = serve_engine(model, params, k=k, draft=draft, dparams=dparams)
    reqs, counts, wall = serve_streams(engine, reqs12, 64, "serve spec",
                                       spec_expected(engine, L, dcfg.num_layers, k, False,
                                                     False))
    got, want = [r.output for r in reqs], [r.output for r in p_reqs]
    streams = check_streams("serve spec", reqs12, got, want,
                            lambda seq: llama_logits_f32(params, cfg, seq))
    st = engine.stats
    return counts, {"k": k, "draft": "llama-tiny bf16 (random)", **serve_numbers(engine, reqs,
                                                                                  wall),
                    "acceptance_rate": st["spec_accepted"] / max(st["spec_proposed"], 1),
                    "rounds": st["spec_rounds"], "plain_tok_s": 12 * 64 / p_wall,
                    "plain_launches": p_counts, **streams, "launches": counts}


def phase_parity_spec(rng):
    """Llama-3.2-1B widths at 2 layers, INT8 weights, the draft equal to the
    target; every run's rejected drafts (``record_rejections``) and its
    streams past a split are held to the f32 oracle (``check_streams``).

    Over f32 activations (``param_dtype`` f32, as ``LlamaConfig.tiny`` and
    the JAX package's speculative-engine tests have it), on the card and
    through the CPU port: at k 3 the verify is 8 x 4 = 32 rows (K2's fused
    entries), at k 4 it is 40 (K1); the draft's K5 and the verify's K3 read
    bf16 caches under an f32 q. 4 requests, 8 new tokens each: the greedy
    acceptance rate at least 0.9 on the card at each k, and the card's
    streams at both k equal the CPU port's at k 3 but for near-ties (a
    greedy stream does not depend on k; the CPU's plain quantized products
    dequantize the whole weight a call, so it runs once).

    Over bf16 activations, the path serve spec and the served model take,
    at k 4 on the card: 8 requests, 24 new tokens, against the card's plain
    paged engine. The draft's and the verify's roundings split this random
    model's flat logits (acceptance 0.85 at k 4 on an H100), so the gate is
    that every rejected draft and the target's token there lie within the
    near-tie bound of the f32 oracle's largest logit."""
    from mila_tpu_torch.models.llama import Llama, LlamaConfig

    cfg = LlamaConfig.llama32_1b().replace(num_layers=2, max_seq_len=512,
                                           param_dtype="float32")
    params = build_params(cfg, seed=8, device="cuda")
    cpu_params = to_cpu(params)
    gpu, cpu = Llama(cfg), Llama(cfg, device="cpu")
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(8, 33, 8)]
    NEW = 8
    ceng = serve_engine(cpu, cpu_params, k=3, draft=cpu, dparams=cpu_params, device="cpu")
    creqs = [ceng.submit(p, max_new_tokens=NEW) for p in prompts[:4]]
    ceng.run()
    want = [r.output for r in creqs]

    def spec_run(model, prm, k, reqs, new, path, fused_verify):
        eng = serve_engine(model, prm, k=k, draft=model, dparams=prm)
        rejected = record_rejections(eng)
        greqs, counts, _ = serve_streams(eng, reqs, new, path,
                                         spec_expected(eng, 2, 2, k, fused_verify, True))
        st = eng.stats
        return [r.output for r in greqs], counts, rejected, {
            "verify_rows": 8 * (k + 1), "rounds": st["spec_rounds"],
            "acceptance_rate": st["spec_accepted"] / max(st["spec_proposed"], 1),
            "rejected": sum(len(v) for v in rejected.values())}

    oracle = lambda seq: llama_logits_f32(params, cfg, seq)  # noqa: E731
    out, all_counts = {}, {}
    for k in (3, 4):
        path = f"parity spec k{k}"
        got, counts, rejected, row = spec_run(gpu, params, k, prompts[:4], NEW, path, k == 3)
        out[f"k{k}"] = {**row, **check_streams(path, prompts[:4], got, want, oracle, rejected),
                        "launches": counts}
        all_counts[path] = counts
    low = {k: r["acceptance_rate"] for k, r in out.items() if r["acceptance_rate"] < 0.9}
    if low:
        raise AssertionError(f"parity spec: greedy acceptance under 0.9: {low} ({out})")
    del params, cpu_params
    bcfg = cfg.replace(param_dtype="bfloat16")
    bparams, bgpu, NEW16 = build_params(bcfg, seed=8, device="cuda"), Llama(bcfg), 24
    plain = serve_engine(bgpu, bparams)
    preqs, all_counts["parity spec bf16 plain"], _ = serve_streams(
        plain, prompts, NEW16, "parity spec bf16 plain", lambda _: paged_expected(plain, 2))
    path = "parity spec bf16 k4"
    got, all_counts[path], rejected, row = spec_run(bgpu, bparams, 4, prompts, NEW16, path,
                                                    False)
    out["bf16_k4"] = {**row, **check_streams(
        path, prompts, got, [r.output for r in preqs], lambda seq: llama_logits_f32(
            bparams, bcfg, seq), rejected), "launches": all_counts[path]}
    return all_counts, {"layers": cfg.num_layers, "f32_requests": 4, "f32_new_tokens": NEW,
                        "bf16_requests": len(prompts), "bf16_new_tokens": NEW16, **out}


def gpt2_config(layers=None, dtype: str = "bfloat16"):
    """GPT-2 124M at full width (L 12, C 768, NH 12, vocab 50257 -> 50304,
    T 1024, tied), ``dtype`` params (bf16 unless named), the flash kernels;
    ``layers`` cuts depth."""
    from mila_tpu_torch.models.gpt2 import GPT2Config

    cfg = GPT2Config.gpt2_124m().replace(param_dtype=dtype, attention_impl="flash")
    return cfg if layers is None else cfg.replace(num_layers=layers)


def train_optimizer():
    from mila_tpu_torch.optim import AdamW, AdamWConfig

    return AdamW(AdamWConfig(learning_rate=1e-3, weight_decay=0.1, stochastic_rounding=True,
                             grad_clip_norm=1.0))


# K10' (flash_fwd with l, m) and K11 (flash_bwd): GPT-2's training shape,
# Llama-3.2-1B's GQA heads at T 2048, and D 128 (24 heads over 8), all
# causal. Gate: each (b, t, head) row of o, dq, dk, dv within ERR_TOL of
# its own largest value (max_row_err; floored for the gradients); l and
# m within 1e-4 / 1e-3 of the plain version's. Library: SDPA forward;
# SDPA's backward alone; SDPA forward + backward through autograd beside
# ours (fwd_bwd_ms).
def flash_rows(record, rows, B, T, NH, NKV, D, draw, dtype=torch.bfloat16, plain_entry=False,
               device_only=False):
    """K10's statistics launch and K11 at one causal shape, inputs from
    ``draw``, each against its plain version (``record`` appends to
    ``rows``)."""
    import torch.nn.functional as F

    from mila_tpu_torch.kernels import flash_attention as fa
    from mila_tpu_torch.kernels import flash_attention_bwd as fb

    bf16, sdpa = torch.bfloat16, F.scaled_dot_product_attention
    sm = D ** -0.5
    fam_fwd, fam_bwd = fa.routes(dtype, D)
    tag = {bf16: "bf16", torch.float32: "f32", torch.float16: "fp16"}[dtype]
    shape = f"B={B} T={T} NH={NH} NKV={NKV} D={D}" + ("" if dtype == bf16 else f" {tag}")
    q, k, v, do = (draw(*sh, dtype=dtype) for sh in ((B, T, NH, D), (B, T, NKV, D),
                                                     (B, T, NKV, D), (B, T, NH, D)))
    es = q.element_size()
    # f32 runs on tf32 tensor-core operands: its rate is TF32's.
    peak = {torch.float32: TF32_OPS}.get(dtype)
    # l and m: f32 sums of exponentials in another order (1e-4 relative,
    # 1e-3 absolute), 1e-2 both where the scores come from tf32 products.
    lim = {"l": 1e-2, "m": 1e-2} if dtype == torch.float32 else {"l": 1e-4, "m": 1e-3}
    tol = ERR_TOL_F32 if dtype == torch.float32 else ERR_TOL
    o, l, m = fa.flash_attention_forward(q, k, v, causal=True, sm_scale=sm)
    o_ref, l_ref, m_ref = fa.flash_attention_plain(q, k, v, scale=sm, save_stats=True)
    o_err = max_row_err(o, o_ref)
    l_err = ((l - l_ref).abs() / l_ref).max().item()
    m_err = (m - m_ref).abs().max().item()
    if o_err > tol or l_err > lim["l"] or m_err > lim["m"]:
        raise AssertionError(f"flash_attention_forward[{shape}]: row err {o_err}, l rel "
                             f"{l_err}, m abs {m_err}")
    pairs = B * NH * T * (T + 1) // 2
    gqa = NKV != NH
    qs, ks, vs, dos = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))
    record("flash_attention_forward", shape, *max_err(o, o_ref),
           [lambda: fa.flash_attention_forward(q, k, v, causal=True, sm_scale=sm)],
           lambda: fa.flash_attention_plain(q, k, v, scale=sm, save_stats=True),
           [lambda: sdpa(qs, ks, vs, is_causal=True, enable_gqa=gqa)],
           es * (2 * q.numel() + 2 * k.numel()) + 2 * 4 * B * NH * T, 4 * D * pairs,
           gate=f"each (b, t, head) row of o within {tol} of its max |ref|; l rel "
                f"{lim['l']}, m abs {lim['m']}",
           max_row_rel_err=o_err, l_rel_err=l_err, m_abs_err=m_err, dtype=tag,
           family=fam_fwd, peak=peak, cuda_launches=graph_launches(
               lambda: fa.flash_attention_forward(q, k, v, causal=True, sm_scale=sm),
               fa.flash_attention_forward))
    rows[-1]["tflops"] = 4 * D * pairs / rows[-1]["ms"] / 1e9
    if plain_entry:
        # flash_attention (no statistics: evaluate's forward), the same
        # kernel without the l and m stores, held to the same gate.
        o2 = fa.flash_attention(q, k, v, causal=True)
        o2_err = max_row_err(o2, o_ref)
        if o2_err > tol:
            raise AssertionError(f"flash_attention[{shape}]: row err {o2_err}")
        record("flash_attention", shape, *max_err(o2, o_ref),
               [lambda: fa.flash_attention(q, k, v, causal=True)],
               lambda: fa.flash_attention_plain(q, k, v, scale=sm),
               [lambda: sdpa(qs, ks, vs, is_causal=True, enable_gqa=gqa)],
               es * (2 * q.numel() + 2 * k.numel()), 4 * D * pairs,
               gate=f"each (b, t, head) row within {tol} of its max |ref|",
               max_row_rel_err=o2_err, dtype=tag, family=fam_fwd, peak=peak,
               cuda_launches=graph_launches(lambda: fa.flash_attention(q, k, v, causal=True),
                                            fa.flash_attention))
        rows[-1]["tflops"] = 4 * D * pairs / rows[-1]["ms"] / 1e9
        del o2
    del o_ref, l_ref, m_ref
    hm = [t.transpose(1, 2) for t in (q, k, v, o, do)]
    got = fb.flash_attention_bwd(*hm[:4], l, m, hm[4], causal=True, sm_scale=sm)
    want = fb.flash_attention_bwd_plain(*hm[:4], l, m, hm[4], causal=True, sm_scale=sm)
    errs = {name: max_row_err(a.transpose(1, 2), b.transpose(1, 2), floor=1e-3)
            for name, a, b in zip(("dq", "dk", "dv"), got, want)}
    if max(errs.values()) > tol:
        raise AssertionError(f"flash_attention_bwd[{shape}]: row errors {errs}")
    abs_errs = [max_err(a, b) for a, b in zip(got, want)]
    del got, want
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    s_leaves = [t.detach().requires_grad_() for t in (qs, ks, vs)]

    def ours():
        out = fa.flash_attention(*leaves, causal=True)
        return torch.autograd.grad(out, leaves, do)

    def library():
        out = sdpa(*s_leaves, is_causal=True, enable_gqa=gqa)
        return torch.autograd.grad(out, s_leaves, dos)

    # SDPA's backward alone, the yardstick of the same function as
    # flash_attention_bwd (one saved forward, its graph kept between
    # calls), and ours timed the same ways: CUDA events around 20
    # back-to-back calls, the median of 5, and the profiler's kernel
    # times (autograd's host work does not always keep ahead of the
    # card); ours also as a graph replay.
    def ours_bwd():
        return fb.flash_attention_bwd(*hm[:4], l, m, hm[4], causal=True, sm_scale=sm)

    s_out = sdpa(*s_leaves, is_causal=True, enable_gqa=gqa)

    def library_bwd():
        return torch.autograd.grad(s_out, s_leaves, dos, retain_graph=True)

    library_bwd_device_ms = device_ms(library_bwd)
    # device_only (rows no model path launches): the profiler's device
    # times and the graph replay alone, SDPA's device time as the library's.
    timed = {} if device_only else {
        "library_bwd_ms": time_back_to_back(library_bwd),
        "bwd_back_to_back_ms": time_back_to_back(ours_bwd),
        "fwd_bwd_ms": time_eager(ours), "library_fwd_bwd_ms": time_eager(library)}
    del s_out
    record("flash_attention_bwd", shape, max(e for e, _ in abs_errs),
           max(r for _, r in abs_errs), [ours_bwd],
           lambda: fb.flash_attention_bwd_plain(*hm[:4], l, m, hm[4], causal=True,
                                                sm_scale=sm),
           None, es * (4 * q.numel() + 4 * k.numel()) + 2 * 4 * B * NH * T, 10 * D * pairs,
           gate=f"each (b, t, head) row of dq, dk, dv within {tol} of its max |ref| "
                "(floored at 1e-3 of the tensor's)",
           library_timed=library_bwd_device_ms if device_only else timed["library_bwd_ms"],
           library_what="SDPA is_causal backward alone (autograd.grad on one saved "
                        "forward), " + ("device time from the profiler" if device_only else
                                        "20 back-to-back calls between CUDA events"),
           row_rel_errs=errs, library_bwd_device_ms=library_bwd_device_ms,
           bwd_device_ms=device_ms(ours_bwd), dtype=tag, family=fam_bwd, peak=peak,
           cuda_launches=graph_launches(ours_bwd, fb.flash_attention_bwd), **timed)
    rows[-1]["tflops"] = 10 * D * pairs / rows[-1]["ms"] / 1e9


def lib_step(leaf, grad):
    lib_p = torch.nn.Parameter(leaf.clone())
    lib_p.grad = grad.to(leaf.dtype)
    return torch.optim.AdamW([lib_p], lr=1e-3, weight_decay=0.1, fused=True).step


def adamw_rows(record, cases) -> None:
    """K12 on each case (label, p, g, m, v, master, noise, bytes per element
    read and written once, the library's leaf and what it is): every output
    bit-equal to the plain version (the same f32 operations, no FMA
    contraction); library: ``torch.optim.AdamW(fused=True)`` on the leaf."""
    from mila_tpu_torch.kernels import fused_adamw as fw

    for label, p_, g_, m_, v_, w_, nz, per, lib_leaf, lib_what in cases:
        kw = dict(step=10, lr=1e-3, weight_decay=0.1, noise=nz, grad_scale=0.5)
        args = (p_, g_, m_, v_, w_)
        got = fw.fused_adamw_update(*args, **kw)
        want = fw.fused_adamw_update_plain(*args, **kw)
        for name, a, b in zip(("p", "m", "v", "master"), got, want):
            if b is not None and not torch.equal(a, b):
                raise AssertionError(f"fused_adamw_update[{label}]: {name} differs from the "
                                     f"plain version (max {max_err(a, b)[0]})")
        record("fused_adamw_update", label, 0.0, 1.0,
               [lambda a_=args, kw_=kw: fw.fused_adamw_update(*a_, **kw_)],
               lambda a_=args, kw_=kw: fw.fused_adamw_update_plain(*a_, **kw_),
               None, per * p_.numel(), 14 * p_.numel(), gate="bit-equal to the plain version",
               library_eager=lib_step(lib_leaf, g_), library_what=lib_what, peak=F32_OPS,
               dtype=str(p_.dtype).replace("torch.", ""),
               device_ms=device_ms(lambda a_=args, kw_=kw: fw.fused_adamw_update(*a_, **kw_)))
        del got, want


def lib_step_many(leaves, grads, wd: float = 0.1):
    """torch.optim.AdamW(fused=True) over clones of ``leaves`` with
    ``grads``: its step, for timing beside K12's."""
    ps = [torch.nn.Parameter(p.detach().clone()) for p in leaves]
    for p, g in zip(ps, grads):
        p.grad = torch.empty_like(p).copy_(g)  # the param's dtype and layout
    return torch.optim.AdamW(ps, lr=1e-3, weight_decay=wd, fused=True).step


def adamw_update_bytes(leaves, masters) -> int:
    """Bytes of one AdamW update over the leaves, each read or written once:
    g (the param's dtype), m, v and the master (or the param) read; the
    param, m, v and the master written."""
    total = 0
    for p, w in zip(leaves, masters):
        e = p.element_size()
        total += p.numel() * ((e + 8 + (4 if w is not None else e)) + (e + 8 + (4 if w is not
                                                                                   None else 0)))
    return total


def timed_once(fn):
    """(fn's result, its ms between CUDA events): one call."""
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


def adamw_step_rows(record, label: str, leaves, grads, ms, vs, masters, ids, clip: float,
                    graph_calls: int = 1, profile: bool = False) -> None:
    """K12 as AdamW.step calls it, at a step's own leaves: grad_clip_scale
    (where ``clip``) within 1e-6 relative of its plain version, then
    fused_adamw_step with that factor and JAX's key(0) bit-equal to its plain
    twin (one eager call each; the plain twin timed once), the eager call's
    launches counted (one per dtype group, ``launches_a_call``). Library:
    torch.nn.utils.get_total_norm, and torch.optim.AdamW(fused=True) over
    the same leaves (not the same function: no master, no SR, its moments in
    the params' dtype). ``graph_calls`` launches a graph replay;
    ``profile``: the profiler's device times too."""
    from mila_tpu_torch.kernels import fused_adamw as fw

    n = sum(p.numel() for p in leaves)
    shape = f"{label} {len(leaves)} leaves n={n}"
    scale = None
    if clip:
        (scale, norm), _ = timed_once(lambda: fw.grad_clip_scale(grads, clip))
        (_, want), plain_ms = timed_once(lambda: fw.grad_clip_scale_plain(grads, clip))
        rel = abs(norm.item() - want.item()) / want.item()
        if not rel <= 1e-6:
            raise AssertionError(f"grad_clip_scale[{shape}]: norm {norm.item()} is {rel} from "
                                 f"the plain version's {want.item()}")
        total = getattr(torch.nn.utils, "get_total_norm", None)
        record("grad_clip_scale", shape, abs(norm.item() - want.item()), want.item(),
               [lambda: fw.grad_clip_scale(grads, clip)] * graph_calls, None,
               None if total is None else [lambda: total(grads)] * graph_calls,
               sum(g.numel() * g.element_size() for g in grads), 2 * n,
               gate="the norm within 1e-6 relative of the plain version's",
               library_what="torch.nn.utils.get_total_norm (the norm alone)", peak=F32_OPS,
               plain_timed=plain_ms, norm_rel_err=rel, dtype="+".join(sorted(
                   {str(g.dtype).replace("torch.", "") for g in grads})),
               **({"device_ms": device_ms(lambda: fw.grad_clip_scale(grads, clip))}
                  if profile else {}))
    kw = dict(step=10, lr=1e-3, weight_decay=0.1, grad_scale=scale, key=None, leaf_ids=ids)
    before = fw.fused_adamw_step.launches
    got, _ = timed_once(lambda: fw.fused_adamw_step(leaves, grads, ms, vs, masters, **kw))
    launches = fw.fused_adamw_step.launches - before
    groups = len({(p.dtype, g.dtype) for p, g in zip(leaves, grads)})
    if launches != groups:
        raise AssertionError(f"fused_adamw_step[{shape}]: {launches} launches for {groups} "
                             f"dtype groups")
    want, plain_ms = timed_once(lambda: fw.fused_adamw_step_plain(leaves, grads, ms, vs,
                                                                  masters, **kw))
    for name, a_list, b_list in zip(("p", "m", "v", "master"), got, want):
        for a, b in zip(a_list, b_list):
            if b is not None and not torch.equal(a, b):
                raise AssertionError(f"fused_adamw_step[{shape}]: {name} differs from the "
                                     f"plain version (max {max_err(a, b)[0]})")
    del got, want
    torch.cuda.empty_cache()
    lib = lib_step_many(leaves, grads)
    how = {"library_timed": device_ms(lib)} if profile else {"library_eager": lib}
    record("fused_adamw_step", shape, 0.0, 1.0,
           [lambda: fw.fused_adamw_step(leaves, grads, ms, vs, masters, **kw)] * graph_calls,
           None, None, adamw_update_bytes(leaves, masters), 14 * n,
           gate="bit-equal to the plain version", **how,
           library_what="torch.optim.AdamW(fused=True) over the same leaves: not the same "
                        "function (no master, no SR; moments in the params' dtype), "
                        + ("device time from the profiler" if profile else "eager"),
           peak=F32_OPS, plain_timed=plain_ms, launches_a_call=launches,
           dtype="+".join(sorted({str(p.dtype).replace("torch.", "") for p in leaves})),
           **({"device_ms": device_ms(lambda: fw.fused_adamw_step(leaves, grads, ms, vs, masters,
                                                                   **kw))} if profile else {}))
    del lib
    torch.cuda.empty_cache()


def ce_rows(record, x, t, gl, tag: str, sub: float) -> None:
    """K13 forward and backward on logits x [M, V], targets t (int64, -100
    ignored) and the loss cotangent gl [M], each against its plain version:
    each loss within 1e-4 + 1e-5 |ref|, each dlogit within one bf16 step
    (2^-7) of its own size floored at 1e-8 of the largest, plus ``sub`` (one
    fp16 subnormal step over 2^-7, in fp16). Library ``F.cross_entropy``:
    its forward as a graph replay, its backward alone by device time."""
    import torch.nn.functional as F

    from mila_tpu_torch.kernels import softmax_ce as ce

    M, V = x.shape
    t32 = t.to(torch.int32)
    loss = ce.fused_softmax_cross_entropy(x, t)
    want = ce.fused_softmax_cross_entropy_plain(x, t32)
    excess = ((loss - want).abs() - 1e-5 * want.abs()).max().item()
    if not torch.isfinite(loss).all() or excess > 1e-4:
        raise AssertionError(f"fused_softmax_cross_entropy[{tag}]: a loss is {excess} beyond "
                             "1e-5 |ref| + 1e-4 from the plain version's")
    record("fused_softmax_cross_entropy", f"M={M} V={V} {tag}", *max_err(loss, want),
           [lambda: ce.fused_softmax_cross_entropy(x, t)],
           lambda: ce.fused_softmax_cross_entropy_plain(x, t32),
           [lambda: F.cross_entropy(x, t, reduction="none")], 2 * M * V + 8 * M,
           4 * M * V, gate="each loss within 1e-4 + 1e-5 |ref|",
           library_what="F.cross_entropy forward", peak=F32_OPS, excess_over_rtol=excess,
           variant=ce.ce_fwd_variant(V, x.element_size()), dtype=tag)
    d = ce.fused_softmax_cross_entropy_bwd(x, t32, gl)
    want = ce.fused_softmax_cross_entropy_bwd_plain(x, t32, gl)
    d_rel = max_elem_rel_err(d, want, floor=1e-8, extra=sub)
    if d_rel > 2 ** -7:
        raise AssertionError(f"fused_softmax_cross_entropy_bwd[{tag}]: a dlogit is {d_rel} "
                             "of its own size from the plain version's (gate 2^-7)")
    xr = x.detach().requires_grad_()

    def library():
        return torch.autograd.grad(F.cross_entropy(xr, t, reduction="none"), xr, gl)

    # The library's backward alone, as row 16's: autograd.grad on one saved
    # F.cross_entropy forward, by the card's own time (the profiler's kernel
    # times) and as 20 back-to-back calls between CUDA events; ours the same
    # ways beside its graph replay (ms).
    s_loss = F.cross_entropy(xr, t, reduction="none")

    def library_bwd():
        return torch.autograd.grad(s_loss, xr, gl, retain_graph=True)

    def ours_bwd():
        return ce.fused_softmax_cross_entropy_bwd(x, t32, gl)

    library_bwd_device_ms = device_ms(library_bwd)
    library_bwd_ms = time_back_to_back(library_bwd)
    del s_loss
    record("fused_softmax_cross_entropy_bwd", f"M={M} V={V} {tag}", *max_err(d, want),
           [ours_bwd], lambda: ce.fused_softmax_cross_entropy_bwd_plain(x, t32, gl), None,
           4 * M * V + 8 * M, 6 * M * V,
           gate="each dlogit within 2^-7 of |ref| + 1e-8 max |ref|"
                + (" + 2^-24 (one fp16 subnormal step)" if sub else ""),
           library_timed=library_bwd_device_ms,
           library_what="F.cross_entropy backward alone (autograd.grad on one saved "
                        "forward), device time from the profiler", peak=F32_OPS,
           max_elem_rel_err=d_rel, variant=ce.ce_bwd_variant(V, x.element_size()),
           library_bwd_device_ms=library_bwd_device_ms,
           library_bwd_ms=library_bwd_ms, bwd_device_ms=device_ms(ours_bwd),
           bwd_back_to_back_ms=time_back_to_back(ours_bwd),
           library_fwd_bwd_ms=time_eager(library), dtype=tag)
    del d, want, xr


def route_flash_rows(record, rows) -> None:
    """The flash rows off the bf16 model paths (``--only flash_rows`` runs
    these alone), each (type, D) group from a random stream of its own, so
    two trees see the same inputs."""
    dev = torch.device("cuda")
    # The other routes (fa.routes), inputs from their own random stream:
    # GPT-2's shape in f32 (the tf32 family both ways), Llama-3.2-1B's
    # GQA heads at T 2048 with head sizes 192 and 256 in bf16 (wgmma both
    # ways), and GPT-2's shape in fp16 (train fp16's,
    # wgmma both ways); the f32 and fp16 rows also hold evaluate's forward
    # (flash_attention).
    own = np.random.default_rng(23)

    def draw(*shape, dtype):
        return torch.from_numpy(own.standard_normal(shape).astype(np.float32)).to(dev, dtype)

    flash_rows(record, rows, 8, 1024, 12, 12, 64, draw, torch.float32, plain_entry=True)
    for D in (192, 256):
        flash_rows(record, rows, 1, 2048, 16, 8, D, draw, device_only=True)
    flash_rows(record, rows, 8, 1024, 12, 12, 64, draw, torch.float16, plain_entry=True)
    # Past D 256 (the forward: bf16 and fp16 on wgmma, K10's wide kernel at
    # D 320 and the column-part kernel at 512, f32 on the tf32 column-part
    # kernel; the backward: bf16 and fp16 on flash_bwd.cu's wgmma part
    # kernels (plan_bwd: its statistics, dK/dV, dQ; 3 CUDA launches), f32 on
    # the 8-warp split kernels) at D 320 and 512 in bf16 and f32, from a
    # stream of their own, and in fp16 from another.
    wide = np.random.default_rng(26)

    def draw_wide(*shape, dtype):
        return torch.from_numpy(wide.standard_normal(shape).astype(np.float32)).to(dev, dtype)

    for D, dtype in ((320, torch.bfloat16), (320, torch.float32), (512, torch.bfloat16),
                     (512, torch.float32)):
        flash_rows(record, rows, 1, 2048, 16, 8, D, draw_wide, dtype, device_only=True)
    wide16 = np.random.default_rng(28)

    def draw_wide16(*shape, dtype):
        return torch.from_numpy(wide16.standard_normal(shape).astype(np.float32)).to(dev, dtype)

    for D in (320, 512):
        flash_rows(record, rows, 1, 2048, 16, 8, D, draw_wide16, torch.float16, device_only=True)
    # f32 at the head sizes off the model paths, from a stream of their own:
    # D 128 (the tf32 family both ways), D 192 and 256 (the tf32 forward,
    # the backward on flash_sync_bwd.cu's split kernels).
    f32_rng = np.random.default_rng(27)

    def draw_f32(*shape, dtype):
        return torch.from_numpy(f32_rng.standard_normal(shape).astype(np.float32)).to(dev, dtype)

    for D in (128, 192, 256):
        flash_rows(record, rows, 1, 2048, 16, 8, D, draw_f32, torch.float32, device_only=True)


def phase_train_kernels(bw, peak_ops, rng):
    """Rows 15 (the statistics launch), 16, 17 and 18 at the training
    path's shapes, each against its plain version on the card."""
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    rows = []
    record = recorder(rows, bw, peak_ops)

    def rand(*shape, scale=1.0, dtype=bf16):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * scale).to(dev,
                                                                                         dtype)

    for B, T, NH, NKV, D in ((8, 1024, 12, 12, 64), (2, 2048, 32, 8, 64), (1, 2048, 24, 8, 128)):
        flash_rows(record, rows, B, T, NH, NKV, D, rand)
    route_flash_rows(record, rows)

    # K12 on wte (50304 x 768 = 38.6M elements): bf16 param and grad, f32
    # moments and master, uint16 noise in int32, with stochastic rounding;
    # without it, a bf16 param rounded to nearest and no master; and an f32
    # LayerNorm leaf (768) with its master, as the trainer updates gamma
    # and beta (p' = master'). Gate: every output bit-equal to the plain
    # version (the same f32 operations, no FMA contraction). Library:
    # torch.optim.AdamW(fused=True) on the same leaf in f32 without SR.
    n, c = 50304 * 768, 768
    w = rand(n, scale=0.02, dtype=torch.float32)
    p, g = w.to(bf16), rand(n, scale=1e-3)
    mom, vel = rand(n, scale=1e-4, dtype=torch.float32), rand(n, scale=1e-4,
                                                             dtype=torch.float32).square()
    noise = torch.randint(0, 1 << 16, (n,), device=dev, dtype=torch.int32)
    ln = 1.0 + rand(c, scale=0.1, dtype=torch.float32)
    ln_g = rand(c, scale=1e-3, dtype=torch.float32)
    ln_m, ln_v = rand(c, scale=1e-4, dtype=torch.float32), rand(c, scale=1e-4,
                                                                dtype=torch.float32).square()

    # wte in fp16 with its f32 master (GPT-2 in fp16 with SR masters): the
    # param rounded to nearest, as JAX's kernel and AdamW give it.
    p16, g16 = w.half(), g.half()
    # (label, p, g, m, v, master, noise, bytes per element read and written
    # once, the library's leaf and what it is)
    f32_lib = "torch.optim.AdamW(fused=True), f32, no SR"
    cases = ((f"wte SR n={n}", p, g, mom, vel, w, noise, 34, w, f32_lib),
             (f"wte nearest, no master n={n}", p, g, mom, vel, None, None, 22, w, f32_lib),
             (f"LayerNorm f32 + master n={c}", ln, ln_g, ln_m, ln_v, ln, None, 36, ln, f32_lib),
             (f"wte fp16 + master n={n}", p16, g16, mom, vel, w, None, 30, p16,
              "torch.optim.AdamW(fused=True), fp16 param, no master"))
    adamw_rows(record, cases)
    del w, p, g, mom, vel, noise, cases, p16, g16

    # K13 at GPT-2's logits, [8192, 50304] bf16, every 7th row ignored.
    # Gates: each loss within 1e-4 + 1e-5 |ref| of the plain version's (a
    # quarter of a row's exp-sum dropped would move it by 0.29); each
    # dlogit within one bf16 step (2^-7) of its own size, floored at 1e-8 of
    # the largest, so a wrong small probability fails as a wrong large one.
    M, V = 8 * 1024, 50304
    x = rand(M, V, scale=2.0)
    t = torch.from_numpy(rng.integers(0, 50257, M)).to(dev)
    t[::7] = -100
    gl = torch.full((M,), 1.0 / M, device=dev)
    # The same rows on the logits in fp16 (GPT-2 trained in fp16): the
    # same gates, but a dlogit may also be one step of fp16's subnormal
    # range (2^-24) away, where both sides round f32 values a few ulps
    # apart (extra: 2^-24 / 2^-7 added to each element's scale).
    for x, tag, sub in ((x, "bf16", 0.0), (x.half(), "fp16", 2.0 ** -17)):
        ce_rows(record, x, t, gl, tag, sub)
    del x
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return rows


def masters_agree(ref, got, m_ref, lr: float) -> float:
    """The masters after one AdamW step, both sides from the same masters:
    each moves by about lr * sign(g), so a master may differ by 2 lr where a
    gradient's sign differs, which happens where the gradient is rounding
    noise (|m| under 3e-2 of its leaf's max: the K third of the qkv bias has
    an exact gradient of 0). Elsewhere at most 2 % of a leaf may differ by
    more than 1e-3 lr. Returns the worst such fraction. Compared on the
    card (``got``'s device): the CPU's f32 passes over a 262.7M-element
    leaf take seconds."""
    from mila_tpu_torch.utils.tree import tree_leaves

    worst = 0.0
    for a, b, mm in zip(tree_leaves(got), tree_leaves(ref), tree_leaves(m_ref)):
        d = (a.float() - b.to(a.device).float()).abs()
        mm = mm.to(a.device).abs()
        if d.max().item() > 2 * lr * 1.01:
            raise AssertionError(f"parity train: a master moved {d.max().item()} > 2 lr apart")
        signal = mm > 3e-2 * mm.max()
        frac = (d[signal] > 1e-3 * lr).float().mean().item() if signal.any() else 0.0
        worst = max(worst, frac)
    if worst > 2e-2:
        raise AssertionError(f"parity train: {worst} of a leaf's masters differ")
    return worst


def tree_cosines(ref, got) -> tuple[float, float]:
    """(min cosine, max of max|d| / max|ref|) over the leaves of two trees;
    a leaf passes with cosine >= 0.999 or max|d| <= ERR_TOL x max|ref|.
    Computed on ``got``'s device (the card), in f64."""
    from mila_tpu_torch.utils.tree import tree_leaves

    cos_min, rel_max = 1.0, 0.0
    for a, b in zip(tree_leaves(got), tree_leaves(ref)):
        # In f64 and scaled to max |ref| = 1: v (0.001 g^2) reaches 1e-13,
        # under cosine_similarity's eps on the product of the norms.
        b = b.to(a.device)
        top = b.abs().max().double().clamp_min(1e-300)
        a, b = a.double().reshape(-1) / top, b.double().reshape(-1) / top
        if not torch.isfinite(a).all():
            raise AssertionError("parity train: a tensor is not finite")
        cos = (a @ b / (a.norm() * b.norm()).clamp_min(1e-300)).item()
        rel = (a - b).abs().max().item()
        if cos < 0.999 and rel > ERR_TOL:
            raise AssertionError(f"parity train: a leaf has cosine {cos}, max rel {rel}")
        cos_min, rel_max = min(cos_min, cos), max(rel_max, rel)
    return cos_min, rel_max


def parity_train_step(module_for, vocab: int, B: int, T: int, rng, lr: float = 1e-3) -> dict:
    """The loss and every gradient leaf, then the Model's AdamW step on them
    (clip, SR masters: what its train step does with those gradients), on
    the card and on the port's CPU path from the same params (built on the
    CPU), batch and noise (one CPU generator's draws). ``module_for(device)``
    builds the module. Gates: the loss within
    1e-2; each gradient, m and v leaf with cosine >= 0.999 or within
    ERR_TOL of its max; the masters within 2 lr (``masters_agree``)."""
    from mila_tpu_torch.models.model import Model, ModelConfig
    from mila_tpu_torch.utils.tree import tree_leaves, tree_map

    toks = rng.integers(0, vocab, (B, T + 1))
    out = {}
    params = None
    for dev in ("cpu", "cuda"):
        model = Model(module_for(dev), train_optimizer(), ModelConfig(epochs=1, verbose=False),
                      device=dev)
        if params is None:
            model.build(0, (B, T))
            params = model.params
        else:
            model.params = tree_map(lambda p: p.to(dev), params)
            model.opt_state = model.optimizer.init(model.params)
            model._compile()
        x, y = (torch.from_numpy(a).to(dev) for a in (toks[:, :-1], toks[:, 1:]))
        t0 = time.monotonic()
        loss, grads = model._value_and_grad(model.params, x, y)
        _, state = model.optimizer.step(model.opt_state, model.params, grads,
                                        rng=torch.Generator().manual_seed(5))
        out[dev] = (float(loss), grads, state, time.monotonic() - t0)
    (l_c, g_c, s_c, t_c), (l_g, g_g, s_g, t_g) = out["cpu"], out["cuda"]
    if not abs(l_g - l_c) <= 1e-2 * abs(l_c):
        raise AssertionError(f"parity train: loss {l_g} on the card vs {l_c} on the CPU")
    g_cos, g_rel = tree_cosines(g_c, g_g)
    m_cos, m_rel = tree_cosines(s_c.m, s_g.m)
    v_cos, v_rel = tree_cosines(s_c.v, s_g.v)
    worst = masters_agree(s_c.master, s_g.master, s_c.m, lr)
    return {"shape": f"B={B} T={T}", "loss_card": l_g, "loss_cpu": l_c,
            "grads": {"min_cosine": g_cos, "max_rel_err": g_rel, "leaves": len(tree_leaves(g_g))},
            "m": {"min_cosine": m_cos, "max_rel_err": m_rel},
            "v": {"min_cosine": v_cos, "max_rel_err": v_rel},
            "masters_worst_fraction_apart": worst,
            "gate": "loss within 1e-2; each leaf cosine >= 0.999 or max|d| <= 2e-2 max|ref|; "
                    "masters within 2 lr, <= 2 % of a leaf's signal elements > 1e-3 lr apart",
            "seconds": {"cpu": t_c, "card": t_g}}


def phase_parity_train(rng, dtype: str = "bfloat16", T: int = 1024):
    """A 1-layer GPT-2 at full width (C 768, NH 12, vocab 50304), B 2, T
    1024 unless named, ``dtype`` params (bf16 unless named) with SR
    masters, flash: ``parity_train_step``."""
    from mila_tpu_torch.models.gpt2 import GPT2

    cfg = gpt2_config(layers=1, dtype=dtype)
    return {"model": f"gpt2-124m widths, 1 layer, {dtype} + SR masters, flash, random weights",
            **parity_train_step(lambda dev: GPT2(cfg), cfg.vocab_size, 2, T, rng)}


def adamw_device_ms(model, grads) -> tuple[float, float]:
    """ms of the device's work in one AdamW.step of ``model`` on ``grads``
    (a tree like its params) as a CUDA-graph replay: the clip's norm launch
    and one fused_adamw_step launch per dtype group, the noise drawn in the
    kernel (no host sync in the step). Then the same launches with each bf16
    leaf's noise passed in as an argument (drawn beforehand, read as
    fused_adamw_update's noise is): the draw's share of the step."""
    from mila_tpu_torch.kernels import fused_adamw as fw
    from mila_tpu_torch.utils.tree import sorted_leaf_index, tree_leaves

    opt, st, params = model.optimizer, model.opt_state, model.params
    step_ms = time_graph([lambda: opt.step(st, params, grads)], reps=5)
    torch.cuda.empty_cache()
    cfg, leaves = opt.config, tree_leaves(params)
    g_leaves = tree_leaves(grads)
    ws = tree_leaves(st.master) if st.master is not None else [None] * len(leaves)
    gen = torch.Generator(device=leaves[0].device).manual_seed(0)
    noises = [torch.randint(0, 1 << 16, p.shape, generator=gen, device=p.device,
                            dtype=torch.int32) if p.dtype == torch.bfloat16 else None
              for p in leaves]
    kw = dict(step=int(st.step) + 1, lr=cfg.learning_rate, beta1=cfg.beta1, beta2=cfg.beta2,
              eps=cfg.eps, weight_decay=cfg.weight_decay, key=None)
    ids = sorted_leaf_index(params)

    def update():
        scale, _ = fw.grad_clip_scale(g_leaves, cfg.grad_clip_norm)
        fw._launch(leaves, g_leaves, tree_leaves(st.m), tree_leaves(st.v), ws, noises, ids,
                   grad_scale=scale, **kw)

    noise_ms = time_graph([update], reps=5)
    del noises
    torch.cuda.empty_cache()
    return step_ms, noise_ms


def phase_train(peak_ops, rng, steps: int = 12, dtype: str = "bfloat16", full: bool = True,
                record=None):
    """GPT-2 124M at full size (``dtype`` params, bf16 unless named; f32 SR
    masters, clip 1.0, flash), B 8, T 1024, through ``train_run``: 148
    parameter leaves. ``full``: split three more steps into their segments,
    time AdamW alone and ``record`` its kernel rows (the bf16 run)."""
    from mila_tpu_torch.models.gpt2 import GPT2
    from mila_tpu_torch.models.model import Model, ModelConfig

    cfg = gpt2_config(dtype=dtype)
    B, T, L = 8, 1024, cfg.num_layers
    t0 = time.monotonic()
    model = Model(GPT2(cfg), train_optimizer(), ModelConfig(epochs=1, verbose=False))
    model.build(0, (B, T))
    tag = "" if dtype == "bfloat16" else f" {dtype}"
    return train_run(model, tag, t0, (B, T), (L, cfg.num_heads,
                                               cfg.embedding_dim // cfg.num_heads),
                     cfg.vocab_size, 2 + 12 * L + 2, rng, peak_ops, steps, full,
                     f"gpt2-124m, {dtype} params + f32 SR masters, flash, random weights",
                     record)


def adamw_per_step(model) -> dict:
    """AdamW's launches a train step of ``model``: fused_adamw_step once per
    (param dtype, grad dtype) group (the grads take the params' dtypes),
    grad_clip_scale once where it clips."""
    from mila_tpu_torch.utils.tree import tree_leaves

    return {"fused_adamw_step": len({p.dtype for p in tree_leaves(model.params)}),
            "grad_clip_scale": int(model.optimizer.config.grad_clip_norm > 0)}


def train_run(model, tag: str, t0: float, shape, heads, vocab: int, n_expected: int, rng,
              peak_ops, steps: int, full: bool, what: str, record=None):
    """Model.train of a built causal LM (built since ``t0``) over ``steps``
    batches of synthetic windows with structure (each one of 4 fixed random
    sequences, so the loss must fall), then Model.evaluate on one batch;
    ``shape`` (B, T), ``heads`` (L, NH, D), ``n_expected`` the parameter
    leaf count it must have. Paths "train" + tag and "evaluate" + tag: launch
    counts per train step flash_attention_forward L, flash_attention_bwd L,
    the CE forward and backward once each, AdamW's (adamw_per_step); per
    eval step flash_attention L and the CE forward once; no plain version
    anywhere. The loss must fall by 1 nat. ``full``: split three more steps
    into their segments, time AdamW alone and ``record`` its kernel rows at
    the model's leaves and gradients."""
    from mila_tpu_torch.data.loader import ArrayReader
    from mila_tpu_torch.utils.tree import tree_leaves, tree_unflatten

    (B, T), (L, NH, D) = shape, heads
    torch.cuda.synchronize()
    build_s = time.monotonic() - t0
    n_leaves, n_params = len(tree_leaves(model.params)), model.parameter_count()
    if n_leaves != n_expected:
        raise AssertionError(f"train{tag}: {n_leaves} parameter leaves, not {n_expected}")
    base = rng.integers(0, vocab, (4, T + 1)).astype(np.int32)
    data = base[rng.integers(0, 4, B * steps)]
    reader = ArrayReader(data[:, :-1], data[:, 1:], B, seed=0)

    times, losses = [], []
    inner = model._train_step

    def timed(*args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = inner(*args)
        losses.append(float(res[2]))
        times.append(time.perf_counter() - t)
        return res

    model._train_step = timed
    per_step = {"flash_attention_forward": L, "flash_attention_bwd": L,
                "fused_softmax_cross_entropy": 1, "fused_softmax_cross_entropy_bwd": 1,
                **adamw_per_step(model)}
    torch.cuda.reset_peak_memory_stats()
    _, t_counts = run_counted("train" + tag, lambda: model.train(reader),
                              {k: v * steps for k, v in per_step.items()})
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    model._train_step = inner
    ev = ArrayReader(data[:B, :-1], data[:B, 1:], B, shuffle=False)
    val, e_counts = run_counted("evaluate" + tag, lambda: model.evaluate(ev),
                                {"flash_attention": L, "fused_softmax_cross_entropy": 1})
    # Falling: the median of the last 4 steps' losses (lr 1e-3 with no warm-up
    # spikes a step now and then) and the eval loss at least 1 nat under the
    # first step's.
    tail = statistics.median(losses[-4:])
    if (not all(np.isfinite(losses)) or not np.isfinite(val) or not tail < losses[0] - 1.0
            or not val < losses[0] - 1.0):
        raise AssertionError(f"train{tag}: losses {losses}, eval {val}: not finite and falling")
    step_s = statistics.median(times[2:])
    flops = 6 * n_params * B * T + 7 * T * T * D * B * NH * L
    out = {"model": what,
           "shape": f"B={B} T={T}", "steps": steps, "params": n_params, "leaves": n_leaves,
           "build_s": build_s, "ms_per_step": step_s * 1e3,
           "step_ms_all": [t * 1e3 for t in times], "tokens_per_s": B * T / step_s,
           "model_tflop_per_step": flops / 1e12, "mfu": flops / step_s / peak_ops,
           "mfu_note": "model FLOPs utilisation against the published bf16 peak",
           "loss_first": losses[0], "loss_last": losses[-1], "loss_median_last4": tail,
           "losses": losses, "eval_loss": val, "peak_mem_gb": peak_gb,
           "launches_per_step": per_step, "launches": t_counts, "launches_eval": e_counts}
    if not full:
        return t_counts, e_counts, out

    # Three more steps, each split into forward + loss, backward and AdamW:
    # the device's time between CUDA events and the host's clock between
    # the same marks (no host sync in them). Where a segment's device time
    # is about its host time, the device waited on the host's launches.
    # Then AdamW's device work alone, the clip's norm and one update launch
    # per dtype group, as a graph replay, and its kernel rows.
    x, y = (torch.from_numpy(a).cuda() for a in (data[:B, :-1], data[:B, 1:]))
    names = ("forward_loss", "backward", "adamw")
    split, host = {k: [] for k in names}, {k: [] for k in names}
    for _ in range(3):
        ev_ = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(model.params)]
        torch.cuda.synchronize()
        marks = []
        ev_[0].record()
        marks.append(time.perf_counter())
        with torch.enable_grad():
            loss = model._loss_fn(model.module, tree_unflatten(model.params, leaves), x, y)
            ev_[1].record()
            marks.append(time.perf_counter())
            grads = torch.autograd.grad(loss, leaves)
        ev_[2].record()
        marks.append(time.perf_counter())
        model.optimizer.step(model.opt_state, model.params, tree_unflatten(model.params,
                                                                           list(grads)))
        ev_[3].record()
        marks.append(time.perf_counter())
        torch.cuda.synchronize()
        for i, k in enumerate(names):
            split[k].append(ev_[i].elapsed_time(ev_[i + 1]))
            host[k].append((marks[i + 1] - marks[i]) * 1e3)
    del leaves, loss
    grads = list(grads)
    adamw_graph_ms, adamw_noise_ms = adamw_device_ms(model, tree_unflatten(model.params, grads))
    p_leaves, st = tree_leaves(model.params), model.opt_state
    masters = tree_leaves(st.master) if st.master is not None else [None] * len(p_leaves)
    clip = model.optimizer.config.grad_clip_norm
    # The step's bound: the update's bytes and the clip's read of g.
    bound_bytes = adamw_update_bytes(p_leaves, masters) + (
        sum(g.numel() * g.element_size() for g in grads) if clip else 0)
    if record is not None:
        from mila_tpu_torch.utils.tree import sorted_leaf_index

        adamw_step_rows(record, what.split(",")[0], p_leaves, grads, tree_leaves(st.m),
                        tree_leaves(st.v), masters, sorted_leaf_index(model.params), clip)
    del grads
    torch.cuda.empty_cache()

    return t_counts, e_counts, {
        **out, "step_split_ms": {k: statistics.median(v) for k, v in split.items()},
        "step_split_ms_all": split, "step_split_host_ms_all": host,
        "adamw_graph_ms": adamw_graph_ms, "adamw_graph_noise_arg_ms": adamw_noise_ms,
        "adamw_bound_ms": bound_bytes / 3.35e12 * 1e3, "adamw_bound_bytes": bound_bytes}


# ---------------------------------------------------------------------------
# Llama-3.2-1B trained through Model
# ---------------------------------------------------------------------------

def llama_train_config(layers=None):
    """Llama-3.2-1B at full width (H 2048, FFN 8192, NH 32 / NKV 8, D 64,
    vocab 128256, tied, llama3 RoPE scaling), bf16 params; ``layers`` cuts
    depth. Attention resolves as configured ("auto": flash on the card
    from FLASH_MIN_SEQ keys)."""
    from mila_tpu_torch.models.llama import LlamaConfig

    cfg = LlamaConfig.llama32_1b()
    return cfg if layers is None else cfg.replace(num_layers=layers)


def phase_train_llama_kernels(bw, peak_ops):
    """Rows 15-18 at Llama-3.2-1B's training shapes, each against its plain
    version on the card, inputs drawn on the card from a generator of their
    own (a 525M-element logits tensor is slow to draw on the host): K10's
    statistics launch and K11 at B 2, T 2048, NH 32 / NKV 8, D 64 (the
    flash gates of kernels train); K12 on the tied wte (128256 x 2048 =
    262.7M elements, bf16 with its f32 master and SR noise; bit-equal);
    K13 at the step's logits [4096, 128256] in bf16, every 7th row ignored
    (256 KB rows: the streamed backward), with kernels train's gates."""
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    rows = []
    record = recorder(rows, bw, peak_ops)
    gen = torch.Generator(device=dev).manual_seed(19)

    def draw(*shape, dtype=bf16, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    flash_rows(record, rows, 2, 2048, 32, 8, 64, draw)
    n = 128256 * 2048
    w = draw(n, dtype=torch.float32, scale=0.02)
    p, g = w.to(bf16), draw(n, scale=1e-3)
    mom, vel = draw(n, dtype=torch.float32, scale=1e-4), draw(n, dtype=torch.float32,
                                                              scale=1e-4).square()
    noise = torch.randint(0, 1 << 16, (n,), generator=gen, device=dev, dtype=torch.int32)
    adamw_rows(record, ((f"llama wte SR n={n}", p, g, mom, vel, w, noise, 34, w,
                         "torch.optim.AdamW(fused=True), f32, no SR"),))
    del w, p, g, mom, vel, noise
    torch.cuda.empty_cache()
    M, V = 2 * 2048, 128256
    x = draw(M, V, scale=2.0)
    t = torch.randint(0, V, (M,), generator=gen, device=dev)
    t[::7] = -100
    ce_rows(record, x, t, torch.full((M,), 1.0 / M, device=dev), "bf16", 0.0)
    del x
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return rows


def phase_parity_train_llama(rng):
    """One layer at Llama-3.2-1B's widths (vocab 128256, tied), bf16 + SR
    masters, flash forced, B 1, T 512: ``parity_train_step``."""
    from mila_tpu_torch.models.llama import Llama

    cfg = llama_train_config(layers=1).replace(attention_impl="flash")
    return {"model": "llama-3.2-1b widths, 1 layer, bfloat16 + SR masters, flash, random "
                     "weights", **parity_train_step(lambda dev: Llama(cfg, device=dev),
                                                    cfg.vocab_size, 1, 512, rng)}


def phase_train_llama(peak_ops, rng, steps: int = 12, record=None):
    """Llama-3.2-1B at full width and depth, nothing cut (bf16 params, f32
    SR masters, AdamW with clip 1.0; flash from T 2048), B 2, T 2048,
    through ``train_run``: 146 parameter leaves (the tied wte, 9 a layer,
    norm_f), so per step flash_attention_forward 16, flash_attention_bwd
    16, the CE forward and backward once each, AdamW's (adamw_per_step),
    and ``record``s AdamW's kernel rows at its 146 leaves. Its random
    weights are drawn on the card (a generator there)."""
    from mila_tpu_torch.models.llama import Llama
    from mila_tpu_torch.models.model import Model, ModelConfig

    cfg = llama_train_config()
    t0 = time.monotonic()
    model = Model(Llama(cfg), train_optimizer(), ModelConfig(epochs=1, verbose=False))
    model.build(torch.Generator(device="cuda").manual_seed(0), (2, 2048))
    return train_run(model, " llama", t0, (2, 2048), (cfg.num_layers, cfg.num_heads, cfg.hd),
                     cfg.vocab_size, 2 + 9 * cfg.num_layers, rng, peak_ops, steps, True,
                     "llama-3.2-1b, bfloat16 params + f32 SR masters, flash, random weights",
                     record)


# ---------------------------------------------------------------------------
# The CNN classifier trained through Model
# ---------------------------------------------------------------------------

# Launches per CNN train step: the CE forward and backward once each, AdamW's
# step once (one dtype group: f32; no clip). Its leaves: two Conv2D and two
# Linear layers, weight and bias each.
CNN_STEP = {"fused_softmax_cross_entropy": 1, "fused_softmax_cross_entropy_bwd": 1,
            "fused_adamw_step": 1}
CNN_LEAVES = (288, 32, 18432, 64, 401408, 128, 1280, 10)


def cnn_model(epochs: int):
    """The default CNNClassifier (conv 32, 64; hidden 128; f32) under Model
    on the card, AdamW lr 1e-3, prefetch depth 2."""
    from mila_tpu_torch.models import CNNClassifier, CNNClassifierConfig, Model, ModelConfig
    from mila_tpu_torch.optim import AdamW, AdamWConfig

    return Model(CNNClassifier(CNNClassifierConfig(name="cnn")),
                 AdamW(AdamWConfig(learning_rate=1e-3)),
                 ModelConfig(name="cnn", epochs=epochs, verbose=False))


def phase_train_cnn(bw, peak_ops, rng):
    """The CNN through Model on the synthetic surrogate (its convolutions
    and pools on cuDNN and PyTorch's own, in true f32): K12 at the CNN's
    eight leaves in one step (CNN_LEAVES; its CE rows are train mnist's
    shapes) against its plain version; the gate run at train
    mnist's shape (B 128, 4096 samples, 4 epochs: the loss halves, the JAX
    CNN test's gate; the test split's accuracy printed) and the rate run
    at its rate run's (B 2048, synthetic_mnist(65536, seed 0), 4 epochs:
    the loss falls; samples/s the median epoch after the first). Launches
    per step: CNN_STEP."""
    from mila_tpu_torch.data import ArrayReader, MnistReader, synthetic_mnist
    from mila_tpu_torch.models import accuracy
    from mila_tpu_torch.utils.tree import tree_leaves

    rows = mnist_kernel_rows(bw, peak_ops, rng, batches=(), leaf_sizes=CNN_LEAVES, label="cnn")
    train, model = mnist_reader(), cnn_model(4)
    model.build(0, (128, 784))
    n_leaves = len(tree_leaves(model.params))
    if [p.numel() for p in tree_leaves(model.params)] != list(CNN_LEAVES):
        raise AssertionError(f"train cnn: leaves of {[p.numel() for p in tree_leaves(model.params)]}"
                             f" elements, not CNN_LEAVES")
    steps = 4 * train.num_batches
    t0 = time.monotonic()
    _, counts = run_counted("train cnn", lambda: model.train(train),
                            {k: v * steps for k, v in CNN_STEP.items()})
    gate_s = time.monotonic() - t0
    losses = model.history.train_losses
    test = MnistReader(batch_size=128, split="test", synthetic_n=1024, shuffle=False,
                       drop_last=False)
    logits = torch.cat([model.predict(x) for x, _ in test])
    acc = accuracy(logits, np.concatenate([y for _, y in test]))
    if not (all(np.isfinite(losses)) and losses[-1] < 0.5 * losses[0]
            and logits.shape == (204, 10) and torch.isfinite(logits).all()):
        raise AssertionError(f"train cnn: losses {losses} on {tuple(logits.shape)} logits")

    x, y = synthetic_mnist(n=65536, seed=0)
    reader, rate = ArrayReader(x, y, 2048, seed=0), cnn_model(4)
    rate.build(0, (2048, 784))
    r_steps = 4 * reader.num_batches
    _, r_counts = run_counted("train cnn rate", lambda: rate.train(reader),
                              {k: v * r_steps for k, v in CNN_STEP.items()})
    r_losses, sps = rate.history.train_losses, rate.history.samples_per_sec
    if not (all(np.isfinite(r_losses)) and r_losses[-1] < r_losses[0]):
        raise AssertionError(f"train cnn rate: losses {r_losses} do not fall")
    med = statistics.median(sps[1:])
    return counts, r_counts, rows, {
        "model": "CNNClassifier conv 32, 64, hidden 128, f32, AdamW lr 1e-3, prefetch_depth 2, "
                 "synthetic MNIST",
        "params": model.parameter_count(), "leaves": n_leaves,
        "gate": {"shape": "B=128, 4096 samples, 4 epochs", "losses": losses, "accuracy": acc,
                 "test_samples": int(logits.shape[0]), "seconds": gate_s,
                 "gate": "loss halves"},
        "rate": {"shape": "B=2048, synthetic_mnist(65536, seed 0), 4 epochs", "losses": r_losses,
                 "samples_per_s_all": sps, "samples_per_s": med, "ms_per_step": 2048 / med * 1e3,
                 "steps_per_epoch": reader.num_batches},
        "launches_per_step": CNN_STEP, "launches": counts, "launches_rate": r_counts}


# ---------------------------------------------------------------------------
# MNIST MLP: train, resume, export; GPT-2 resume; the data layer
# ---------------------------------------------------------------------------

# Launches per MNIST train step: the CE forward and backward once each,
# AdamW's step once (f32 leaves, no clip). Its leaves: three Linear layers,
# weight and bias each.
MNIST_STEP = {"fused_softmax_cross_entropy": 1, "fused_softmax_cross_entropy_bwd": 1,
              "fused_adamw_step": 1}
MNIST_LEAVES = (784 * 128, 128, 128 * 64, 64, 640, 10)


def mnist_model(epochs: int, **cfg):
    """The reference's MNIST classifier (784-128-64-10, tanh GELU, f32)
    under Model on the card, AdamW lr 1e-3; prefetch depth 2 unless
    ``cfg`` names another."""
    from mila_tpu_torch.models import MLPClassifier, MLPClassifierConfig, Model, ModelConfig
    from mila_tpu_torch.optim import AdamW, AdamWConfig

    return Model(MLPClassifier(MLPClassifierConfig(name="mnist")),
                 AdamW(AdamWConfig(learning_rate=1e-3)),
                 ModelConfig(name="mnist", epochs=epochs, verbose=False, **cfg))


def mnist_reader():
    """The JAX e2e test's training set: the synthetic surrogate, 4096
    samples, batch 128."""
    from mila_tpu_torch.data import MnistReader

    return MnistReader(batch_size=128, split="train", synthetic_n=4096, seed=0)


def mnist_kernel_rows(bw, peak_ops, rng, batches=(2048, 128), leaf_sizes=MNIST_LEAVES,
                      label: str = "mnist mlp") -> list:
    """Rows 17 and 18 at the MNIST train step's shapes, each against its
    plain version on the card: K13 forward and backward on f32 logits
    [2048, 10] (bench.py's batch) and [128, 10] (the e2e test's), 40-byte
    rows that take the short forward and the backward's scalar branch;
    K12's step over the MLP's six f32 leaves without masters (MNIST_LEAVES;
    10 ends in the scalar tail), one launch. Gates as in kernels train (CE:
    loss within 1e-4 + 1e-5 |ref|, each dlogit within 2^-7 of its own size;
    AdamW bit-equal). ms: 50 launches in one graph replay, per launch;
    device_ms: the profiler's kernel time a call. Library: the profiler's
    device time of F.cross_entropy's backward and of
    torch.optim.AdamW(fused=True)'s step over the same leaves;
    F.cross_entropy's forward as 50 in a graph replay, and by the profiler.
    ``batches`` and ``leaf_sizes`` name other shapes (the CNN's leaves)."""
    import torch.nn.functional as F

    from mila_tpu_torch.kernels import fused_adamw as fw
    from mila_tpu_torch.kernels import softmax_ce as ce

    dev = torch.device("cuda")
    rows = []
    record = recorder(rows, bw, peak_ops)
    graph_calls = 50  # launches a graph replay: a replay costs several of these kernels

    def rand(*shape, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * scale).to(dev)

    V = 10
    for M in batches:
        x = rand(M, V, scale=3.0)
        t = torch.from_numpy(rng.integers(0, V, M)).to(dev)
        t32 = t.to(torch.int32)
        gl = torch.full((M,), 1.0 / M, device=dev)
        loss = ce.fused_softmax_cross_entropy(x, t)
        want = ce.fused_softmax_cross_entropy_plain(x, t32)
        excess = ((loss - want).abs() - 1e-5 * want.abs()).max().item()
        if not torch.isfinite(loss).all() or excess > 1e-4:
            raise AssertionError(f"fused_softmax_cross_entropy[M={M} V={V}]: a loss is {excess} "
                                 "beyond 1e-5 |ref| + 1e-4 from the plain version's")
        record("fused_softmax_cross_entropy", f"M={M} V={V} f32", *max_err(loss, want),
               [lambda: ce.fused_softmax_cross_entropy(x, t)] * graph_calls,
               lambda: ce.fused_softmax_cross_entropy_plain(x, t32),
               [lambda: F.cross_entropy(x, t, reduction="none")] * graph_calls,
               4 * M * V + 8 * M, 4 * M * V, gate="each loss within 1e-4 + 1e-5 |ref|",
               library_what="F.cross_entropy forward", peak=F32_OPS, excess_over_rtol=excess,
               device_ms=device_ms(lambda: ce.fused_softmax_cross_entropy(x, t)),
               library_device_ms=device_ms(lambda: F.cross_entropy(x, t, reduction="none")),
               variant=ce.ce_fwd_variant(V, 4), dtype="float32")
        d = ce.fused_softmax_cross_entropy_bwd(x, t32, gl)
        want = ce.fused_softmax_cross_entropy_bwd_plain(x, t32, gl)
        d_rel = max_elem_rel_err(d, want, floor=1e-8)
        if d_rel > 2 ** -7:
            raise AssertionError(f"fused_softmax_cross_entropy_bwd[M={M} V={V}]: a dlogit is "
                                 f"{d_rel} of its own size from the plain version's")
        xr = x.detach().requires_grad_()
        s_loss = F.cross_entropy(xr, t, reduction="none")
        lib_bwd = device_ms(lambda: torch.autograd.grad(s_loss, xr, gl, retain_graph=True))
        del s_loss
        record("fused_softmax_cross_entropy_bwd", f"M={M} V={V} f32", *max_err(d, want),
               [lambda: ce.fused_softmax_cross_entropy_bwd(x, t32, gl)] * graph_calls,
               lambda: ce.fused_softmax_cross_entropy_bwd_plain(x, t32, gl), None,
               8 * M * V + 8 * M, 6 * M * V,
               gate="each dlogit within 2^-7 of |ref| + 1e-8 max |ref|",
               library_timed=lib_bwd, library_what="F.cross_entropy backward alone "
               "(autograd.grad on one saved forward), device time from the profiler",
               peak=F32_OPS, max_elem_rel_err=d_rel, variant=ce.ce_bwd_variant(V, 4),
               device_ms=device_ms(lambda: ce.fused_softmax_cross_entropy_bwd(x, t32, gl)),
               dtype="float32")

    # K12's step over the model's f32 leaves, no masters, as AdamW.step
    # launches it (one launch; no clip).
    leaves = [rand(n, scale=0.05) for n in leaf_sizes]
    grads = [rand(n, scale=0.1) for n in leaf_sizes]
    ms = [rand(n, scale=0.01) for n in leaf_sizes]
    vs = [rand(n, scale=0.01).square() for n in leaf_sizes]
    adamw_step_rows(record, label, leaves, grads, ms, vs, [None] * len(leaves),
                    list(range(len(leaves))), 0.0, graph_calls=graph_calls, profile=True)
    return rows


def phase_train_mnist(bw, peak_ops, rng):
    """The reference's validated workload through Model on the card, batches
    through the prefetcher at depth 2. Gate run (tests/models/
    test_mnist_e2e.py's shape): 4 epochs over 4096 synthetic samples at
    batch 128; the loss must halve and the test split (204 samples) reach
    0.975 accuracy. Rate run (bench.py's shape): synthetic_mnist(65536,
    seed 0) at batch 2048, 4 epochs; the loss must fall; samples/s is the
    median epoch after the first. Launches per step: MNIST_STEP."""
    from mila_tpu_torch.data import ArrayReader, MnistReader, synthetic_mnist
    from mila_tpu_torch.models import accuracy

    rows = mnist_kernel_rows(bw, peak_ops, rng)
    train, model = mnist_reader(), mnist_model(4)
    model.build(0, (128, 784))
    steps = 4 * train.num_batches
    t0 = time.monotonic()
    _, counts = run_counted("train mnist", lambda: model.train(train),
                            {k: v * steps for k, v in MNIST_STEP.items()})
    gate_s = time.monotonic() - t0
    losses = model.history.train_losses
    test = MnistReader(batch_size=128, split="test", synthetic_n=1024, shuffle=False,
                       drop_last=False)
    logits = torch.cat([model.predict(x) for x, _ in test])
    acc = accuracy(logits, np.concatenate([y for _, y in test]))
    if not (all(np.isfinite(losses)) and losses[-1] < 0.5 * losses[0] and acc >= 0.975
            and logits.shape == (204, 10)):
        raise AssertionError(f"train mnist: losses {losses}, accuracy {acc} on "
                             f"{tuple(logits.shape)} logits")

    x, y = synthetic_mnist(n=65536, seed=0)
    reader, rate = ArrayReader(x, y, 2048, seed=0), mnist_model(4)
    rate.build(0, (2048, 784))
    r_steps = 4 * reader.num_batches
    _, r_counts = run_counted("train mnist rate", lambda: rate.train(reader),
                              {k: v * r_steps for k, v in MNIST_STEP.items()})
    r_losses, sps = rate.history.train_losses, rate.history.samples_per_sec
    if not (all(np.isfinite(r_losses)) and r_losses[-1] < r_losses[0]):
        raise AssertionError(f"train mnist rate: losses {r_losses} do not fall")
    med = statistics.median(sps[1:])
    return counts, r_counts, model, rows, {
        "model": "MLPClassifier 784-128-64-10 f32, AdamW lr 1e-3, prefetch_depth 2, "
                 "synthetic MNIST",
        "gate": {"shape": "B=128, 4096 samples, 4 epochs", "losses": losses, "accuracy": acc,
                 "test_samples": int(logits.shape[0]), "seconds": gate_s,
                 "gate": "loss halves; accuracy >= 0.975"},
        "rate": {"shape": "B=2048, synthetic_mnist(65536, seed 0), 4 epochs", "losses": r_losses,
                 "samples_per_s_all": sps, "samples_per_s": med, "ms_per_step": 2048 / med * 1e3,
                 "steps_per_epoch": reader.num_batches},
        "launches_per_step": MNIST_STEP, "launches": counts, "launches_rate": r_counts}


def phase_resume_mnist(straight, tmp: str):
    """At the gate run's shape: 2 epochs, a checkpoint (checkpoint_frequency
    2), a fresh Model, resume_training for 2 more; params, moments and
    predictions bit-equal to ``straight`` (the train mnist gate run, 4
    epochs through). The same 4 epochs at prefetch depth 0: losses
    bit-equal to the depth-2 run's. Then Model.export (params, no
    optimizer) and export_model + Predictor.from_archive: predictions
    bit-equal to the model's."""
    from pathlib import Path

    from mila_tpu_torch.models.export import Predictor, export_model
    from mila_tpu_torch.serialization import load_checkpoint
    from mila_tpu_torch.utils.tree import tree_leaves

    def body():
        first = mnist_model(2, checkpoint_dir=tmp, checkpoint_frequency=2)
        first.build(0, (128, 784))
        first.train(mnist_reader())
        resumed = mnist_model(2, checkpoint_dir=tmp)
        resumed.build(0, (128, 784))
        resumed.resume_training(mnist_reader())
        sync = mnist_model(4, prefetch_depth=0)
        sync.build(0, (128, 784))
        sync.train(mnist_reader())
        return resumed, sync

    steps = (2 + 2 + 4) * mnist_reader().num_batches
    (resumed, sync), counts = run_counted("resume mnist", body,
                                          {k: v * steps for k, v in MNIST_STEP.items()})
    pairs = [(straight.params, resumed.params), (straight.opt_state.m, resumed.opt_state.m),
             (straight.opt_state.v, resumed.opt_state.v)]
    if not all(torch.equal(a, b) for x, y in pairs for a, b in zip(tree_leaves(x),
                                                                  tree_leaves(y))):
        raise AssertionError("resume mnist: the resumed run is not bit-equal to the straight one")
    xb, _ = mnist_reader().next_batch(0)
    want = straight.predict(xb)
    if not torch.equal(resumed.predict(xb), want):
        raise AssertionError("resume mnist: the resumed model predicts otherwise")
    if sync.history.train_losses != straight.history.train_losses:
        raise AssertionError(f"resume mnist: depth 0 losses {sync.history.train_losses} != "
                             f"depth 2 {straight.history.train_losses}")
    straight.export(Path(tmp) / "export.mila")
    exported = load_checkpoint(Path(tmp) / "export.mila")
    if exported["optimizer"] is not None or not torch.equal(
            exported["params"]["head"]["weight"], straight.params["head"]["weight"].cpu()):
        raise AssertionError("resume mnist: Model.export wrote other params or an optimizer")
    export_model(Path(tmp) / "mlp.mila", straight.module, straight.params)
    predictor = Predictor.from_archive(Path(tmp) / "mlp.mila")
    if not torch.equal(predictor.predict_batch(xb), want):
        raise AssertionError("resume mnist: Predictor.from_archive predicts otherwise")
    return counts, {"shape": "B=128, 4096 samples: 4 epochs straight; 2 + checkpoint + fresh "
                             "Model + resume_training 2; 4 at prefetch_depth 0",
                    "checkpoint_bytes": (Path(tmp) / "mnist_epoch0001.mila").stat().st_size,
                    "gate": "params, m, v and predictions bit-equal; depth 0 losses == depth 2; "
                            "exported predictions bit-equal", "launches": counts}


def phase_resume_gpt2(rng, tmp: str):
    """GPT-2 at full width and 2 layers (bf16 params, f32 SR masters, clip
    1.0, flash), B 8, T 1024, one batch an epoch: 4 steps straight through
    against 2 steps, save_checkpoint, a fresh Model, load_checkpoint and 2
    more; params, masters and moments bit-equal. The archive's size and
    its save and load seconds."""
    from mila_tpu_torch.data.loader import ArrayReader
    from mila_tpu_torch.models.gpt2 import GPT2
    from mila_tpu_torch.models.model import Model, ModelConfig
    from mila_tpu_torch.utils.tree import tree_leaves

    cfg = gpt2_config(layers=2)
    B, T, L = 8, 1024, cfg.num_layers
    base = rng.integers(0, cfg.vocab_size, (4, T + 1)).astype(np.int32)
    data = base[rng.integers(0, 4, B)]

    def reader():
        return ArrayReader(data[:, :-1], data[:, 1:], B, seed=0)

    def model(epochs, **kw):
        m = Model(GPT2(cfg), train_optimizer(), ModelConfig(name="gpt2", epochs=epochs,
                                                            verbose=False, **kw))
        m.build(0, (B, T))
        return m

    times = {}

    def body():
        straight = model(4)
        straight.train(reader())
        first = model(2)
        first.train(reader())
        t0 = time.monotonic()
        path = first.save_checkpoint(f"{tmp}/gpt2_epoch0001.mila", epoch=1)
        times["save_s"] = time.monotonic() - t0
        fresh = model(2)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        meta = fresh.load_checkpoint(path)
        torch.cuda.synchronize()
        times["load_s"] = time.monotonic() - t0
        fresh.train(reader(), start_epoch=int(meta["epoch"]) + 1)
        return straight, fresh, path

    def expected(out):
        per_step = {"flash_attention_forward": L, "flash_attention_bwd": L,
                    "fused_softmax_cross_entropy": 1, "fused_softmax_cross_entropy_bwd": 1,
                    **adamw_per_step(out[0])}
        return {k: v * 8 for k, v in per_step.items()}

    (straight, fresh, path), counts = run_counted("resume gpt2", body, expected)
    a, b = straight.opt_state, fresh.opt_state
    for name, x, y in (("params", straight.params, fresh.params), ("master", a.master, b.master),
                       ("m", a.m, b.m), ("v", a.v, b.v)):
        if not all(torch.equal(p, q) for p, q in zip(tree_leaves(x), tree_leaves(y))):
            raise AssertionError(f"resume gpt2: {name} after the resume is not bit-equal")
    if not (b.step == a.step == 4 and len(straight.history.train_losses) == 4):
        raise AssertionError("resume gpt2: not 4 steps on each side")
    return counts, {"model": "gpt2-124m widths, 2 layers, bf16 params + f32 SR masters, flash, "
                             "random weights", "shape": f"B={B} T={T}",
                    "archive_bytes": path.stat().st_size, **times,
                    "losses": straight.history.train_losses,
                    "gate": "params, masters, m and v bit-equal after 4 steps", "launches": counts}


def phase_data(rng, tmp: str):
    """The data layer on the card's machine, host work only: the native
    library loaded (built from native/ at first use); the BPE encoder's
    native ids equal to its Python ones on a seeded synthetic text; a
    TokenReader over an llm.c shard written here giving the windows that
    read_token_file and numpy give; an IDX round trip; CharReader batches
    on a written corpus."""
    import struct
    from pathlib import Path

    from mila_tpu_torch import native
    from mila_tpu_torch.data import BPETokenizer, CharReader, TokenReader, read_token_file
    from mila_tpu_torch.data.mnist import read_idx_images, read_idx_labels

    if not native.available():
        raise AssertionError(f"data: the native library did not load: {native.load_error()}")
    pieces = ["the", " the", "and", " and", "ing", "er", "12", " ", "a", "b", "'s", "\n", "é",
              "th", "in", " a", ", ", "!"]
    text = "".join(pieces[i] for i in rng.integers(0, len(pieces), 4000))
    tok = BPETokenizer.byte_fallback([b"th", b"he", b"the", b" the", b"an", b"and", b" and",
                                      b"in", b"ing", b"er", b" a", b"12"])
    ids = tok.encode(text)
    if not (tok._native_handle is not None and np.array_equal(ids, tok.encode(text,
                                                                          use_native=False))
            and tok.decode(ids) == text):
        raise AssertionError("data: native BPE ids differ from the Python encoder's")

    toks = rng.integers(0, 50257, 100_000).astype(np.uint16)
    header = np.zeros(256, np.int32)
    header[:3] = (20240520, 1, len(toks))
    shard = Path(tmp) / "shard.bin"
    shard.write_bytes(header.tobytes() + toks.tobytes())
    flat = read_token_file(shard)
    reader = TokenReader([shard], batch_size=8, seq_len=64, shuffle=True, seed=3)
    if not np.array_equal(flat, toks.astype(np.int32)):
        raise AssertionError("data: read_token_file differs from the shard's tokens")
    for i in range(5):
        x, y = reader.next_batch(i)
        starts = reader._starts[reader._perm[i * 8:(i + 1) * 8]]
        win = flat[starts[:, None] + np.arange(65)[None, :]]
        if not (np.array_equal(x, win[:, :-1]) and np.array_equal(y, win[:, 1:])):
            raise AssertionError("data: TokenReader's windows differ from numpy's")

    imgs = rng.integers(0, 256, (16, 28, 28)).astype(np.uint8)
    labels = rng.integers(0, 10, 16).astype(np.uint8)
    (Path(tmp) / "i.idx").write_bytes(struct.pack(">IIII", 2051, 16, 28, 28) + imgs.tobytes())
    (Path(tmp) / "l.idx").write_bytes(struct.pack(">II", 2049, 16) + labels.tobytes())
    if not (np.array_equal(read_idx_images(Path(tmp) / "i.idx"),
                           # the native reader's scaling: times float(1 / 255)
                           imgs.reshape(16, 784).astype(np.float32) * np.float32(1.0 / 255.0))
            and np.array_equal(read_idx_labels(Path(tmp) / "l.idx"), labels.astype(np.int32))):
        raise AssertionError("data: the IDX round trip differs")

    corpus = Path(tmp) / "input.txt"
    corpus.write_text(text)
    chars = CharReader(corpus, batch_size=4, seq_len=32, seed=1)
    x, y = chars.next_batch(0)
    if not (x.shape == (4, 32) and np.array_equal(x[:, 1:], y[:, :-1])
            and chars.vocab.decode(x[0]) in text):
        raise AssertionError("data: CharReader's batch is not a shifted window of the corpus")
    return {"native": True, "bpe_tokens": int(len(ids)), "bpe_bytes": len(text.encode()),
            "token_windows_checked": 40, "idx_images": 16, "char_vocab": chars.vocab.size,
            "gate": "native loaded; native BPE == Python; TokenReader == numpy windows; "
                    "IDX round trip; CharReader windows shifted by one"}


def phase_runtime(rng, tmp: str):
    """runtime/ and utils/profiling on the card: get_device("auto") and the
    default context are cuda:0; DeviceProps.query agrees with
    torch.cuda.get_device_properties; device_memory_stats counts the bytes
    of a GPT-2 124M Model build (bf16 params, f32 SR masters, flash); a
    profiling.trace around two of its train steps writes a Chrome trace
    naming K12's and K13's CUDA kernels (adamw_step_kernel, ce_fwd_kernel,
    ce_bwd_kernel); Timer.scope with sync= times two steps within 10 % of
    CUDA events around them (twice)."""
    from mila_tpu_torch.data.loader import ArrayReader
    from mila_tpu_torch.models.gpt2 import GPT2
    from mila_tpu_torch.models.model import Model, ModelConfig
    from mila_tpu_torch.runtime import (DeviceProps, default_context, device_memory_stats,
                                        get_device, set_default_context, tree_nbytes)
    from mila_tpu_torch.utils.profiling import Timer, trace

    set_default_context(None)
    dev = get_device("auto")
    if dev != torch.device("cuda", 0) or default_context().device != dev:
        raise AssertionError(f"runtime: get_device('auto') is {dev}, not cuda:0")
    props, want = DeviceProps.query(dev), torch.cuda.get_device_properties(0)
    got = (props.platform, props.kind, props.memory_bytes, props.num_cores,
           props.compute_capability)
    if got != ("gpu", want.name, want.total_memory, want.multi_processor_count,
               (want.major, want.minor)):
        raise AssertionError(f"runtime: DeviceProps {props} disagrees with {want}")
    before = device_memory_stats(dev)["bytes_in_use"]
    cfg = gpt2_config()
    B, T = 8, 1024
    model = Model(GPT2(cfg), train_optimizer(), ModelConfig(epochs=1, verbose=False,
                                                           prefetch_depth=0))
    model.build(torch.Generator(device="cuda").manual_seed(50), (B, T))
    torch.cuda.synchronize()
    stats = device_memory_stats(dev)
    built = tree_nbytes([model.params, model.opt_state.m, model.opt_state.v,
                         model.opt_state.master])
    if not (stats["allocated_bytes.all.current"] > 0
            and stats["bytes_in_use"] - before >= built):
        raise AssertionError(f"runtime: device_memory_stats counts {stats['bytes_in_use']} "
                             f"bytes in use, {before} before a build of {built}")
    base = rng.integers(0, cfg.vocab_size, (4, T + 1)).astype(np.int32)
    data = base[rng.integers(0, 4, 2 * B)]
    reader = ArrayReader(data[:, :-1], data[:, 1:], B, seed=0)
    model.train(reader)  # warm
    trace_dir = Path(tmp) / "trace"
    with trace(str(trace_dir)):
        model.train(reader)
        torch.cuda.synchronize()
    files = sorted(trace_dir.glob("*.pt.trace.json"))
    if len(files) != 1:
        raise AssertionError(f"runtime: trace wrote {len(files)} files")
    names = {e.get("name", "") for e in json.loads(files[0].read_text())["traceEvents"]}
    kernels = {k: sum(k in n for n in names) for k in ("adamw_step_kernel", "ce_fwd_kernel",
                                                       "ce_bwd_kernel")}
    if not all(kernels.values()):
        raise AssertionError(f"runtime: the trace's kernels miss K12 or K13: {kernels}")
    timer, rel = Timer(), []
    for i in range(2):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        with timer.scope(f"two steps {i}", sync=dev):
            model.train(reader)
        b.record()
        b.synchronize()
        ev = a.elapsed_time(b) / 1e3
        rel.append((timer.totals[f"two steps {i}"] - ev) / ev)
    if max(abs(r) for r in rel) > 0.1:
        raise AssertionError(f"runtime: Timer.scope and CUDA events differ by {rel}")
    out = {"device": str(dev), "props": dataclasses.asdict(props),
           "bytes_in_use_after_build": stats["bytes_in_use"], "built_tree_bytes": built,
           "trace_bytes": files[0].stat().st_size, "trace_event_names": len(names),
           "trace_kernels": kernels, "timer_ms": [1e3 * timer.totals[f"two steps {i}"]
                                                  for i in range(2)],
           "timer_vs_events": rel}
    del model
    torch.cuda.empty_cache()
    return out


EXAMPLES_DIR = Path(__file__).resolve().parent / "mila_tpu_torch" / "examples"


def run_example(name: str, argv: list, path=None, expected=None, cwd=None) -> dict:
    """mila_tpu_torch/examples/<name>.py's main() in-process (runpy, as
    tests/examples/test_examples_smoke.py runs JAX's), its stdout and its
    Logger lines captured; under run_counted(path, ..., expected) where
    ``path`` is given (its launch counts; no plain version may run). Fails
    unless the example exits 0. Returns its code, seconds, output, log
    lines and counts."""
    import contextlib
    import io
    import os
    import runpy

    from mila_tpu_torch.utils.logging import Logger

    script = EXAMPLES_DIR / f"{name}.py"
    logs, buf = [], io.StringIO()

    def body():
        old_argv, old_cwd = sys.argv, os.getcwd()
        sys.argv = [str(script), *argv]
        Logger.set_backend(lambda level, msg: logs.append(msg))
        try:
            if cwd:
                os.chdir(cwd)
            with contextlib.redirect_stdout(buf):
                runpy.run_path(str(script), run_name="__main__")
            return 0
        except SystemExit as e:
            return int(e.code or 0)
        finally:
            sys.argv = old_argv
            os.chdir(old_cwd)
            Logger.set_backend(None)

    t0 = time.monotonic()
    if path is None:
        code, counts = body(), None
    else:
        code, counts = run_counted(path, body, expected)
    wall = time.monotonic() - t0
    if code != 0:
        raise AssertionError(f"{path or name}: exited {code}\n{buf.getvalue()}\n" +
                             "\n".join(logs))
    return {"code": code, "wall_s": wall, "out": buf.getvalue(), "logs": logs,
            "counts": counts}


def example_line(card: str, label: str, run: dict, markers: dict, **extra) -> dict:
    """The phase's record of one example (``label``), printed at once: exit
    code, seconds, each marker found (all must be), launch counts."""
    missing = [m for m, ok in markers.items() if not ok]
    if missing:
        raise AssertionError(f"{label} lacks its markers {missing}:\n{run['out']}")
    line = {"code": run["code"], "wall_s": run["wall_s"], "markers": sorted(markers),
            "launches": run["counts"], "plain_ran": False, **extra}
    emit({"phase": "examples", "card": card, "example": label, **line})
    return line


def example_gpt2_train(rng, tmp: str, card: str) -> tuple[dict, dict]:
    """gpt2_train at GPT-2 124M's widths (f32 params; T 1024 is under
    FLASH_MIN_SEQ, so attention takes the plain product as JAX's example
    does) over llm.c shards written here: a stream of 4 fixed 1025-token
    sequences over the GPT-2 vocabulary, each ending in 50256 (so V 50257),
    20 steps, validation at steps 0 and 10 (4 batches), --quant-eval (int8,
    fp8 e4m3, int4: 8 batches each, bf16 params and quantized). Launches:
    per step the CE forward and backward, fused_adamw_step (one dtype
    group) and grad_clip_scale once; the CE forward once a validation or
    evaluation batch; quant_linear on the 4 projections of each layer per
    quantized batch (int4 at M 8192 is unpacked to int8 rows, as JAX's
    gate sends it). The loss must fall by 1 nat from step 0."""
    from mila_tpu_torch.data import write_token_file

    L, B, T, steps, val_every = 12, 8, 1024, 20, 10
    seqs = rng.integers(0, 50256, (4, T)).astype(np.int64)
    seqs = np.concatenate([seqs, np.full((4, 1), 50256)], axis=1)
    d = Path(tmp) / "shards"
    d.mkdir()
    write_token_file(d / "train_000.bin", seqs[rng.integers(0, 4, 200)].reshape(-1))
    write_token_file(d / "val_000.bin", seqs[rng.integers(0, 4, 72)].reshape(-1))
    val_batches = 4 * len(range(0, steps, val_every))
    quant_batches = 3 * 8
    expected = {"fused_softmax_cross_entropy": steps + val_batches + 2 * quant_batches,
                "fused_softmax_cross_entropy_bwd": steps, "fused_adamw_step": steps,
                "grad_clip_scale": steps, "quant_linear": 4 * L * quant_batches}
    run = run_example("gpt2_train", [
        "--shards", str(d / "train_*.bin"), "--val-shards", str(d / "val_*.bin"),
        "--layers", str(L), "--dim", "768", "--heads", "12", "--seq-len", str(T),
        "--batch-size", str(B), "--steps", str(steps), "--val-every", str(val_every),
        "--quant-eval"], "example gpt2_train", expected)
    first = next(float(m.split("train_loss=")[1].split()[0]) for m in run["logs"]
                 if m.startswith("step 0:"))
    last = float(run["out"].split("final train loss ")[1].split()[0])
    gates = [ln for ln in run["out"].splitlines() if ln.startswith("quantization gate [")]
    if not last <= first - 1.0:
        raise AssertionError(f"example gpt2_train: loss {first} -> {last}, not 1 nat lower")
    tok_s = float(run["out"].split("steps, ")[1].split(" tokens/sec")[0].replace(",", ""))
    markers = {"vocab 50257": any("vocab 50257" in m for m in run["logs"]),
               "final train loss": True, **{f"quantization gate [{q}]": any(
                   g.startswith(f"quantization gate [{q}]") for g in gates)
                   for q in ("int8", "fp8_e4m3", "int4")}}
    return run["counts"], example_line(card, "gpt2_train", run, markers, first_loss=first,
                                       final_loss=last, tokens_per_s=tok_s,
                                       quantization_gates=gates)


GENERATE_RUNS = {"bf16": [], "int8": ["--quantize", "int8"],
                 "fp8_e4m3": ["--quantize", "fp8_e4m3"], "speculative": ["--speculative-k", "4"]}
GENERATE_NEW = 64  # tokens a card run generates
GENERATE_CPU_NEW = 16  # tokens the CPU run of the same example generates
# The block weights' scale of gpt2_generate's checkpoint: GPT2.init's own
# draw gives near-constant greedy streams (9-15 distinct tokens in 64); x 3
# gives 34-48, each token within ERR_TOL's bound on the card and on the CPU
# (mila_tpu_torch/tools/generate_gaps.py). At x 4 bf16 arithmetic itself,
# the CPU's plain path too, goes past the bound.
GENERATE_BLOCK_SCALE = 3.0


def generate_argv(path: str, extra: list, new: int = GENERATE_NEW) -> list:
    return ["--checkpoint", path, "--tokens", str(new), "--temperature", "0", *extra]


def write_gpt2_124m(tmp: str, wte_scale: float = 1.0, block_scale: float = 1.0) -> str:
    """A GPT-2 124M llm.c checkpoint of seeded random weights
    (write_gpt2_checkpoint), for gpt2_generate: GPT2.init's draw, the
    token embedding (the tied head) times ``wte_scale`` and every block's
    projection weights times ``block_scale``."""
    import os

    from mila_tpu_torch.models.gpt2 import GPT2, GPT2Config
    from mila_tpu_torch.serialization import write_gpt2_checkpoint

    cfg = GPT2Config.gpt2_124m()
    path = os.path.join(tmp, f"gpt2_124M_{wte_scale:g}_{block_scale:g}.bin")
    params = GPT2(cfg).init(torch.Generator(device="cuda").manual_seed(51), (1, 32))
    params["encoder"]["wte"] *= wte_scale
    for i in range(cfg.num_layers):
        for _, keys in GPT2_PROJECTIONS:
            leaf = params[f"h{i}"]
            for k in keys:
                leaf = leaf[k]
            leaf["weight"] *= block_scale
    write_gpt2_checkpoint(path, cfg, params)
    return path


def dequantized_f32(tree):
    """A params tree in f32, each QTensor dequantized: a forward over it
    multiplies with plain f32 products and launches no kernel."""
    from mila_tpu_torch.inference.quantize import QTensor, dequantize

    if isinstance(tree, dict):
        return {k: dequantized_f32(v) for k, v in tree.items()}
    if isinstance(tree, QTensor):
        return dequantize(tree, torch.float32)
    return tree.float() if isinstance(tree, torch.Tensor) else tree


def teacher_forced(prompt: np.ndarray, ids: list, oracle, tol: float = ERR_TOL) -> dict:
    """Every token of greedy stream ``ids`` after ``prompt`` against the f32
    logits of one ``oracle`` forward over prompt + ids, teacher-forced on
    the stream's own prefixes: each token's gap below the largest logit
    over tol x max |logit| (a near-tie bound; at most 1 passes). Returns the
    tokens checked, how many were not the oracle's argmax, the largest
    ratio with its position, and the largest |logit|."""
    T0 = len(prompt)
    lg = oracle(np.concatenate([prompt, np.asarray(ids, np.int32)])).float()
    lg = lg[T0 - 1:T0 - 1 + len(ids)]
    top = lg.max(-1).values
    chosen = lg.gather(-1, torch.tensor(ids, device=lg.device)[:, None])[:, 0]
    over = ((top - chosen) / (tol * lg.abs().amax(-1))).cpu()
    at = int(over.argmax())
    return {"tokens_checked": len(ids), "not_argmax": int((top > chosen).sum()),
            "max_gap_over_tol": float(over[at]), "at": at,
            "max_abs_logit": float(lg.abs().max())}


def example_gpt2_generate(path: str, card: str, cpu_new: int = GENERATE_CPU_NEW,
                          gate: bool = True) -> tuple[dict, dict]:
    """gpt2_generate on GPT-2 124M from the llm.c checkpoint at ``path``
    (write_gpt2_124m: phase_examples scales its blocks by
    GENERATE_BLOCK_SCALE), 64 greedy tokens after 50256: bf16, --quantize int8,
    --quantize fp8_e4m3 (quant_linear on the 4 projections of each layer at
    the prefill and each of the 63 decode steps; the tied head and the
    contiguous cache's attention are plain, as in JAX's example) and
    --speculative-k 4 (bf16, a random 1-layer draft). Then the same runs
    in this process on a CPU context for ``cpu_new`` tokens, through every
    kernel's plain version. The oracle: the run's weights dequantized to
    f32 on the card, f32 products and attention, no kernel. Gates: every
    token of each card stream within ERR_TOL x max |logit| of the oracle's
    largest logit, teacher-forced (teacher_forced); the card's first
    ``cpu_new`` ids equal the CPU's or split only at a near-tie
    (check_streams). The CPU stream's own reading against the oracle
    (``cpu``) is the witness of what bf16 arithmetic does apart from the
    card. ``gate`` False records the readings and raises on none."""
    from mila_tpu_torch.inference.quantize import quantize_model_params
    from mila_tpu_torch.models.gpt2 import GPT2
    from mila_tpu_torch.runtime import ExecutionContext, default_context, set_default_context
    from mila_tpu_torch.serialization import read_gpt2_checkpoint, to_device_tree

    cfg, raw = read_gpt2_checkpoint(path)
    model, L, NEW = GPT2(cfg), cfg.num_layers, GENERATE_NEW
    prompt = np.array([50256], np.int32)
    runs, cpu = {}, {}
    for tag, extra in GENERATE_RUNS.items():
        expected = {"quant_linear": 4 * L * NEW} if tag in ("int8", "fp8_e4m3") else {}
        runs[tag] = run_example("gpt2_generate", generate_argv(path, extra),
                                f"example gpt2_generate {tag}", expected)
    context = default_context()
    set_default_context(ExecutionContext("cpu"))
    try:
        for tag, extra in GENERATE_RUNS.items():
            cpu[tag] = run_example("gpt2_generate", generate_argv(path, extra, cpu_new))
    finally:
        set_default_context(context)
    all_counts, lines, over = {}, {}, {}
    for tag, run in runs.items():
        ids, cpu_ids = [json.loads(r["out"].split("token ids: ")[1].splitlines()[0])[1:]
                        for r in (run, cpu[tag])]
        params = to_device_tree(raw, dtype=torch.bfloat16)
        if tag in ("int8", "fp8_e4m3"):
            params = quantize_model_params(params, tag)
        p32 = dequantized_f32(params)
        del params

        def oracle(seq):
            with torch.no_grad():
                return model.apply(p32, torch.from_numpy(seq)[None].cuda())[0, :, :cfg.vocab_size]

        label = f"example gpt2_generate {tag}"
        card_tf, cpu_tf = (teacher_forced(prompt, s, oracle) for s in (ids, cpu_ids))
        over[tag] = card_tf["max_gap_over_tol"]
        streams = check_streams(label, [prompt], [ids[:cpu_new]], [cpu_ids], oracle,
                                tol=ERR_TOL if gate else float("inf"))
        tok_s = float(run["out"].split("tokens in ")[1].split("(")[1].split(" tok/s")[0])
        markers = {"token ids:": True, f"generated {NEW} tokens": f"generated {NEW} tokens"
                   in run["out"]}
        if tag == "speculative":
            markers["speculative acceptance"] = "speculative acceptance" in run["out"]
        all_counts[label] = run["counts"]
        lines[tag] = example_line(card, f"gpt2_generate {tag}", run, markers,
                                  tokens_per_s=tok_s, cpu_wall_s=cpu[tag]["wall_s"],
                                  distinct_tokens=len(set(ids)), teacher_forced=card_tf,
                                  cpu={"tokens": cpu_new, **cpu_tf}, **streams)
        del p32
    bad = {tag: o for tag, o in over.items() if o > 1}
    if gate and bad:
        raise AssertionError(f"example gpt2_generate: a token past the near-tie bound "
                             f"(gap over bound, by run): {bad}")
    return all_counts, lines


# GPT-2 124M's four projections in a block's params (name, path).
GPT2_PROJECTIONS = (("c_attn", ("qkv",)), ("attn c_proj", ("proj",)),
                    ("c_fc", ("mlp", "fc1")), ("mlp c_proj", ("mlp", "fc2")))


def phase_examples_k1(bw, peak_ops, rng) -> list:
    """K1 (quant_linear) rows at the shapes the examples give it: GPT-2
    124M's four projections (768 x 2304, 768 x 768, 768 x 3072, 3072 x
    768), GPT2.init's weights quantized by quantize_model_params as the
    examples quantize them, one weight a layer. M 1 on bf16 activations,
    int8 and fp8 e4m3: gpt2_generate --quantize (its one-token prefill and
    every decode step). M 8192 on f32 activations, int8, fp8 e4m3 and int4
    (which the wrapper unpacks to int8 rows, as JAX's gate sends M 8192):
    gpt2_train --quant-eval's 8 x 1024 batches on f32 params. Each row held
    to quant_linear_plain on the same inputs under ERR_TOL."""
    from mila_tpu_torch.inference.quantize import quantize_model_params
    from mila_tpu_torch.models.gpt2 import GPT2, GPT2Config

    cfg = GPT2Config.gpt2_124m()
    dense = GPT2(cfg).init(torch.Generator(device="cuda").manual_seed(62), (1, 32))
    rows = []
    record = recorder(rows, bw, peak_ops)
    for wdtype, M, dtype in (("int8", 1, torch.bfloat16), ("fp8_e4m3", 1, torch.bfloat16),
                             ("int8", 8192, torch.float32), ("fp8_e4m3", 8192, torch.float32),
                             ("int4", 8192, torch.float32)):
        q = quantize_model_params(dense, wdtype)
        for name, keys in GPT2_PROJECTIONS:
            ws = []
            for i in range(cfg.num_layers):
                leaf = q[f"h{i}"]
                for k in keys:
                    leaf = leaf[k]
                ws.append(leaf["weight"])
            K = ws[0].packed_rows or ws[0].q.shape[0]
            x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)).cuda()
            prefill_row(record, f"gpt2 {name}", x.to(dtype), ws, wdtype)
        del q
    return rows


def phase_examples(rng, tmp: str, card: str):
    """The five example programs of mila_tpu_torch/examples on the card,
    in-process, each under its launch counts: gpt2_train at GPT-2 124M's
    widths (example_gpt2_train), mnist_train with its defaults
    (784-128-64-10, synthetic 12000, 5 epochs of batch 128: its exit code
    is its 97.5 % gate), charlm_train on the char_lm preset for 200 steps
    over a corpus written here (the perplexity and sample lines), viz_demo
    with --ppm-out (the file), and gpt2_generate at GPT-2 124M
    (example_gpt2_generate). Per step of the trainers: the CE
    forward and backward and fused_adamw_step once, grad_clip_scale where
    the example clips (charlm, gpt2_train)."""
    from mila_tpu_torch.data import MnistReader

    counts, out = {}, {}
    counts["example gpt2_train"], out["gpt2_train"] = example_gpt2_train(rng, tmp, card)

    steps = 5 * MnistReader(batch_size=128, split="train", synthetic_n=12000,
                            seed=42).num_batches
    run = run_example("mnist_train", [], "example mnist_train",
                      {k: v * steps for k, v in MNIST_STEP.items()})
    acc = float(run["out"].split("final test accuracy: ")[1].split("%")[0])
    sps = float(run["out"].split("training throughput: ")[1].split(" samples")[0]
                .replace(",", ""))
    counts["example mnist_train"] = run["counts"]
    out["mnist_train"] = example_line(
        card, "mnist_train", run, {"final test accuracy": True, "training throughput": True},
        accuracy_pct=acc, steps=steps, samples_per_s=sps)

    words = ["ROMEO:", "JULIET:", "the", "love", "night", "thou", "art", "sweet", "and",
             "my", "lord", "fair", "day", "o", "speak", "again", "\n"]
    corpus = Path(tmp) / "charlm" / "data" / "tinyshakespeare"
    corpus.mkdir(parents=True)
    (corpus / "input.txt").write_text(
        " ".join(words[i] for i in rng.integers(0, len(words), 60_000)))
    steps = 200
    run = run_example("charlm_train", ["--steps", str(steps)], "example charlm_train",
                      {"fused_softmax_cross_entropy": steps,
                       "fused_softmax_cross_entropy_bwd": steps,
                       "fused_adamw_step": steps, "grad_clip_scale": steps},
                      cwd=Path(tmp) / "charlm")
    ppl = float(run["out"].split("char perplexity ")[1].split()[0])
    tok_s = float(run["out"].split("throughput: ")[1].split(" tokens")[0].replace(",", ""))
    counts["example charlm_train"] = run["counts"]
    out["charlm_train"] = example_line(
        card, "charlm_train", run, {"perplexity": "perplexity" in run["out"],
                                    "sample": "--- sample ---\nROMEO:" in run["out"]},
        char_perplexity=ppl, tokens_per_s=tok_s)

    ppm = Path(tmp) / "w.ppm"
    steps = 3 * MnistReader(batch_size=128, synthetic_n=2048).num_batches
    run = run_example("viz_demo", ["--ppm-out", str(ppm)], "example viz_demo",
                      {k: v * steps for k, v in MNIST_STEP.items()})
    counts["example viz_demo"] = run["counts"]
    out["viz_demo"] = example_line(
        card, "viz_demo", run,
        {f"wrote {ppm}": f"wrote {ppm}" in run["out"],
         "ppm": ppm.exists() and ppm.read_bytes().startswith(b"P6 512 256 255\n")},
        ppm_bytes=ppm.stat().st_size)

    c, out["gpt2_generate"] = example_gpt2_generate(
        write_gpt2_124m(tmp, block_scale=GENERATE_BLOCK_SCALE), card)
    counts.update(c)
    return counts, out


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
    "rms_quant_linear_argmax": ("mila_tpu_torch/csrc/qgemv_int8.cu",
                                "mila_tpu/kernels/decode_fused.py:177 (_rms_qmm_argmax_kernel)"),
    "dense_decode_attention": ("mila_tpu_torch/csrc/dense_decode_attn.cu",
                               "mila_tpu/kernels/dense_attention.py:59 (_dense_kernel)"),
    "fused_decode_attention": ("mila_tpu_torch/csrc/dense_decode_attn.cu",
                               "mila_tpu/kernels/dense_attention.py:278 (_fused_kernel)"),
    "layer_tail_stream": ("mila_tpu_torch/csrc/layer_tail_int8.cu",
                          "mila_tpu/kernels/layer_stream.py:107 (_stream_kernel)"),
    "mlp_qkv_fused": ("mila_tpu_torch/csrc/layer_tail_int8.cu",
                      "mila_tpu/kernels/layer_fused.py:141 (_tail_kernel)"),
    "giga_decode_step": ("mila_tpu_torch/csrc/decode_step_int8.cu",
                         "mila_tpu/kernels/decode_giga.py:207 (_giga_kernel)"),
    "layer_megakernel": ("mila_tpu_torch/csrc/decode_step_int8.cu",
                         "mila_tpu/kernels/layer_mega.py:126 (_mega_kernel)"),
    "mlp_block_fused": ("mila_tpu_torch/csrc/layer_tail_int8.cu",
                        "mila_tpu/kernels/decode_mlp.py:136 (_mlp_mega_kernel)"),
    "quant_linear_int4": ("mila_tpu_torch/csrc/qgemv_int4.cu",
                          "mila_tpu/kernels/quant_matmul.py:244 (_qmm4_kernel)"),
    "flash_attention": ("mila_tpu_torch/csrc/flash_fwd.cu",
                        "mila_tpu/kernels/flash_attention.py:39 (_fa_kernel; _fa_kernel_t :114)"),
    "flash_attention_forward": ("mila_tpu_torch/csrc/flash_fwd.cu",
                                "mila_tpu/kernels/flash_attention.py:39 (_fa_kernel with "
                                "save_stats; _fa_kernel_t :114)"),
    "flash_attention_bwd": ("mila_tpu_torch/csrc/flash_bwd.cu",
                            "mila_tpu/kernels/flash_attention_bwd.py:43 (_dkv_kernel; "
                            "_dq_kernel :98)"),
    "fused_adamw_update": ("mila_tpu_torch/csrc/fused_adamw.cu",
                           "mila_tpu/kernels/fused_adamw.py:27 (_adamw_kernel)"),
    "fused_adamw_step": ("mila_tpu_torch/csrc/fused_adamw.cu",
                         "mila_tpu/kernels/fused_adamw.py:27 (_adamw_kernel, every leaf of "
                         "mila_tpu/optim/adamw.py:113 AdamW.step in one launch per dtype group)"),
    "grad_clip_scale": ("mila_tpu_torch/csrc/fused_adamw.cu",
                        "none: mila_tpu/optim/adamw.py:88 (global_norm, an XLA reduction; "
                        "the clip of AdamW.step :130)"),
    "fused_softmax_cross_entropy": ("mila_tpu_torch/csrc/softmax_ce.cu",
                                    "mila_tpu/kernels/softmax_ce.py:28 (_ce_fwd_kernel)"),
    "fused_softmax_cross_entropy_bwd": ("mila_tpu_torch/csrc/softmax_ce.cu",
                                        "mila_tpu/kernels/softmax_ce.py:41 (_ce_bwd_kernel)"),
}
# The shape whose numbers head each entry of the summary line.
PRIMARY = {"quant_linear": "wgu", "rms_quant_linear": "lm_head",
           "quant_linear_residual": "down", "rms_quant_linear_swiglu": "wgu",
           "paged_decode_attention": "B=8", "rms_quant_linear_argmax": "lm_head",
           "dense_decode_attention": "B=8", "fused_decode_attention": "B=8",
           "layer_tail_stream": "layer 7", "mlp_qkv_fused": "layer 0",
           "giga_decode_step": "L=16", "layer_megakernel": "layer 7",
           "mlp_block_fused": "layer 0", "quant_linear_int4": "wgu",
           "flash_attention": "B=1 T=4096", "flash_attention_forward": "B=8 T=1024",
           "flash_attention_bwd": "B=8 T=1024", "fused_adamw_update": "wte SR",
           "fused_adamw_step": "llama-3.2-1b", "grad_clip_scale": "llama-3.2-1b",
           "fused_softmax_cross_entropy": "M=8192", "fused_softmax_cross_entropy_bwd": "M=8192"}
# "none" reasons for the library yardstick, where no one PyTorch call computes it.
NO_LIBRARY = {
    "giga_decode_step": "none: no one call computes a whole decode step",
    "layer_megakernel": "none: no one call computes attention + cache write + layer tail",
    "mlp_block_fused": "none: no one call computes wo + RMSNorm + SwiGLU + down",
}


def only_flash_rows() -> int:
    """``--only flash_rows``: route_flash_rows alone, one JSON line a row."""
    from mila_tpu_torch.kernels import _build

    _build.build_all([n for n in _build.KERNELS if n.startswith("flash")])
    bw, peak_ops, _ = peaks(torch.cuda.get_device_name(0))
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = []
    route_flash_rows(recorder(rows, bw, peak_ops), rows)
    for row in rows:
        emit({"phase": "flash_rows", "card": card, **row})
    print(card, flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every phase's results to this JSON file")
    ap.add_argument("--only", choices=["flash_rows"],
                    help="flash_rows: build the flash sources and print only the flash rows off "
                         "the bf16 model paths (route_flash_rows), then exit; run it over another "
                         "tree's package to time two versions of the kernels on the same inputs")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    if args.only == "flash_rows":
        return only_flash_rows()
    from mila_tpu_torch import native
    from mila_tpu_torch.kernels import _build
    from mila_tpu_torch.models.llama import (Llama, LlamaConfig, pack_decode_giga,
                                             pack_decode_layers, pack_decode_megalayers,
                                             pack_decode_mlp)

    card = card_line()
    name = torch.cuda.get_device_name(0)
    bw, peak_ops, peak_key = peaks(name)
    t0 = time.monotonic()
    # The native IO library (g++) builds beside the kernels (nvcc).
    native_build = threading.Thread(target=native.get_lib)
    native_build.start()
    _build.build_all()
    native_build.join()
    header = {"phase": "header", "card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda, "build_s": time.monotonic() - t0,
              "native_io": native.available(),
              "peaks": {"bytes_per_s": bw, "bf16_ops_per_s": peak_ops, "part": peak_key}}
    emit(header)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    rng = np.random.default_rng(0)
    cfg = LlamaConfig.llama32_1b().replace(max_seq_len=512)
    t0 = time.monotonic()
    params = build_params(cfg, seed=0, device="cuda")
    packs = {"layer_stream": pack_decode_layers(params),
             "giga": pack_decode_giga(params, cfg),
             "mega": pack_decode_megalayers(params, cfg),
             "mlp": pack_decode_mlp(params)}
    if ("layer_stream" not in packs["layer_stream"] or "giga_pack" not in packs["giga"]
            or "mega_pack" not in packs["mega"]["h0"] or "mlp_pack" not in packs["mlp"]["h0"]):
        raise AssertionError("a decode pack did not pack Llama-3.2-1B")
    packed = packs["layer_stream"]
    params4 = build_params(cfg.replace(max_seq_len=4224), seed=2, device="cuda", dtype="int4")
    # Llama-3.2-1B FP8-E4M3 with an fp8 head (benchmarks/engine_bench.py's
    # --quantize fp8_e4m3), its packed stream and MLP packs.
    params8 = build_params(cfg, seed=3, device="cuda", dtype="fp8_e4m3")
    packed8, mlp8 = pack_decode_layers(params8), pack_decode_mlp(params8)
    mega8 = pack_decode_megalayers(params8, cfg)
    if ("layer_stream" not in packed8 or "mlp_pack" not in mlp8["h0"]
            or "mega_pack" not in mega8["h0"]):
        raise AssertionError("a decode pack did not pack Llama-3.2-1B in fp8")
    torch.cuda.synchronize()
    setup_s = time.monotonic() - t0

    rows = phase_kernels(params, packs, params4, cfg, bw, peak_ops, rng)
    emit({"phase": "kernels", "card": card, "rows": rows})
    rows8 = phase_kernels_fp8(params8, packed8, mlp8, mega8, cfg, bw, peak_ops)
    emit({"phase": "kernels fp8", "card": card, "rows": rows8})
    rows += rows8
    t_ph = time.monotonic()
    rows_pairs = phase_kernels_pairs(cfg, bw, peak_ops)
    emit({"phase": "kernels pairs", "card": card, "rows": rows_pairs,
          "phase_s": time.monotonic() - t_ph})
    rows += rows_pairs
    del mlp8
    crossover = phase_crossover(cfg, rng)
    emit({"phase": "crossover", "card": card, **crossover})
    parity = phase_parity(rng)
    emit({"phase": "parity", "card": card, **parity})
    parity8 = phase_parity(np.random.default_rng(14), "fp8_e4m3", seed=4, full=False)
    emit({"phase": "parity fp8", "card": card, **parity8})
    parity_long = phase_parity_long(rng)
    emit({"phase": "parity long", "card": card, **parity_long})
    model = Llama(cfg)
    decode = phase_decode(model, packed, cfg, rng, bw)
    emit({"phase": "decode", "card": card, "model": "llama-3.2-1b int8 + layer_stream, "
          "random weights", **decode})
    decode8 = phase_decode(model, packed8, cfg, np.random.default_rng(16), bw, "decode fp8")
    emit({"phase": "decode fp8", "card": card, "model": "llama-3.2-1b fp8 e4m3 + "
          "layer_stream, random weights", **decode8})
    del packed8
    mega8_run = phase_mega(model, mega8, cfg, np.random.default_rng(22), bw, "mega fp8")
    emit({"phase": "mega fp8", "card": card, "model": "llama-3.2-1b fp8 e4m3 + mega_pack, "
          "random weights", **mega8_run})
    del mega8
    giga = phase_giga(model, packs["giga"], cfg, rng, bw)
    emit({"phase": "giga", "card": card, "model": "llama-3.2-1b int8 + giga_pack, "
          "random weights", **giga})
    rows16, giga16 = phase_giga_bf16(cfg, bw, peak_ops)
    emit({"phase": "giga bf16", "card": card, "model": "llama-3.2-1b bf16 + giga_pack "
          "(bf16_stream=True), random weights", "rows": rows16, **giga16})
    rows += rows16
    mega = phase_mega(model, packs["mega"], cfg, rng, bw)
    emit({"phase": "mega", "card": card, "model": "llama-3.2-1b int8 + mega_pack, "
          "random weights", **mega})
    generate = phase_generate(model, params, cfg, rng)
    emit({"phase": "generate", "card": card, **generate})
    generate_mlp = phase_generate(model, packs["mlp"], cfg, rng, mlp=True)
    emit({"phase": "generate mlp", "card": card, **generate_mlp})
    del packs["mega"], packs["mlp"]
    torch.cuda.reset_peak_memory_stats()
    prompts = serve_prompts(cfg, rng)
    counts, c_counts, g_counts, serve = phase_serve(model, params, packed, packs["giga"], cfg,
                                                    rng, prompts)
    emit({"phase": "serve", "card": card, "model": "llama-3.2-1b int8, random weights",
          "setup_s": setup_s, **serve})
    f_counts, serve8 = phase_serve_fp8(model, params8, cfg, prompts, counts)
    emit({"phase": "serve fp8", "card": card, "model": "llama-3.2-1b fp8 e4m3 with an fp8 "
          "head, random weights", **serve8})
    t_ph = time.monotonic()
    sp_counts, serve_spec = phase_serve_spec(model, params, cfg, prompts)
    spp_counts = serve_spec.pop("plain_launches", None)
    emit({"phase": "serve spec", "card": card, "model": "llama-3.2-1b int8, draft llama-tiny "
          "bf16, random weights", **serve_spec, "phase_s": time.monotonic() - t_ph})
    t_ph = time.monotonic()
    ps_counts, parity_spec = phase_parity_spec(np.random.default_rng(31))
    emit({"phase": "parity spec", "card": card, **parity_spec,
          "phase_s": time.monotonic() - t_ph})
    del packs, packed, params, params8
    cfg4 = cfg.replace(max_seq_len=4224)
    l_counts, serve_long = phase_serve_long(Llama(cfg4), params4, cfg4, rng)
    emit({"phase": "serve long", "card": card, "model": "llama-3.2-1b int4, int8 KV pages, "
          "random weights", **serve_long})
    del params4, model
    torch.cuda.empty_cache()
    t_ph = time.monotonic()
    sg_counts, serve_gpt2 = phase_serve_gpt2(np.random.default_rng(32))
    emit({"phase": "serve gpt2", "card": card, "model": "gpt2-124m f32, bf16 pages, random "
          "weights through an llm.c checkpoint", **serve_gpt2,
          "phase_s": time.monotonic() - t_ph})
    t_ph = time.monotonic()
    pg_counts, parity_gpt2 = phase_parity_gpt2(np.random.default_rng(33))
    emit({"phase": "parity gpt2", "card": card, **parity_gpt2,
          "phase_s": time.monotonic() - t_ph})
    t_ph = time.monotonic()
    gg_counts, generate_gpt2 = phase_generate_gpt2(np.random.default_rng(34))
    emit({"phase": "generate gpt2", "card": card, "model": "gpt2-124m bf16, random weights",
          **generate_gpt2, "phase_s": time.monotonic() - t_ph})
    torch.cuda.empty_cache()
    train_rows = phase_train_kernels(bw, peak_ops, rng)
    emit({"phase": "kernels train", "card": card, "rows": train_rows})
    rows += train_rows
    parity_train = phase_parity_train(rng)
    emit({"phase": "parity train", "card": card, **parity_train})
    train_adamw_rows = []
    t_counts, e_counts, train = phase_train(peak_ops, rng,
                                            record=recorder(train_adamw_rows, bw, peak_ops))
    emit({"phase": "train", "card": card, "rows": train_adamw_rows, **train})
    rows += train_adamw_rows
    # GPT-2 in fp16 (SR masters as in train): the card against the CPU path
    # at 1 layer and T 512 (the CPU's half of the time), then 124M for 2
    # warm-up and 4 timed steps at T 1024; its loss falls as bf16's does
    # (PERF.md), so it is held to the same gate.
    parity_train16 = phase_parity_train(np.random.default_rng(20), "float16", T=512)
    emit({"phase": "parity train fp16", "card": card, **parity_train16})
    t16_counts, e16_counts, train16 = phase_train(peak_ops, np.random.default_rng(21), steps=6,
                                                  dtype="float16", full=False)
    emit({"phase": "train fp16", "card": card, **train16})
    # GPT-2 124M as shipped (f32 params) with flash attention: the tf32
    # family (f32 at D 64), card against CPU at 1 layer and T 512, then
    # 2 warm-up and 4 timed steps (its loss falls as bf16's does, PERF.md).
    parity_train32 = phase_parity_train(np.random.default_rng(24), "float32", T=512)
    emit({"phase": "parity train f32", "card": card, **parity_train32})
    t32_counts, e32_counts, train32 = phase_train(peak_ops, np.random.default_rng(25), steps=6,
                                                  dtype="float32", full=False)
    emit({"phase": "train f32", "card": card, **train32})
    torch.cuda.empty_cache()
    # Llama-3.2-1B trained through Model: its kernel rows, one layer card
    # against CPU, then the whole model at B 2, T 2048.
    t_ph = time.monotonic()
    llama_rows = phase_train_llama_kernels(bw, peak_ops)
    emit({"phase": "kernels train llama", "card": card, "rows": llama_rows,
          "phase_s": time.monotonic() - t_ph})
    rows += llama_rows
    t_ph = time.monotonic()
    parity_llama = phase_parity_train_llama(np.random.default_rng(44))
    emit({"phase": "parity train llama", "card": card, **parity_llama,
          "phase_s": time.monotonic() - t_ph})
    t_ph = time.monotonic()
    llama_adamw_rows = []
    tl_counts, el_counts, train_llama = phase_train_llama(
        peak_ops, np.random.default_rng(45), record=recorder(llama_adamw_rows, bw, peak_ops))
    emit({"phase": "train llama", "card": card, "rows": llama_adamw_rows, **train_llama,
          "phase_s": time.monotonic() - t_ph})
    rows += llama_adamw_rows
    torch.cuda.empty_cache()
    t_ph = time.monotonic()
    tm_counts, tmr_counts, mnist, mnist_rows, train_mnist = phase_train_mnist(
        bw, peak_ops, np.random.default_rng(40))
    emit({"phase": "train mnist", "card": card, "rows": mnist_rows, **train_mnist,
          "phase_s": time.monotonic() - t_ph})
    rows += mnist_rows
    t_ph = time.monotonic()
    tc_counts, tcr_counts, cnn_rows, train_cnn = phase_train_cnn(bw, peak_ops,
                                                                np.random.default_rng(43))
    emit({"phase": "train cnn", "card": card, "rows": cnn_rows, **train_cnn,
          "phase_s": time.monotonic() - t_ph})
    rows += cnn_rows
    with tempfile.TemporaryDirectory() as tmp:
        t_ph = time.monotonic()
        rm_counts, resume_mnist = phase_resume_mnist(mnist, tmp)
        emit({"phase": "resume mnist", "card": card, **resume_mnist,
              "phase_s": time.monotonic() - t_ph})
        t_ph = time.monotonic()
        rg_counts, resume_gpt2 = phase_resume_gpt2(np.random.default_rng(41), tmp)
        emit({"phase": "resume gpt2", "card": card, **resume_gpt2,
              "phase_s": time.monotonic() - t_ph})
        t_ph = time.monotonic()
        data = phase_data(np.random.default_rng(42), tmp)
        emit({"phase": "data", "card": card, **data, "phase_s": time.monotonic() - t_ph})
        del mnist
        torch.cuda.empty_cache()
        t_ph = time.monotonic()
        runtime = phase_runtime(np.random.default_rng(60), tmp)
        runtime_s = time.monotonic() - t_ph
        emit({"phase": "runtime", "card": card, **runtime, "runtime_s": runtime_s})
        t_ph = time.monotonic()
        ex_counts, examples = phase_examples(np.random.default_rng(61), tmp, card)
        examples_s = time.monotonic() - t_ph
        emit({"phase": "examples", "card": card, "examples_s": examples_s,
              "runtime_s": runtime_s, "paths": sorted(ex_counts)})
        t_ph = time.monotonic()
        ex_rows = phase_examples_k1(bw, peak_ops, np.random.default_rng(62))
        emit({"phase": "kernels examples", "card": card, "rows": ex_rows,
              "phase_s": time.monotonic() - t_ph})
        rows += ex_rows

    by_path = {"serve paged": counts, "serve contiguous": c_counts, "serve giga": g_counts,
               "serve fp8": f_counts,
               "decode prefill": decode["launches_prefill"], "decode": decode["launches"],
               "decode fp8 prefill": decode8["launches_prefill"],
               "decode fp8": decode8["launches"],
               "giga prefill": giga["launches_prefill"], "giga": giga["launches"],
               "giga bf16 prefill": giga16["launches_prefill"], "giga bf16": giga16["launches"],
               "mega prefill": mega["launches_prefill"], "mega": mega["launches"],
               "mega fp8 prefill": mega8_run["launches_prefill"],
               "mega fp8": mega8_run["launches"],
               "generate": generate["launches"], "generate mlp": generate_mlp["launches"],
               "serve long": l_counts, "train": t_counts, "evaluate": e_counts,
               "train fp16": t16_counts, "evaluate fp16": e16_counts,
               "train f32": t32_counts, "evaluate f32": e32_counts,
               "serve spec plain": spp_counts, "serve spec": sp_counts,
               **ps_counts, "serve gpt2": sg_counts, "parity gpt2": pg_counts,
               "generate gpt2": gg_counts, "train mnist": tm_counts,
               "train mnist rate": tmr_counts, "resume mnist": rm_counts,
               "resume gpt2": rg_counts, "train llama": tl_counts, "evaluate llama": el_counts,
               "train cnn": tc_counts, "train cnn rate": tcr_counts, **ex_counts}
    summary = []
    for entry, (source, replaces) in SOURCES.items():
        mine = [r for r in rows if r["entry"] == entry]
        top = next(r for r in mine if r["shape"].startswith(PRIMARY[entry])
                   and not str(r["wdtype"]).startswith("fp8"))
        launches = sum(c[entry] for c in by_path.values())
        summary.append({
            "name": entry, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": top["ms"], "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"], "library_ms": top["library_ms"],
            "library": NO_LIBRARY.get(entry, "timed" if top["library_ms"] is not None
                                      else "none: no one call computes it"),
            "shape": top["shape"], "wdtype": top["wdtype"],
            "wdtypes": sorted({r["wdtype"] for r in mine if r["wdtype"]}),
            "dtypes": sorted({r["dtype"] for r in mine if r.get("dtype")}),
            "launches_by_path": {p: c[entry] for p, c in by_path.items() if c[entry]},
            "shapes": mine})
        if entry.startswith("flash_attention"):  # rows of the tf32 and sync families too
            way = "bwd" if entry.endswith("bwd") else "fwd"
            summary[-1]["families"] = sorted({r["family"] for r in mine})
            summary[-1]["sources"] = sorted({SOURCES[entry][0]} | {
                f"mila_tpu_torch/csrc/flash_{r['family']}_{way}.cu"
                for r in mine if r["family"] in ("tf32", "sync")})
        if entry == "mlp_qkv_fused":
            summary[-1]["note"] = ("no model path calls this entry (the JAX package's only "
                                   "caller is bench.py's kernel check); its kernel runs on "
                                   "the decode path as layer_tail_stream")
        if entry == "fused_adamw_update":
            summary[-1]["note"] = ("JAX's per-leaf entry: AdamW.step launches the same kernel "
                                   "through fused_adamw_step, once per dtype group a step")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"header": header, "kernels": rows, "crossover": crossover,
                       "parity": parity, "parity_fp8": parity8, "parity_long": parity_long,
                       "decode": decode, "decode_fp8": decode8,
                       "giga": giga, "giga_bf16": giga16, "mega": mega, "mega_fp8": mega8_run,
                       "generate": generate,
                       "generate_mlp": generate_mlp, "serve": serve, "serve_fp8": serve8,
                       "serve_long": serve_long,
                       "parity_train": parity_train, "train": train,
                       "parity_train_fp16": parity_train16, "train_fp16": train16,
                       "parity_train_f32": parity_train32, "train_f32": train32,
                       "serve_spec": serve_spec, "parity_spec": parity_spec,
                       "serve_gpt2": serve_gpt2, "parity_gpt2": parity_gpt2,
                       "generate_gpt2": generate_gpt2, "train_mnist": train_mnist,
                       "resume_mnist": resume_mnist, "resume_gpt2": resume_gpt2, "data": data,
                       "parity_train_llama": parity_llama, "train_llama": train_llama,
                       "train_cnn": train_cnn, "runtime": runtime, "runtime_s": runtime_s,
                       "examples": examples, "examples_s": examples_s,
                       "summary": summary,
                       "total_s": time.monotonic() - T_START}, f, indent=1)
    emit({"kernels": summary})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
