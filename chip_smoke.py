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
  parity   Llama-3.2-1B widths at 2 layers, int8, kernels on the card against
           the same weights through the plain path on the CPU: the paged
           prefill of 8 prompts and 8 decode steps; the contiguous prefill
           (forward_with_cache) and 8 greedy_step_with_cache steps, with
           pack_decode_layers params and without;
  decode   the full 16-layer Llama-3.2-1B int8 with pack_decode_layers at the
           JAX bench's decode shape (B 8, prompt 128, cache 512): prefill, 64
           greedy_step_with_cache steps (ms/step eager and as a CUDA-graph
           replay of one step, tok/s, the step's byte bound);
  generate Generator.generate on the unpacked int8 params (B 8, 64-token
           prompts, 16 new tokens);
  serve    the full 16-layer Llama-3.2-1B int8 (random weights from a seed)
           served by the engine: 16 requests, 32 new tokens each, max_batch
           8, max_len 512, buckets (32, 64, 128), greedy; three identical
           paged runs (medians reported) and one contiguous-layout run on
           the packed params; one paged decode step timed eagerly and as a
           CUDA-graph replay.

On every path (decode prefill, decode, generate, each serve run) the
launch counts are set to 0 just before it and must equal, just after it,
the counts the path implies for all ten entry points (0 for those it does
not reach), and no plain version may run. Then the kernel summary line
({"kernels": [...]}), the card line, and as the last line
{"ok": true, "device": {...}}. Imports only torch, numpy, the standard
library and mila_tpu_torch.
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
    """(max |got - want|, max |want|)."""
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError("kernel output is not finite")
    return (got - want).abs().max().item(), want.abs().max().item()


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
    if isinstance(tree, tuple):  # LayerStream: tensors and int fields
        return type(tree)(*(v.cpu() if isinstance(v, torch.Tensor) else v for v in tree))
    return tree.cpu()


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

def phase_kernels(params, packed, cfg, bw, peak_ops, rng):
    from mila_tpu_torch.inference.kv_cache import make_paged_pools
    from mila_tpu_torch.inference.quantize import dequantize
    from mila_tpu_torch.kernels import decode_fused as df
    from mila_tpu_torch.kernels import dense_attention as da
    from mila_tpu_torch.kernels import layer_fused as lf
    from mila_tpu_torch.kernels import layer_stream as ls
    from mila_tpu_torch.kernels import paged_attention as pa
    from mila_tpu_torch.kernels import quant_matmul as qm
    from mila_tpu_torch.models.llama import Llama

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

    def record(entry, shape, err, ref, calls, plain, library, nbytes, nops, **extra):
        if err > ERR_TOL * ref:
            raise AssertionError(f"{entry}[{shape}]: max abs err {err} > {ERR_TOL} x {ref}")
        b_ms, b_by = bound(nbytes, nops, bw, peak_ops)
        rows.append({"entry": entry, "shape": shape, "max_abs_err": err,
                     "tolerance": ERR_TOL * ref, "ms": time_graph(calls),
                     "plain_ms": time_eager(plain),
                     "library_ms": None if library is None else time_graph(library),
                     "bound_ms": b_ms, "bound_by": b_by, **extra})

    # quant_linear at prefill: M = max_batch * largest bucket = 1024 rows.
    M = 8 * 128
    for name in ("wgu", "down"):
        K, N = LAYER_SHAPES[name]
        x = rand(M, K)
        ws = [blk[name]["weight"] for blk in layers]
        w_bf = [dequantize(w, bf16) for w in ws[:copies(K * N * 2)]]
        got = qm.quant_linear(x, ws[0])
        want = qm.quant_linear_plain(x, ws[0])
        record("quant_linear", f"{name} M={M}", *max_err(got, want),
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
        record(entry, f"{name} M={M}", *max_err(fn(*args), plain(*args)), calls,
               lambda: plain(*args), library, nbytes, 2 * M * K * ldq)
        del w_bf

    # The greedy head: norm_f -> lm_head -> argmax at M = 8. The check: the
    # kernel's token carries a plain logit within tolerance of the row's
    # largest (f32 sums in another order may swap near-ties).
    K, N = head.q.shape
    V = cfg.vocab_size
    x = rand(M, K)
    tok = df.rms_quant_linear_argmax(x, gam[0], head, vocab_size=V)
    want_tok = df.rms_quant_linear_argmax_plain(x, gam[0], head, vocab_size=V)
    logits = qm.scaled_partials(df._rms_scaled(x, gam[0], cfg.rms_eps), head)[:, :V]
    gap = (logits.max(dim=-1).values - logits.gather(1, tok.long())[:, 0]).abs().max().item()
    record("rms_quant_linear_argmax", f"lm_head M={M}", gap, logits.abs().max().item(),
           [lambda: df.rms_quant_linear_argmax(x, gam[0], head, vocab_size=V)],
           lambda: df.rms_quant_linear_argmax_plain(x, gam[0], head, vocab_size=V), None,
           K * N + N * 4 + M * K * 2 + K * 4 + M * 4, 2 * M * K * N,
           token_agreement=float((tok == want_tok).float().mean()))
    del logits

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
           live * KD * 2 * 2 + 2 * B * NQ * 2 + B * 4, 4 * live * NH * HD)
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
                   "v_cache": errs[3][0]})
    del caches, kg, vg, kp, vp

    # The layer tail over the packed stream: a middle layer (cycling over
    # layers 0..L-2 for the timing) and the last layer; mlp_qkv_fused over
    # per-layer pack views of the same stream.
    stream = packed["layer_stream"]
    H, I, bn = stream.h_dim, stream.i_dim, stream.bn
    Nq = stream.n_qkv * bn
    att, x = rand(M, 1, H), rand(M, 1, H)
    g1, g2 = gam[1], gam[2]
    n_full = stream.n_wo + stream.n_gu + stream.n_down + stream.n_qkv
    ops_tail = 2 * M * (H * H + 3 * H * I)

    def tail_bytes(n_tiles, nq):
        return (n_tiles * (H * bn + bn * 4) + 2 * M * H * 2 + 2 * H * 4 + M * H * 2
                + M * nq * 2)

    def tail_err(got, want):
        errs = [max_err(g, w) for g, w in zip(got, want) if g is not None]
        return max(errs, key=lambda e: e[0] / e[1])

    mid = L // 2 - 1
    views = [ls._pack_view(stream, i, False) for i in range(L - 1)]
    got = ls.layer_tail_stream(att, x, g1, stream, mid, g2)
    want = lf.tail_plain(att[:, 0], x[:, 0], g1, views[mid], g2, eps=cfg.rms_eps)
    record("layer_tail_stream", f"layer {mid} M={M}",
           *tail_err((got[0][:, 0], got[1][:, 0]), want),
           [lambda i=i: ls.layer_tail_stream(att, x, g1, stream, i, g2) for i in range(L - 1)],
           lambda: lf.tail_plain(att[:, 0], x[:, 0], g1, views[mid], g2, eps=cfg.rms_eps),
           None, tail_bytes(n_full, Nq), ops_tail + 2 * M * H * Nq)
    last = ls._pack_view(stream, L - 1, True)
    got = ls.layer_tail_stream(att, x, g1, stream, L - 1, None)
    want = lf.tail_plain(att[:, 0], x[:, 0], g1, last, g2, eps=cfg.rms_eps)
    record("layer_tail_stream", f"layer {L - 1} (last) M={M}",
           *tail_err((got[0][:, 0],), want[:1]),
           [lambda: ls.layer_tail_stream(att, x, g1, stream, L - 1, None)],
           lambda: lf.tail_plain(att[:, 0], x[:, 0], g1, last, g2, eps=cfg.rms_eps),
           None, tail_bytes(n_full - stream.n_qkv, 0), ops_tail)
    got = lf.mlp_qkv_fused(att, x, g1, views[0], g2)
    want = lf.tail_plain(att[:, 0], x[:, 0], g1, views[0], g2, eps=cfg.rms_eps)
    record("mlp_qkv_fused", f"layer 0 M={M}", *tail_err((got[0][:, 0], got[1][:, 0]), want),
           [lambda v=v: lf.mlp_qkv_fused(att, x, g1, v, g2) for v in views],
           lambda: lf.tail_plain(att[:, 0], x[:, 0], g1, views[0], g2, eps=cfg.rms_eps),
           None, tail_bytes(n_full, Nq), ops_tail + 2 * M * H * Nq)
    torch.cuda.synchronize()
    return rows


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


def phase_parity(rng):
    from mila_tpu_torch.models.llama import Llama, LlamaConfig, pack_decode_layers

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
    # compares logits.
    packed = pack_decode_layers(params)
    cpu_packed = to_cpu(packed)
    T0, V = 16, cfg.vocab_size
    prompt = torch.from_numpy(rng.integers(0, V, (B, T0)).astype(np.int32))
    agree = {}
    for variant, gp, cp in (("packed", packed, cpu_packed), ("unpacked", params, cpu_params)):
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
    del params, cpu_params, packed, cpu_packed
    return {"layers": cfg.num_layers, "tolerance": f"max|d| <= {ERR_TOL} x max|ref| "
            "or min cosine >= 0.999", "steps": steps,
            "greedy_agree_mean": float(np.mean([s["greedy_agree"] for s in steps
                                                if "row" not in s["what"]])),
            "greedy_step_token_agreement": agree}


# ---------------------------------------------------------------------------
# decode and generate (the contiguous cache)
# ---------------------------------------------------------------------------

def phase_decode(model, packed, cfg, rng, bw):
    """The JAX bench's decode shape on the packed params: prefill, then 64
    greedy_step_with_cache steps; launch counts per path."""
    from mila_tpu_torch.models.llama import decode_step_bytes

    B, P, C, STEPS, L = 8, 128, 512, 64, cfg.num_layers
    V = cfg.vocab_size
    prompt = torch.from_numpy(rng.integers(0, V, (B, P)).astype(np.int32)).cuda()
    cache = model.init_kv_cache(B, C, torch.bfloat16)
    t0 = time.monotonic()
    (logits, cache), pre_counts = run_counted(
        "decode prefill", lambda: model.forward_with_cache(packed, prompt, cache, 0),
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
    _, counts = run_counted("decode", loop, {
        "rms_quant_linear": STEPS, "fused_decode_attention": STEPS * L,
        "layer_tail_stream": STEPS * L, "rms_quant_linear_argmax": STEPS})
    wall = time.monotonic() - t0
    toks = torch.cat(out, dim=1)
    if toks.shape != (B, STEPS) or int(toks.min()) < 0 or int(toks.max()) >= V:
        raise AssertionError("decode: tokens outside the vocabulary")

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


def phase_generate(model, params, cfg, rng):
    """Generator.generate on the unpacked int8 params: the dense decode
    attention with the decode weight streams."""
    from mila_tpu_torch.inference.generator import Generator

    B, T0, NEW, L = 8, 64, 16, cfg.num_layers
    V = cfg.vocab_size
    prompt = rng.integers(0, V, (B, T0)).astype(np.int32)
    gen = Generator(model, params, max_len=T0 + NEW)
    steps = NEW - 1
    t0 = time.monotonic()
    out, counts = run_counted("generate", lambda: gen.generate(prompt, NEW), {
        "quant_linear": 4 * L + 1, "rms_quant_linear": steps * (L + 1),
        "quant_linear_residual": steps * 2 * L, "rms_quant_linear_swiglu": steps * L,
        "dense_decode_attention": steps * L})
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

def serve_once(model, params, cfg, prompts, layout: str):
    """One serving run on a fresh engine; checks outputs and launch counts."""
    from mila_tpu_torch.inference.engine import EngineConfig, InferenceEngine

    engine = InferenceEngine(model, params, EngineConfig(
        max_batch=8, max_len=512, prefill_buckets=(32, 64, 128), cache_dtype="bfloat16",
        page_size=128, kv_layout=layout))
    L = cfg.num_layers

    def expected(_):
        st = engine.stats
        it, groups = st["decode_iters"], st["prefill_groups"]
        if layout == "paged":
            return {"quant_linear": 4 * L * groups, "rms_quant_linear": (L + 1) * it + groups,
                    "quant_linear_residual": 2 * L * it, "rms_quant_linear_swiglu": L * it,
                    "paged_decode_attention": L * it}
        # One prefill per request at its bucket: <= 32 rows take the decode
        # streams (head included), more rows quant_linear over every row.
        small = sum(len(p) <= 32 for p in prompts)
        big = len(prompts) - small
        return {"quant_linear": (4 * L + 1) * big,
                "rms_quant_linear": (L + 1) * small + 2 * it,
                "quant_linear_residual": 2 * L * small, "rms_quant_linear_swiglu": L * small,
                "fused_decode_attention": L * it, "layer_tail_stream": L * it}

    def run():
        reqs = [engine.submit(p, max_new_tokens=32) for p in prompts]
        engine.run()
        return reqs

    t0 = time.monotonic()
    reqs, counts = run_counted(f"serve {layout}", run, expected)
    wall = time.monotonic() - t0
    for r in reqs:
        if not (r.done and len(r.output) == 32 and all(0 <= t < cfg.vocab_size
                                                       for t in r.output)):
            raise AssertionError(f"request {r.id} did not finish with 32 valid tokens")
    st = engine.stats
    it, groups = st["decode_iters"], st["prefill_groups"]
    ttft = sorted(r.ttft_s for r in reqs)
    tokens = sum(len(r.output) for r in reqs)
    return counts, {
        "layout": layout, "new_tokens": tokens, "wall_s": wall, "tok_s": tokens / wall,
        "ttft_p50_ms": 1e3 * float(np.percentile(ttft, 50)),
        "ttft_p95_ms": 1e3 * float(np.percentile(ttft, 95)),
        "decode_ms_per_step": 1e3 * st["t_decode_s"] / it, "decode_steps": it,
        "prefill_groups": groups, "prefill_s": st["t_prefill_s"],
        "launches_per_decode_step": {k: v / it for k, v in counts.items()
                                     if v and k != "quant_linear"},
    }


def decode_step_times(model, params, cfg, rng):
    """One 8-row paged decode step (forward_paged_ragged + argmax) timed
    eagerly and as a CUDA-graph replay: the difference is what the host adds."""
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


def phase_serve(model, params, packed, cfg, rng, repeats: int = 3):
    """``repeats`` identical paged serving runs (the host clock varies
    between runs more than the device does; medians plus every run), then
    one contiguous-layout run of the same requests on the packed params."""
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(8, 101, 16)]
    runs = []
    for _ in range(repeats):
        counts, run = serve_once(model, params, cfg, prompts, "paged")
        runs.append(run)
    med = {k: float(np.median([r[k] for r in runs]))
           for k in ("tok_s", "ttft_p50_ms", "ttft_p95_ms", "decode_ms_per_step", "wall_s")}
    c_counts, contiguous = serve_once(model, packed, cfg, prompts, "contiguous")
    return counts, c_counts, {
        "requests": len(prompts), **med, "launches": counts,
        "launches_per_decode_step": runs[-1]["launches_per_decode_step"],
        **decode_step_times(model, params, cfg, rng),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "runs": runs,
        "contiguous": {**contiguous, "launches": c_counts}}


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
}
# The shape whose numbers head each entry of the summary line.
PRIMARY = {"quant_linear": "wgu", "rms_quant_linear": "lm_head",
           "quant_linear_residual": "down", "rms_quant_linear_swiglu": "wgu",
           "paged_decode_attention": "B=8", "rms_quant_linear_argmax": "lm_head",
           "dense_decode_attention": "B=8", "fused_decode_attention": "B=8",
           "layer_tail_stream": "layer 7", "mlp_qkv_fused": "layer 0"}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every phase's results to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    from mila_tpu_torch.kernels import _build
    from mila_tpu_torch.models.llama import Llama, LlamaConfig, pack_decode_layers

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
    packed = pack_decode_layers(params)
    if "layer_stream" not in packed:
        raise AssertionError("pack_decode_layers did not pack Llama-3.2-1B")
    torch.cuda.synchronize()
    setup_s = time.monotonic() - t0

    rows = phase_kernels(params, packed, cfg, bw, peak_ops, rng)
    emit({"phase": "kernels", "card": card, "rows": rows})
    parity = phase_parity(rng)
    emit({"phase": "parity", "card": card, **parity})
    model = Llama(cfg)
    decode = phase_decode(model, packed, cfg, rng, bw)
    emit({"phase": "decode", "card": card, "model": "llama-3.2-1b int8 + layer_stream, "
          "random weights", **decode})
    generate = phase_generate(model, params, cfg, rng)
    emit({"phase": "generate", "card": card, **generate})
    torch.cuda.reset_peak_memory_stats()
    counts, c_counts, serve = phase_serve(model, params, packed, cfg, rng)
    emit({"phase": "serve", "card": card, "model": "llama-3.2-1b int8, random weights",
          "setup_s": setup_s, **serve})

    by_path = {"serve paged": counts, "serve contiguous": c_counts,
               "decode prefill": decode["launches_prefill"], "decode": decode["launches"],
               "generate": generate["launches"]}
    summary = []
    for entry, (source, replaces) in SOURCES.items():
        mine = [r for r in rows if r["entry"] == entry]
        top = next(r for r in mine if r["shape"].startswith(PRIMARY[entry]))
        launches = sum(c[entry] for c in by_path.values())
        summary.append({
            "name": entry, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": top["ms"], "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"], "library_ms": top["library_ms"],
            "shape": top["shape"],
            "launches_by_path": {p: c[entry] for p, c in by_path.items() if c[entry]},
            "shapes": mine})
        if entry == "mlp_qkv_fused":
            summary[-1]["note"] = ("no model path calls this entry (the JAX package's only "
                                   "caller is bench.py's kernel check); its kernel runs on "
                                   "the decode path as layer_tail_stream")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"header": header, "kernels": rows, "parity": parity, "decode": decode,
                       "generate": generate, "serve": serve, "summary": summary,
                       "total_s": time.monotonic() - t_start}, f, indent=1)
    emit({"kernels": summary})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
