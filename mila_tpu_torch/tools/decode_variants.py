"""Time variants of three decode kernels on the GPU at the smoke shapes.

    python -m mila_tpu_torch.tools.decode_variants dense [--variants committed min64]
        [--shapes B8 B1] [--splits 1 3 9]
    python -m mila_tpu_torch.tools.decode_variants int4 [--shapes wqkv wgu head]
        [--m 8] [--ksplits 1 2 4] [--variants no_convert no_mma loads_only]
        [--source before=path/to/qgemv_int4.cu]
    python -m mila_tpu_torch.tools.decode_variants int8 [--shapes wqkv wo head_argmax]
        [--m 8] [--ksplits 1 2 4] [--variants no_loop no_stream no_pdl]
        [--source before=path/to/qgemv_int8.cu]

``dense``: the contiguous-cache decode attention (``csrc/dense_decode_attn.cu``)
at Llama-3.2-1B's heads (NH 32, NKV 8, HD 64, bf16): B 8 at lengths 129-192
of a 512-row cache (the bench's decode shape) and B 1 at 4096 rows of a
4096-row cache. Each variant is a copy of the source (and its headers) with
edits, compiled with the package's nvcc flags into ``csrc/build/``:
``committed`` (none), ``min64`` / ``min128`` (at least 64 / 128 tokens a
split instead of 32); ``no_scores``,
``no_values``, ``no_math`` (a chunk's q.k products, its P.V products, or
both, dropped: wrong by design, timed only). ``--splits``: numbers of
splits to try besides the planner's. One JSON line per shape, variant and
split count: the ms of a dense and of a fused call and the largest
difference from the committed library at the planner's splits.

``int4``: the int4 GEMV (``csrc/qgemv_int4.cu``, the committed source) at
Llama-3.2-1B's int4 projections and head (random packed weights,
per-channel scales, M rows of bf16 x): per shape one JSON line with the ms
at the planner's K-split and at each of ``--ksplits`` that the kernel can
take, each one's largest difference from the planner's output, the same at
the planner's split for each variant (``no_convert``: the nibbles go to the
mma unconverted; ``no_mma``: the products dropped; ``loads_only``: both;
wrong by design, timed only; ``bn128``: 4 warps and 128 columns a block;
``nst12``: a 12-stage ring) and each ``--source`` (another qgemv_int4.cu
with the same C interface, e.g. an earlier commit's from ``git show``), and
``torch.matmul`` on a bf16 weight of the same shape.

``int8``: the int8 GEMV (``csrc/qgemv_int8.cu``) at Llama-3.2-1B's int8
decode shapes, each in its own mode (wqkv and the head: RMSNorm + store; wo
and down: + residual; wgu: SwiGLU; head_argmax: the argmax head), random
weights, per-channel scales, M rows of bf16 x: the same row per shape as
``int4``, with the variants ``no_convert``, ``no_mma``, ``loads_only`` (as
``int4``), ``no_stream`` (no weight copies), ``no_loop`` (the main loop
dropped: launch, prologue and epilogue), ``no_xstage`` and ``no_prologue``
(x not staged; nor the RMSNorm pass), ``no_pdl`` (a plain launch),
``nst4`` / ``nst8`` (ring stages), ``sr32`` (32-row stages) and ``bn128``
(4 warps, 128 columns a block).

Times: a CUDA graph of one call per distinct copy of the inputs (caches or
weights, cycling past the 50 MB L2), replayed 7 times between CUDA events,
median. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import statistics
import subprocess

import torch

from mila_tpu_torch.kernels import _build
from mila_tpu_torch.kernels import decode_fused as df
from mila_tpu_torch.kernels import dense_attention as da
from mila_tpu_torch.kernels import quant_matmul as qm

SRC = "dense_decode_attn.cu"
VARIANTS = {  # name -> [(file, old text, new text)]
    "committed": [],
    "min64": [(SRC, "constexpr int MIN_TOKENS = 32;", "constexpr int MIN_TOKENS = 64;")],
    "min128": [(SRC, "constexpr int MIN_TOKENS = 32;", "constexpr int MIN_TOKENS = 128;")],
    "no_scores": [(SRC, "    if (valid) {\n      float kv[DH];",
                   "    if (false) {\n      float kv[DH];")],
    "no_values": [(SRC, "for (int jj = 0; jj < SPAN; jj += 4) {",
                   "for (int jj = 0; jj < 0; jj += 4) {")],
}
VARIANTS["no_math"] = VARIANTS["no_scores"] + VARIANTS["no_values"]
SHAPES = {"B8": (8, 512, (129, 193)), "B1": (1, 4096, (4096, 4097))}  # B, T, lengths [lo, hi)
NH, NKV, HD, COPIES = 32, 8, 64, 16
INT4_SHAPES = {"wqkv": (2048, 3072), "wo": (2048, 2048), "wgu": (2048, 16384),
               "down": (8192, 2048), "head": (2048, 128256)}


def build(names) -> dict:
    """Compile a copy of the dense source per variant with its edits applied
    (the headers copied beside it), one nvcc each, all at once."""
    procs = {}
    for name in names:
        vdir = _build.BUILD_DIR / f"dense_variant_{name}"
        vdir.mkdir(parents=True, exist_ok=True)
        texts = {f.name: f.read_text() for f in [_build.CSRC / SRC, *_build.CSRC.glob("*.cuh")]}
        for fname, old, new in VARIANTS[name]:
            if old not in texts[fname]:
                raise RuntimeError(f"variant {name}: {fname} no longer has {old!r}")
            texts[fname] = texts[fname].replace(old, new)
        for fname, text in texts.items():
            (vdir / fname).write_text(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(vdir / "libdense.so"), str(vdir / SRC)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0].decode()
        if proc.returncode:
            raise RuntimeError(f"variant {name}: nvcc failed\n{log[-3000:]}")
        lib = ctypes.CDLL(str(_build.BUILD_DIR / f"dense_variant_{name}" / "libdense.so"))
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.dense_decode_attn.argtypes = [vp] * 9 + [ci] * 6 + [cf, ci, vp]
        lib.dense_decode_attn.restype = ci
        lib.fused_decode_attn.argtypes = [vp] * 12 + [ci] * 6 + [cf, ci, vp]
        lib.fused_decode_attn.restype = ci
        libs[name] = lib
    return libs


def graph_ms(calls, reps: int = 7) -> float:
    """ms per call: the calls captured in one CUDA graph, replayed ``reps``
    times between CUDA events (median)."""
    for c in calls:
        c()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for c in calls:
            c()
    g.replay()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / len(calls))
    return statistics.median(out)


def check(rc: int, what: str) -> None:
    if rc:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def dense(args) -> None:
    libs = build(sorted(set(args.variants) | {"committed"}))  # the reference for max_diff
    gen = torch.Generator(device="cuda").manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    KD, NQ = NKV * HD, NH * HD
    scale = 1.0 / math.sqrt(HD)
    for shape in args.shapes:
        B, T, (lo, hi) = SHAPES[shape]
        caches = [(torch.randn(B, T, NKV, HD, device=dev, generator=gen).to(bf16),
                   torch.randn(B, T, NKV, HD, device=dev, generator=gen).to(bf16))
                  for _ in range(COPIES)]
        lens = torch.randint(lo, hi, (B,), device=dev, generator=gen, dtype=torch.int32)
        old = lens - 1
        q = torch.randn(B, NH, HD, device=dev, generator=gen).to(bf16)
        qkv = torch.randn(B, NQ + 2 * KD, device=dev, generator=gen).to(bf16)
        ang = torch.rand(B, HD // 2, device=dev, generator=gen) * 6.3
        cos_t = torch.cat([ang.cos(), ang.cos()], -1).repeat(1, NKV).contiguous()
        sin_t = torch.cat([-ang.sin(), ang.sin()], -1).repeat(1, NKV).contiguous()
        out = torch.empty(B, NH, HD, device=dev, dtype=bf16)
        k_new = torch.empty(B, KD, device=dev, dtype=bf16)
        plan = da.plan_splits(B, NKV, T, sms)
        ref = None
        for S in [plan] + sorted({s for s in args.splits if s and s != plan}):
            o_part = torch.empty(B, NH, S, HD, device=dev)
            ml = torch.empty(2, B, NH, S, device=dev)
            cnt = torch.zeros(B * NKV, device=dev, dtype=torch.int32)
            scratch = [_build.ptr(o_part), _build.ptr(ml[0]), _build.ptr(ml[1]), _build.ptr(cnt)]
            for v in ["committed"] + [x for x in args.variants if x != "committed"]:
                lib = libs[v]

                def dense_call(k, vv, lib=lib, scratch=scratch, S=S, v=v):
                    check(lib.dense_decode_attn(
                        _build.ptr(q), _build.ptr(k), _build.ptr(vv), _build.ptr(lens),
                        _build.ptr(out), *scratch, B, T, NH, NKV, HD, S, scale, 0,
                        _build.stream_of(q)), v)

                def fused_call(k, vv, lib=lib, scratch=scratch, S=S, v=v):
                    check(lib.fused_decode_attn(
                        _build.ptr(qkv), _build.ptr(cos_t), _build.ptr(sin_t), _build.ptr(k),
                        _build.ptr(vv), _build.ptr(old), _build.ptr(out), _build.ptr(k_new),
                        *scratch, B, T, NH, NKV, HD, S, scale, 0, _build.stream_of(q)), v)

                if ref is None:  # the fused call's row write, once, before any dense call
                    for k, vv in caches:
                        fused_call(k, vv)
                dense_call(*caches[0])
                got = [out.clone()]
                fused_call(*caches[0])
                got.append(out.clone())
                torch.cuda.synchronize()
                ref = ref or got
                row = {"shape": f"{shape} B={B} T={T} lens {lo}-{hi - 1}", "variant": v,
                       "splits": S, "card": torch.cuda.get_device_name(0),
                       "dense_ms": graph_ms([lambda k=k, vv=vv: dense_call(k, vv)
                                             for k, vv in caches]),
                       "fused_ms": graph_ms([lambda k=k, vv=vv: fused_call(k, vv)
                                             for k, vv in caches]),
                       "max_diff": max((a.float() - b.float()).abs().max().item()
                                       for a, b in zip(got, ref))}
                print(json.dumps(row), flush=True)


INT4_SRC = "qgemv_int4.cu"
INT4_VARIANTS = {  # name -> [(old text, new text)] in the committed source
    "no_convert": [("const uint32_t a[4] = {nibble_pair(w0, s0, 2 * nt), "
                    "nibble_pair(w0, s0, 2 * nt + 1),\n                               "
                    "nibble_pair(w1, s1, 2 * nt), nibble_pair(w1, s1, 2 * nt + 1)};",
                    "const uint32_t a[4] = {w0, s0 + nt, w1, s1 + nt};")],
    "no_mma": [("            mma_bf16(acc[nt][mt], a, b);",
                "            acc[nt][mt][0] += "
                "__uint_as_float(a[0] ^ a[1] ^ a[2] ^ a[3] ^ b[0] ^ b[1]);")],
}
INT4_VARIANTS["loads_only"] = INT4_VARIANTS["no_convert"] + INT4_VARIANTS["no_mma"]
INT4_VARIANTS["bn128"] = [("constexpr int THREADS = 256, WARPS",
                           "constexpr int THREADS = 128, WARPS")]
INT4_VARIANTS["nst12"] = [("constexpr int NST = 8;", "constexpr int NST = 12;")]


def build_sources(src: str, tag: str, texts: dict, committed, typed) -> dict:
    """The committed library of ``src`` and one built from each named set of
    file texts ({file name: text}: the source, and any header that differs
    from the package's; the same C interface), all nvcc at once."""
    procs = {}
    for name, files in texts.items():
        vdir = _build.BUILD_DIR / f"{tag}_source_{name}"
        vdir.mkdir(parents=True, exist_ok=True)
        for f in _build.CSRC.glob("*.cuh"):
            (vdir / f.name).write_text(f.read_text())
        for fname, text in files.items():
            (vdir / fname).write_text(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(vdir / f"lib{tag}.so"),
             str(vdir / src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    libs = {"committed": committed}
    for name, proc in procs.items():
        log = proc.communicate()[0].decode()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log[-3000:]}")
        libs[name] = typed(ctypes.CDLL(str(_build.BUILD_DIR / f"{tag}_source_{name}"
                                           / f"lib{tag}.so")))
    return libs


def variant_texts(src: str, table: dict, args) -> dict:
    """name -> {file name: text}: the committed source (and headers) with
    each variant's edits, (old, new) in ``src`` or (file, old, new), and
    each ``--source NAME=PATH`` as it is."""
    texts = {}
    for v in args.variants:
        files = {}
        for edit in table[v]:
            fname, old, new = edit if len(edit) == 3 else (src, *edit)
            text = files.get(fname) or (_build.CSRC / fname).read_text()
            if old not in text:
                raise RuntimeError(f"variant {v}: {fname} no longer has {old!r}")
            files[fname] = text.replace(old, new)
        files.setdefault(src, (_build.CSRC / src).read_text())
        texts[v] = files
    for spec in args.source:
        name, path = spec.split("=", 1)
        texts[name] = {src: open(path).read()}
    return texts


def _typed_int4(lib):
    lib.qgemv_int4.argtypes = qm._int4_lib().qgemv_int4.argtypes
    lib.qgemv_int4.restype = ctypes.c_int
    return lib


def int4(args) -> None:
    libs = build_sources(INT4_SRC, "int4", variant_texts(INT4_SRC, INT4_VARIANTS, args),
                         qm._int4_lib(), _typed_int4)
    lib = libs["committed"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    dev, M = torch.device("cuda"), args.m
    for shape in args.shapes:
        K, N = INT4_SHAPES[shape]
        Kp = K // 2
        ws = [torch.randint(-128, 128, (Kp, N), device=dev, dtype=torch.int8, generator=gen)
              for _ in range(min(16, max(2, int(2e8 // (Kp * N)) + 1)))]
        scale = torch.rand(1, N, device=dev, generator=gen) * 0.01 + 0.001
        x = torch.randn(M, K, device=dev, generator=gen).to(torch.bfloat16)
        out = torch.empty(M, N, device=dev, dtype=torch.bfloat16)
        plan, win = qm._plan_int4(M, K, N, K, sms)
        row = {"shape": f"{shape} M={M} K={K} N={N}", "card": torch.cuda.get_device_name(0),
               "plan_ksplit": plan}
        ref = None
        for ks in [plan] + sorted({k for k in args.ksplits if k != plan}):
            kc = Kp // ks
            if (Kp % ks or ks > qm.INT4_MAX_SLICES or kc % qm.INT4_STAGE_ROWS
                    or qm._int4_x_bytes(M, kc) > qm.INT4_X_BYTES):
                continue

            def call(w, ks=ks):
                check(lib.qgemv_int4(_build.ptr(x), _build.ptr(w), _build.ptr(scale),
                                     _build.ptr(out), M, N, K, K, ks, win, 0,
                                     _build.stream_of(x)), f"ksplit {ks}")

            call(ws[0])
            got = out.clone()
            torch.cuda.synchronize()
            ref = got if ref is None else ref
            row[f"ms_ks{ks}"] = graph_ms([lambda w=w: call(w) for w in ws])
            row[f"max_diff_ks{ks}"] = (got.float() - ref.float()).abs().max().item()
        for name, other in libs.items():  # variants and other sources at the planner's split
            if name == "committed":
                continue

            def call_other(w, other=other, name=name):
                check(other.qgemv_int4(_build.ptr(x), _build.ptr(w), _build.ptr(scale),
                                       _build.ptr(out), M, N, K, K, plan, win, 0,
                                       _build.stream_of(x)), name)

            call_other(ws[0])
            torch.cuda.synchronize()
            row[f"max_diff_{name}"] = (out.float() - ref.float()).abs().max().item()
            row[f"ms_{name}"] = graph_ms([lambda w=w: call_other(w) for w in ws])
        wb = [torch.randn(K, N, device=dev, generator=gen).to(torch.bfloat16)
              for _ in range(min(16, max(2, int(2e8 // (2 * K * N)) + 1)))]
        row["matmul_bf16_ms"] = graph_ms([lambda w=w: torch.matmul(x, w) for w in wb])
        row["bound_ms"] = (Kp * N + 4 * N + 2 * M * K + 2 * M * N) / 3.35e12 * 1e3
        print(json.dumps(row), flush=True)
        del ws, wb


INT8_SRC = "qgemv_int8.cu"
INT8_VARIANTS = {  # name -> [(old text, new text)] in the committed source, or
    # [(header, old text, new text)]: the products of a stage are gemv.cuh's
    "no_convert": [("gemv.cuh", "const uint32_t af[4] = {cvt(w0, w1, 2 * n), "
                    "cvt(w0, w1, 2 * n + 1), cvt(w2, w3, 2 * n),\n"
                    "                              cvt(w2, w3, 2 * n + 1)};",
                    "const uint32_t af[4] = {w0, w1 + n, w2, w3 + n};")],
    "no_mma": [("gemv.cuh", "        mma_bf16(acc[n][mt], af, b);",
                "        acc[n][mt][0] += "
                "__uint_as_float(af[0] ^ af[1] ^ af[2] ^ af[3] ^ b[0] ^ b[1]);")],
}
INT8_VARIANTS["loads_only"] = INT8_VARIANTS["no_convert"] + INT8_VARIANTS["no_mma"]
INT8_VARIANTS["no_stream"] = [  # the weight ring never filled: launch, prologue, epilogue
    ("    if (!copies) return;", "    return;")]
INT8_VARIANTS["no_loop"] = [("for (int s = 0; s < nsteps; ++s) {", "for (int s = 0; s < 0; ++s) {")]
INT8_VARIANTS["no_xstage"] = [("for (int i = tid; i < 8 * MT * (a.kc / 8); i += THREADS) {",
                               "for (int i = tid; i < 0; i += THREADS) {")]
INT8_VARIANTS["no_rms"] = [
    ("if (a.rms) {  // one warp per row", "if (false) {  // one warp per row")]
INT8_VARIANTS["no_prologue"] = INT8_VARIANTS["no_xstage"] + [
    ("if (a.rms) {  // one warp per row", "if (false) {  // one warp per row")]
INT8_VARIANTS["no_loop_prologue"] = INT8_VARIANTS["no_loop"] + INT8_VARIANTS["no_prologue"]
INT8_VARIANTS["bn128"] = [("constexpr int WARPS = 8,", "constexpr int WARPS = 4,")]
INT8_VARIANTS["nst4"] = [("constexpr int NST = 6;", "constexpr int NST = 4;")]
INT8_VARIANTS["nst5"] = [("constexpr int NST = 6;", "constexpr int NST = 5;")]
INT8_VARIANTS["nst8"] = [("constexpr int NST = 6;", "constexpr int NST = 8;")]
INT8_VARIANTS["sr32"] = [("constexpr int SR = 64;", "constexpr int SR = 32;"),
                         ("constexpr int NST = 6;", "constexpr int NST = 12;")]
INT8_VARIANTS["sr128"] = [("constexpr int SR = 64;", "constexpr int SR = 128;"),
                          ("constexpr int NST = 6;", "constexpr int NST = 3;")]
INT8_VARIANTS["no_barrier"] = [  # the loop's barrier dropped: wrong by design, timed only
    ("    __syncthreads();  // stage s landed for every thread; stage s - 1 fully read",
     "")]
INT8_VARIANTS["no_pdl"] = [("programmaticStreamSerializationAllowed = 1",
                            "programmaticStreamSerializationAllowed = 0")]
# name -> (K, weight columns, mode): Llama-3.2-1B's int8 decode projections.
INT8_SHAPES = {"wqkv": (2048, 3072, "store"), "wo": (2048, 2048, "residual"),
               "wgu": (2048, 16384, "swiglu"), "down": (8192, 2048, "residual"),
               "head": (2048, 129024, "store"), "head_argmax": (2048, 129024, "argmax")}


def _typed_int8(lib):
    ref = df._qgemv_lib()
    for fn in ("qgemv_int8", "qgemv_int8_argmax"):
        getattr(lib, fn).argtypes = getattr(ref, fn).argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def int8(args) -> None:
    libs = build_sources(INT8_SRC, "int8", variant_texts(INT8_SRC, INT8_VARIANTS, args),
                         df._qgemv_lib(), _typed_int8)
    gen = torch.Generator(device="cuda").manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    dev, M, bf16 = torch.device("cuda"), args.m, torch.bfloat16
    for shape in args.shapes:
        K, ldq, mode = INT8_SHAPES[shape]
        n_out = ldq // 2 if mode == "swiglu" else ldq
        ws = [torch.randint(-128, 128, (K, ldq), device=dev, dtype=torch.int8, generator=gen)
              for _ in range(min(16, max(2, int(2e8 // (K * ldq)) + 1)))]
        scale = torch.rand(1, ldq, device=dev, generator=gen) * 0.01 + 0.001
        x = torch.randn(M, K, device=dev, generator=gen).to(bf16)
        gamma = 1.0 + 0.1 * torch.randn(K, device=dev, generator=gen)
        res = torch.randn(M, n_out, device=dev, generator=gen).to(bf16)
        out = torch.empty(M, n_out, device=dev, dtype=bf16)
        keys = torch.empty(M, device=dev, dtype=torch.int64)
        tok = torch.empty(M, device=dev, dtype=torch.int32)
        mt, plan = df.plan_qgemv(M, K, n_out, K, sms, mode == "swiglu")
        row = {"shape": f"{shape} M={M} K={K} N={ldq} ({mode})",
               "card": torch.cuda.get_device_name(0), "plan_ksplit": plan}

        def call(w, lib, ks, what):
            if mode == "argmax":
                rc = lib.qgemv_int8_argmax(
                    _build.ptr(x), _build.ptr(gamma), _build.ptr(w), _build.ptr(scale),
                    _build.ptr(keys), _build.ptr(tok), M, ldq, K, K, ldq - 1000, 1e-5, ks, mt,
                    0, 0, _build.stream_of(x))
            else:
                rc = lib.qgemv_int8(
                    _build.ptr(x), None if mode == "residual" else _build.ptr(gamma),
                    _build.ptr(w), _build.ptr(scale),
                    _build.ptr(res) if mode == "residual" else None, _build.ptr(out), M, n_out,
                    K, ldq, K, df._MODE[mode], int(mode != "residual"), 1e-5, ks, mt, 0, 0,
                    _build.stream_of(x))
            check(rc, what)
            return tok if mode == "argmax" else out

        def diff(a, b):
            return (a.float() - b.float()).abs().max().item()

        ref = None
        for ks in [plan] + sorted({k for k in args.ksplits if k != plan}):
            kc = K // ks
            if (K % ks or ks > df.INT8_MAX_SLICES or kc % df.INT8_STAGE_ROWS
                    or df._int8_x_bytes(M, kc) > df.INT8_X_BYTES):
                continue
            got = call(ws[0], libs["committed"], ks, f"ksplit {ks}").clone()
            torch.cuda.synchronize()
            ref = got if ref is None else ref
            row[f"ms_ks{ks}"] = graph_ms([lambda w=w, ks=ks: call(w, libs["committed"], ks, "")
                                          for w in ws])
            row[f"max_diff_ks{ks}"] = diff(got, ref)
        for name, lib in libs.items():  # variants and other sources at the planner's split
            if name == "committed":
                continue
            got = call(ws[0], lib, plan, name).clone()
            torch.cuda.synchronize()
            row[f"max_diff_{name}"] = diff(got, ref)
            row[f"ms_{name}"] = graph_ms([lambda w=w, lib=lib: call(w, lib, plan, name)
                                          for w in ws])
        wb = [torch.randn(K, ldq, device=dev, generator=gen).to(bf16)
              for _ in range(min(16, max(2, int(2e8 // (2 * K * ldq)) + 1)))]
        row["matmul_bf16_ms"] = graph_ms([lambda w=w: torch.matmul(x, w) for w in wb])
        row["bound_ms"] = (K * ldq + 4 * ldq + 2 * M * K + 2 * M * n_out) / 3.35e12 * 1e3
        print(json.dumps(row), flush=True)
        del ws, wb


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="kernel", required=True)
    d = sub.add_parser("dense")
    d.add_argument("--variants", nargs="+", default=list(VARIANTS), choices=list(VARIANTS))
    d.add_argument("--shapes", nargs="+", default=list(SHAPES), choices=list(SHAPES))
    d.add_argument("--splits", nargs="+", type=int, default=[])
    i = sub.add_parser("int4")
    i.add_argument("--shapes", nargs="+", default=list(INT4_SHAPES), choices=list(INT4_SHAPES))
    i.add_argument("--m", type=int, default=8)
    i.add_argument("--ksplits", nargs="+", type=int, default=[])
    i.add_argument("--variants", nargs="+", default=[], choices=list(INT4_VARIANTS))
    i.add_argument("--source", nargs="+", default=[], metavar="NAME=PATH")
    e = sub.add_parser("int8")
    e.add_argument("--shapes", nargs="+", default=list(INT8_SHAPES), choices=list(INT8_SHAPES))
    e.add_argument("--m", type=int, default=8)
    e.add_argument("--ksplits", nargs="+", type=int, default=[])
    e.add_argument("--variants", nargs="+", default=[], choices=list(INT8_VARIANTS))
    e.add_argument("--source", nargs="+", default=[], metavar="NAME=PATH")
    args = ap.parse_args()
    {"dense": dense, "int4": int4, "int8": int8}[args.kernel](args)


if __name__ == "__main__":
    main()
