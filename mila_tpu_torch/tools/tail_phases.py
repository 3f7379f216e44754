"""Time each phase of the layer-tail kernel (K7, ``csrc/layer_tail_int8.cu``)
and of the whole-step decode kernel (K8, ``csrc/decode_step_int8.cu``), both
built on ``csrc/tail_phases.cuh``, on the GPU at Llama-3.2-1B's shapes
(H 2048, I 8192, wqkv 3072 columns, bn 512, random int8 weights).

    python -m mila_tpu_torch.tools.tail_phases [--kernels tail mlp mega giga]
        [--variants committed nst2 no_stream ...] [--plans committed c128 ...]
        [--tree NAME=DIR ...]

It compiles copies of the two sources in which block 0 stamps
``%globaltimer`` when the kernel starts, after every grid barrier and when
it ends (into ``csrc/build/``, one nvcc per source and variant, all at
once), runs each kernel 12 times per variant and plan, and prints one JSON
line per kernel, variant and plan with the median µs of each phase:

- ``tail``: the layer tail of a middle layer (M 8, alternating between two
  layers of a 3-layer stream) and of the last one: wo, fin1, gu, fin_h,
  down, fin2, qkv, fin3;
- ``mlp``: the MLP block (bn 2048, no next wqkv, M 8): wo .. fin2;
- ``mega``: one decode layer of K8 (attention, then the tail with the next
  wqkv; M 8, lengths 128-191, T 512);
- ``giga``: the whole decode step (L 16, B 8, cached lengths 128-191 of a
  T 512 cache, tokens mode), each phase kind summed over the layers:
  prologue (embedding rows, RoPE tables, row sums of squares), attention,
  wo, fin1, gu, fin_h, down, fin2, qkv (the prologue's wqkv_0 and the 15
  next-layer products), fin3, head (norm_f and the head GEMV) and argmax
  (logits, each block's best column, the merge).

An interval runs from one barrier's exit to the next one's in block 0: the
slowest block's work plus the barrier. Last, the time of a launch of grid
barriers alone (1 and 8 of them).

Variants are builds of the committed sources with a ``-D`` macro of
``tail_phases.cuh`` or an edit: ``committed``; ``nst2`` / ``nst4`` /
``nst5`` (ring stages; ``nst5`` with a 17 KB staged slice, so two blocks
still fit an SM); ``mb1`` (registers bounded for one resident block per SM,
and one block an SM); ``no_mma``, ``no_stream``, ``no_stage`` (the
products, the weight copies or the staging of x dropped; wrong by design,
timed only) and ``loads_only`` (no products, no staging); ``inline`` (the
phase functions forced inline into the kernels); ``no_attn`` (K8 without
its attention units: wrong by design), ``maxg4`` (K8's query slots a KV
head capped at 4, Llama's G, not 8) and ``mega_only`` (K8 without its giga
prologue and head: the one-layer launch alone); ``k7_local`` (K7 given a
local copy of its parameters, as K8 builds one a layer) and ``k7_static``
(K7 with K8's static shared memory). ``--tree NAME=DIR`` adds the sources
in DIR (another tail_phases.cuh, layer_tail_int8.cu and
decode_step_int8.cu with the same C interface, e.g. an earlier commit's
from ``git show`` into the git-ignored ``scratch_chip/``). ``--bn`` sets the
tail case's tile width. Plans are the launch plan
(``kernels/layer_fused.py:plan_tail``): ``committed``; ``c128`` / ``c256``
(128 or 256 weight columns a unit in every phase that takes them);
``half`` (one K-slice doubling fewer in every phase that has more than one;
``half_wo``, ``half_down``, ``half_wo_down``: in those phases only).
Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
from pathlib import Path

import numpy as np
import torch

from mila_tpu_torch.inference.quantize import quantize
from mila_tpu_torch.kernels import _build
from mila_tpu_torch.kernels import decode_giga as dg
from mila_tpu_torch.kernels import decode_mlp as dm
from mila_tpu_torch.kernels import layer_fused as lf
from mila_tpu_torch.kernels import layer_mega as lm
from mila_tpu_torch.kernels import layer_stream as ls

H, I, NQ, BN, M = 2048, 8192, 3072, 512, 8
NH, NKV, HD, L, T, VOCAB = 32, 8, 64, 16, 512, 128256
MAX_STAMPS = 1024
TAIL = ("wo", "fin1", "gu", "fin_h", "down", "fin2")

# name -> (nvcc defines, overrides of kernels/layer_fused.py's mirrors of them,
# edits of tail_phases.cuh: [(old text, new text)])
_NO_MMA = [("bx, tq, j0, ksw, ", "bx, tq, j0, 0, ")]  # stage_products: no k-step
_NO_STREAM = [("        if (c * rstep < K::SRS)\n", "        if (false)\n")]
_INLINE = [("__device__ void gemv_phase(", "__device__ __forceinline__ void gemv_phase("),
           ("__device__ void qkv_phases(", "__device__ __forceinline__ void qkv_phases("),
           ("__device__ void tail_phases(", "__device__ __forceinline__ void tail_phases(")]
_NO_STAGE = [("  constexpr int XB = 4;\n", "  constexpr int XB = 4;\n  if (true) return;\n")]
VARIANTS = {
    "committed": ([], {}, []),
    "nst2": (["-DTAIL_NST=2"], {}, []),
    "nst4": (["-DTAIL_NST=4"], {}, []),
    "nst5": (["-DTAIL_NST=5", "-DTAIL_XS_KB=17"], {"_XS_BYTES": 17 * 1024}, []),
    "mb1": (["-DTAIL_MIN_BLOCKS=1"], {"_BLOCKS_PER_SM": 1}, []),
    "no_mma": ([], {}, _NO_MMA),
    "no_stream": ([], {}, _NO_STREAM),
    "no_stage": ([], {}, _NO_STAGE),
    "loads_only": ([], {}, _NO_MMA + _NO_STAGE),
    "inline": ([], {}, _INLINE),
    "no_attn": ([], {}, [("decode_step_int8.cu", "u < M * p.NKV; u += gridDim.x", "u < 0; u += 1")]),
    "maxg4": ([], {}, [("decode_step_int8.cu", "constexpr int MAXG = 8,", "constexpr int MAXG = 4,")]),
    "mega_only": ([], {}, [("decode_step_int8.cu", "  if (p.giga) {\n", "  if (false) {\n"),
                            ("decode_step_int8.cu", "  if (!p.giga) return;", "  return;")]),
    "k7_local": ([], {}, [("layer_tail_int8.cu", "  tail_phases<MT, T, FP8 ? WK_FP8 : WK_INT8>(p, smem, grid);",
                           "  Params q = p;\n  q.eps = p.eps + 0.f * threadIdx.x;\n"
                           "  tail_phases<MT, T, FP8 ? WK_FP8 : WK_INT8>(q, smem, grid);")]),
    "k7_static": ([], {}, [("layer_tail_int8.cu", "  tail_phases<MT, T, FP8 ? WK_FP8 : WK_INT8>(p, smem, grid);",
                            "  __shared__ float pad_s[32 + WARPS * 33 + 2 * WARPS];\n"
                            "  if (threadIdx.x > 4096) pad_s[threadIdx.x % 300] = 1.f;\n"
                            "  tail_phases<MT, T, FP8 ? WK_FP8 : WK_INT8>(p, smem, grid);")]),
}

_STAMP = f'''
__device__ unsigned long long g_trace[{MAX_STAMPS}];
__device__ int g_n;
__device__ __forceinline__ void stamp() {{
  if (blockIdx.x == 0 && threadIdx.x == 0) {{
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    if (g_n < {MAX_STAMPS}) g_trace[g_n++] = t;
  }}
}}
'''
_EXTRA = f'''
__global__ void barriers_only(int n) {{
  cg::grid_group g = cg::this_grid();
  for (int i = 0; i < n; ++i) g.sync();
}}
extern "C" int run_barriers(int grid, int n, void* stream) {{
  void* args[] = {{&n}};
  return (int)cudaLaunchCooperativeKernel((const void*)barriers_only, dim3(grid), dim3(256),
                                          args, 0, (cudaStream_t)stream);
}}
extern "C" void reset_trace() {{
  int z = 0;
  cudaMemcpyToSymbol(g_n, &z, sizeof(int));
}}
extern "C" int get_trace(unsigned long long* out) {{
  int n = 0;
  cudaMemcpyFromSymbol(&n, g_n, sizeof(int));
  cudaMemcpyFromSymbol(out, g_trace, sizeof(unsigned long long) * {MAX_STAMPS});
  return n;
}}
'''


def _instrument_kernel(src: str, name: str) -> str:
    """Stamp at the start and at every exit of the __global__ function
    ``name`` (found by matching its braces)."""
    m = re.search(r"\b" + name + r"\([^)]*\)\s*\{", src)
    if m is None:
        raise RuntimeError(f"no kernel {name} in the source")
    depth, i = 1, m.end()
    while depth:
        depth += {"{": 1, "}": -1}.get(src[i], 0)
        i += 1
    body = src[m.end():i - 1].replace("return;", "{ stamp(); return; }")
    return src[:m.end()] + " stamp();" + body + "stamp();\n}" + src[i:]


def _edited(text: str, name: str, edits) -> str:
    """text (file `name`) with the edits [(old, new)] of tail_phases.cuh, or
    [(file, old, new)] of any file."""
    for e in edits:
        file, old, new = e if len(e) == 3 else ("tail_phases.cuh", *e)
        if file != name:
            continue
        if old not in text:
            raise RuntimeError(f"{name} no longer holds {old!r}")
        text = text.replace(old, new)
    return text


def stamped_sources(edits=(), root=_build.CSRC) -> dict:
    """The two sources under `root` with the phase clock: tail_phases.cuh
    inlined, `edits` applied, a stamp after every grid barrier, at each
    kernel's start and exits."""
    head = _edited((root / "tail_phases.cuh").read_text(), "tail_phases.cuh", edits)
    if head.count("grid.sync();") < 4:
        raise RuntimeError("tail_phases.cuh no longer has the expected barriers")
    head = head.replace("#pragma once", "#pragma once\n" + _STAMP, 1)
    out = {}
    for name, kernel in (("layer_tail_int8", "tail_kernel"), ("decode_step_int8", "step_kernel")):
        src = _edited((root / f"{name}.cu").read_text(), f"{name}.cu", edits)
        src = src.replace('#include "tail_phases.cuh"', head)
        src = _instrument_kernel(src, kernel).replace("grid.sync();",
                                                      "{ grid.sync(); stamp(); }")
        out[name] = src + _EXTRA
    return out


def build(variants, trees=None) -> dict:
    """{variant: {source: library}}, compiled all at once; ``trees`` maps
    more variant names to directories holding another tail_phases.cuh,
    layer_tail_int8.cu and decode_step_int8.cu with the same C interface
    (headers missing there come from csrc/)."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    jobs = [(v, VARIANTS[v][2], _build.CSRC, VARIANTS[v][0]) for v in variants]
    jobs += [(v, (), Path(d).resolve(), []) for v, d in (trees or {}).items()]
    for v, edits, root, defines in jobs:
        for src_name, text in stamped_sources(edits, root).items():
            cu = _build.BUILD_DIR / f"phases_{src_name}_{v}.cu"
            cu.write_text(text)
            out = _build.BUILD_DIR / f"libphases_{src_name}_{v}.so"
            procs[(v, src_name)] = (out, subprocess.Popen(
                [_build.nvcc(), *_build.NVCC_FLAGS, f"-I{root}", f"-I{_build.CSRC}", *defines,
                 "-o", str(out), str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    libs: dict = {v: {} for v, *_ in jobs}
    for (v, src_name), (out, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {src_name} ({v}):\n{log[-3000:]}")
        regs = sorted(set(re.findall(r"Used (\d+) registers", log)))
        spills = sorted(set(re.findall(r"(\d+) bytes spill stores", log)))
        stack = sorted(set(re.findall(r"(\d+) bytes stack frame", log)))
        funcs = sorted(set(re.findall(r"Function properties for (\S+)", log)))
        print(json.dumps({"variant": v, "source": src_name, "registers": regs,
                          "spill_store_bytes": spills, "stack_frame_bytes": stack,
                          "functions": funcs}), flush=True)
        lib = ctypes.CDLL(str(out))
        (lf if src_name == "layer_tail_int8" else lm).type_lib(lib)
        lib.reset_trace.argtypes = []
        lib.get_trace.argtypes = [ctypes.c_void_p]
        lib.get_trace.restype = ctypes.c_int
        lib.run_barriers.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        libs[v][src_name] = lib
    return libs


# ---------------------------------------------------------------------------
# Launch plans (runtime variants of kernels/layer_fused.py:plan_tail)
# ---------------------------------------------------------------------------

_PLAN = lf.plan_tail  # the committed planner (the runs below patch the module's name)


def _cols(cols):
    """The committed K slices for units of ``cols`` weight columns where
    they divide bn (else the committed columns)."""
    def plan(M, H, bn, tiles, grid):
        if bn % cols:
            return _PLAN(M, H, bn, tiles, grid)
        return lf._slice_plan(M, H, bn, tiles, grid, cols)
    return plan


def _halved(*names):
    def plan(*a):
        mt, p = _PLAN(*a)
        return mt, {k: (c, ks // 2 if k in names and ks > 1 else ks) for k, (c, ks) in p.items()}
    return plan


PLANS = {"committed": _PLAN, "c128": _cols(128), "c256": _cols(256),
         "half": _halved("wo", "gu", "down", "qkv", "head"), "half_wo": _halved("wo"),
         "half_down": _halved("down"), "half_wo_down": _halved("wo", "down")}


# ---------------------------------------------------------------------------
# Cases
# ---------------------------------------------------------------------------

def _weights(gen):
    def w(*shape):
        return quantize(torch.randn(*shape, device="cuda", generator=gen) * 0.05, "int8")
    return w


def tail_case(gen, bn=BN):
    w = _weights(gen)
    ws = [(w(H, H), w(H, 2 * I), w(I, H), w(H, NQ)) for _ in range(3)]
    packs = [lf.pack_layer(*ws[i][:3], ws[i + 1][3] if i < 2 else None, bn=bn)
             for i in range(3)]
    stream = ls.pack_layer_stream(packs)
    att = torch.randn(M, 1, H, device="cuda", generator=gen).bfloat16()
    x = torch.randn(M, 1, H, device="cuda", generator=gen).bfloat16()
    x32 = x.float()
    g = torch.ones(H, device="cuda")
    tag = "" if bn == BN else f"_bn{bn}"
    return {"middle" + tag: (lambda rep: ls.layer_tail_stream(att, x, g, stream, rep % 2, g),
                             TAIL + ("qkv", "fin3")),
            "last" + tag: (lambda rep: ls.layer_tail_stream(att, x, g, stream, 2, None), TAIL),
            "middle_f32" + tag: (lambda rep: ls.layer_tail_stream(att, x32, g, stream, rep % 2, g),
                                 TAIL + ("qkv", "fin3"))}


def mlp_case(gen, bn=BN):
    w = _weights(gen)
    packs = [dm.pack_mlp(w(H, H), w(H, 2 * I), w(I, H), bn=2048) for _ in range(2)]
    att = torch.randn(M, 1, H, device="cuda", generator=gen).bfloat16()
    x = torch.randn(M, 1, H, device="cuda", generator=gen).bfloat16()
    g = torch.ones(H, device="cuda")
    return {"bn2048": (lambda rep: dm.mlp_block_fused(att, x, g, packs[rep % 2]), TAIL)}


def giga_sequence(layers: int) -> list:
    """The phase kind of each interval between the stamps of one giga step."""
    seq = ["prologue", "qkv"]
    for layer in range(layers):
        seq += ["fin3", "attention", *TAIL[:5], "fin2"]
        if layer + 1 < layers:
            seq.append("qkv")
    return seq + ["head", "argmax", "argmax"]


def giga_case(gen, bn=BN):
    w = _weights(gen)
    KD = NKV * HD
    layers = [(w(NH * HD, H), w(H, 2 * I), w(I, H), w(H, NH * HD + 2 * KD)) for _ in range(L)]
    vp = -(-VOCAB // BN) * BN
    ones = torch.ones(L, H, device="cuda")
    inv = (1.0 / 500000.0 ** (np.arange(0, HD, 2) / HD)).astype(np.float32)
    pack = dg.pack_giga(layers, w(H, vp), ones, ones, ones[0], nh=NH, nkv=NKV, hd=HD,
                        vocab=VOCAB, bn=BN, rope_inv_freq=inv)
    del layers
    B = M
    lens = torch.randint(128, 192, (B,), device="cuda", generator=gen, dtype=torch.int32)
    kpool = torch.randn(L, B, T, KD, device="cuda", generator=gen).bfloat16()
    vpool = torch.randn(L, B, T, KD, device="cuda", generator=gen).bfloat16()
    wte = torch.randn(VOCAB, H, device="cuda", generator=gen).bfloat16()
    tokens = torch.randint(0, VOCAB, (B,), device="cuda", generator=gen, dtype=torch.int32)
    return {"L16_tokens": (lambda rep: dg.giga_decode_step(wte, None, None, lens, pack, kpool,
                                                           vpool, tokens=tokens),
                           giga_sequence(L))}


def mega_case(gen, bn=BN):
    """One decode layer of K8 (layer_megakernel) at the giga step's shapes,
    alternating between two layers' packs and caches."""
    w = _weights(gen)
    KD, NQ1 = NKV * HD, NH * HD
    packs = [lm.pack_mega_layer(w(NQ1, H), w(H, 2 * I), w(I, H), w(H, NQ1 + 2 * KD), nh=NH,
                                nkv=NKV, hd=HD, bn=bn) for _ in range(2)]
    B = M
    lens = torch.randint(128, 192, (B,), device="cuda", generator=gen, dtype=torch.int32)
    caches = [(torch.randn(B, T, NKV, HD, device="cuda", generator=gen).bfloat16(),
               torch.randn(B, T, NKV, HD, device="cuda", generator=gen).bfloat16())
              for _ in range(2)]
    qkv = torch.randn(B, NQ1 + 2 * KD, device="cuda", generator=gen).bfloat16()
    x = torch.randn(B, H, device="cuda", generator=gen).bfloat16()
    ang = lens[:, None].float() * torch.rand(1, KD, device="cuda", generator=gen)
    cos_t, sin_t = torch.cos(ang), torch.sin(ang)
    g = torch.ones(H, device="cuda")
    return {"layer": (lambda rep: lm.layer_megakernel(qkv, x, g, packs[rep % 2],
                                                      *caches[rep % 2], lens, cos_t, sin_t, g,
                                                      num_heads=NH),
                      ["attention", *TAIL, "qkv", "fin3"])}


CASES = {"tail": ("layer_tail_int8", tail_case), "mlp": ("layer_tail_int8", mlp_case),
         "mega": ("decode_step_int8", mega_case), "giga": ("decode_step_int8", giga_case)}


def run_case(lib, call, seq, reps: int) -> dict:
    """Median µs of each phase kind (summed over its intervals) and in all."""
    rows = []
    for rep in range(reps):
        lib.reset_trace()
        call(rep)
        torch.cuda.synchronize()
        tr = (ctypes.c_ulonglong * MAX_STAMPS)()
        n = lib.get_trace(tr)
        if n != len(seq) + 1:
            raise RuntimeError(f"{n} stamps, {len(seq) + 1} expected")
        row = dict.fromkeys(dict.fromkeys(seq), 0.0)
        for i, kind in enumerate(seq):
            row[kind] += (tr[i + 1] - tr[i]) / 1e3
        row["total_us"] = (tr[n - 1] - tr[0]) / 1e3
        rows.append(row)
    keep = rows[2:]
    return {k: statistics.median(r[k] for r in keep) for k in rows[0]}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels", nargs="+", default=list(CASES), choices=list(CASES))
    ap.add_argument("--variants", nargs="+", default=["committed"], choices=list(VARIANTS))
    ap.add_argument("--plans", nargs="+", default=["committed"], choices=list(PLANS))
    ap.add_argument("--tree", nargs="*", default=[], metavar="NAME=DIR",
                    help="also build the sources in DIR (e.g. an earlier commit's, from "
                         "git show) as variant NAME")
    ap.add_argument("--bn", type=int, default=BN,
                    help="tile width of the tail's pack (the served one is 512; giga keeps 512)")
    ap.add_argument("--reps", type=int, default=12)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("tail_phases needs a CUDA device")
    trees = dict(t.split("=", 1) for t in args.tree)
    libs = build(args.variants, trees)
    variants = list(args.variants) + list(trees)
    card = torch.cuda.get_device_name(0)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    saved = {m: (m._lib, m.plan_tail, m._BLOCKS_PER_SM) for m in (lf, lm)}
    saved_consts = {"_XS_BYTES": lf._XS_BYTES}
    try:
        for kernel in args.kernels:
            src_name, make = CASES[kernel]
            cases = make(gen, args.bn) if kernel == "tail" else make(gen)
            for v in variants:
                lib = libs[v][src_name]
                for plan in args.plans:
                    overrides = dict(VARIANTS[v][1] if v in VARIANTS else {})
                    bps = overrides.pop("_BLOCKS_PER_SM", saved[lf][2])
                    for mod in (lf, lm):
                        mod._lib = lambda lib=lib: lib
                        mod.plan_tail = PLANS[plan]
                        mod._BLOCKS_PER_SM = bps
                        mod._grid.cache_clear()
                    for k, val in overrides.items():
                        setattr(lf, k, val)
                    for case, (call, seq) in cases.items():
                        res = run_case(lib, call, seq, args.reps)
                        grid = (lm._grid(0, 8, 1) if kernel in ("giga", "mega")
                                else lf._grid(0, 8, 0))
                        print(json.dumps({"card": card, "kernel": kernel, "case": case,
                                          "variant": v, "plan": plan, "grid": grid, **res}),
                              flush=True)
                    for k, val in saved_consts.items():
                        setattr(lf, k, val)
            del cases
            torch.cuda.empty_cache()
    finally:
        for mod, (lib_fn, plan_fn, bps) in saved.items():
            mod._lib, mod.plan_tail, mod._BLOCKS_PER_SM = lib_fn, plan_fn, bps
            mod._grid.cache_clear()
        for k, val in saved_consts.items():
            setattr(lf, k, val)
    lib = libs[variants[0]]["layer_tail_int8"]
    stream_ptr = torch.cuda.current_stream().cuda_stream
    grid = lf._grid(0, 8, 0)
    for n in (1, 8):
        lib.run_barriers(grid, n, stream_ptr)
        torch.cuda.synchronize()
        ts = []
        for _ in range(10):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            rc = lib.run_barriers(grid, n, stream_ptr)
            b.record()
            b.synchronize()
            if rc:
                raise RuntimeError(f"barrier launch failed: CUDA error {rc}")
            ts.append(a.elapsed_time(b) * 1e3)
        print(json.dumps({"card": card, "barriers_only": n, "grid": grid,
                          "us": statistics.median(ts)}), flush=True)


if __name__ == "__main__":
    main()
