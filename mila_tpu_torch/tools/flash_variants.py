"""Check and time the flash-attention forward (``csrc/flash_fwd.cu``, or for
f32 ``csrc/flash_tf32_fwd.cu``) or, with ``--bwd``, the 16-bit backward
(``csrc/flash_bwd.cu``), and variants of it, on the GPU, at the shapes
``chip_smoke.py`` gives its rows.

    python -m mila_tpu_torch.tools.flash_variants [--variants committed ...]
        [--source NAME=PATH ...] [--shapes ...] [--dtype bf16|fp16|f32] [--bwd]

Each variant is a copy of the source (and its headers) with edits,
compiled with the package's nvcc flags into ``csrc/build/``; its ptxas
report (registers, spills) is printed first. Per shape it prints one JSON
line: each variant's worst row error against the plain version (each (b,
t, head) row of the output against its own largest value; with
statistics, l's relative and m's absolute error too), its median ms per
launch (CUDA events around 10 launches, 5 repeats) and causal TFLOP/s, beside
``scaled_dot_product_attention`` on the same inputs. ``--source`` adds a
whole other ``flash_fwd.cu`` or ``flash_tf32_fwd.cu`` (the ``*.cuh`` files
beside it, where there are any, replace the package's) as a variant named
NAME: ``git show <commit>:mila_tpu_torch/csrc/<file>`` into a directory
``.gitignore`` lists times that commit's kernel. The shapes past D 320 (in
f32 from D 320) run the column-part kernels: the ``part_*`` variants drop
their parts, ``part_dc_large`` builds them for parts of 512 columns at
every D (at D 576 and 640: 512 + 64 and 512 + 128 in place of 320 + 256 and
320 + 320), and ``part_bk32`` gives 16-bit's 320-column parts 32-key
tiles. With ``--bwd`` the shapes are the backward's past D 256 (``bwd_*``,
on the forward's statistics) and each line holds each variant's worst row
error of dq, dk and dv against the plain version (each row's scale floored
at 1e-3 of the tensor's max), its median ms per call
(its three launches) and TFLOP/s (10 D per visible pair), beside SDPA's
backward alone (``autograd.grad`` on one saved forward, events around 10
calls); the ``bwd_*`` variants drop a phase of the dQ and dK/dV kernels or
a whole kernel (``bwd_dkv_only``, ``bwd_dq_only``), or hand the consumers
more registers (``bwd_setmaxnreg``: a producer warpgroup that gives its
registers up, the consumers at 240 a thread). Needs a CUDA device and nvcc.
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

from mila_tpu_torch.kernels import _build
from mila_tpu_torch.kernels import flash_attention as fa
from mila_tpu_torch.ops import causal_mask

SRC = "flash_fwd.cu"
TF32_SRC = "flash_tf32_fwd.cu"  # --dtype f32 builds this source (entry flash_tf32_fwd)
BWD_SRC = "flash_bwd.cu"  # --bwd builds this source (entry flash_bwd)
VARIANTS = {  # name -> [(file, old text, new text)]
    "committed": [],
    # the two consumer warpgroups issue their products whenever they are
    # ready, without taking turns
    "no_pingpong": [(SRC, "{ named_bar_sync(SCHED + wg, CONSUMERS); }", "{}"),
                    (SRC, "{ named_bar_arrive(SCHED + 1 - wg, CONSUMERS); }", "{}")],
    # what each part costs (wrong results; only their times mean anything):
    # no exponentials (the FFMA stays), neither product
    "no_ex2": [(SRC, "sc[e] = ex2(fmaf(", "sc[e] = (fmaf(")],
    "no_mma": [(SRC, "for (int kk = 0; kk < D / 16; ++kk) {", "for (int kk = 0; kk < 0; ++kk) {"),
               (SRC, "for (int kk = 0; kk < C::BKV / 16; ++kk) {",
                "for (int kk = 0; kk < 0; ++kk) {")],
    # no softmax (nor O's rescale and P's packing), and then no products either
    "no_softmax": [(SRC, "float c) {\n  if (causal && k0", "float c) {\n  return;\n  if (causal && k0"),
                   (SRC, "const float* alpha) {\n", "const float* alpha) {\n  return;\n"),
                   (SRC, "const float* sc) {\n", "const float* sc) {\n  return;\n")],
    "loads_only": [(SRC, "float c) {\n  if (causal && k0", "float c) {\n  return;\n  if (causal && k0"),
                   (SRC, "const float* alpha) {\n", "const float* alpha) {\n  return;\n"),
                   (SRC, "const float* sc) {\n", "const float* sc) {\n  return;\n"),
                   (SRC, "for (int kk = 0; kk < D / 16; ++kk) {",
                    "for (int kk = 0; kk < 0; ++kk) {"),
                   (SRC, "for (int kk = 0; kk < C::BKV / 16; ++kk) {",
                    "for (int kk = 0; kk < 0; ++kk) {")],
    # no K/V loads: the products and the softmax run on whatever the ring holds
    "no_kv_loads": [(SRC, "mbar_expect_tx(&full[s], 2 * KV_TILE);", "mbar_expect_tx(&full[s], 0);"),
                    (SRC, "tma_load_3d(ks + s * KV_TILE", "if (0) tma_load_3d(ks + s * KV_TILE"),
                    (SRC, "tma_load_3d(vs + s * KV_TILE", "if (0) tma_load_3d(vs + s * KV_TILE")],
    # P V's wait behind a branch on the softmax's sum: ptxas otherwise issues
    # it before the softmax, so P V of the last tile does not run under it
    "wait_after_branch": [(SRC, "      wgmma_wait<0>();\n      wgmma_fence_operand<NO>(o);\n"
                                "      mbar_arrive(&empty[sp]);",
                           "      if (l[0] >= 0.f) wgmma_wait<0>(); else { asm volatile("
                           "\"wgmma.wait_group.sync.aligned 0; // nan\\n\" ::: \"memory\"); }\n"
                           "      wgmma_fence_operand<NO>(o);\n      mbar_arrive(&empty[sp]);")],
    # p truncated to bf16 by a byte permute instead of cvt.rn (wrong rounding)
    "no_cvt": [(SRC, "pa[kk][r] = pack2_as<T>(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);",
                "pa[kk][r] = __byte_perm(__float_as_uint(sc[8 * kk + 2 * r]), "
                "__float_as_uint(sc[8 * kk + 2 * r + 1]), 0x7632);")],
    # O never rescaled (wrong results)
    "no_rescale": [(SRC, "(float* o, const float* alpha) {\n", "(float* o, const float* alpha) {\n  return;\n")],
    # a deeper K/V ring
    "more_stages": [(SRC, "NT = D == 64 ? 3 : 4;", "NT = D == 64 ? 5 : 6;")],
    # D 192 and 256: P V of a tile beside S of the next (at both), or right
    # after its own softmax (at both)
    "pv_behind": [(SRC, "static constexpr bool PV_BEHIND = D != 256;",
                   "static constexpr bool PV_BEHIND = true;")],
    "pv_after": [(SRC, "static constexpr bool PV_BEHIND = D != 256;",
                  "static constexpr bool PV_BEHIND = false;")],
    # past D 256 (flash_fwd_part_kernel): without S's products, without P
    # V's, and with neither nor the softmax (wrong results; times only)
    "part_no_s": [(SRC, "  for (int p = 0; p < panels; ++p) {", "  for (int p = 0; p < 0; ++p) {")],
    "part_no_pv": [(SRC, "  for (int kk = 0; kk < BK / 16; ++kk) {\n    const unsigned char* vk",
                    "  for (int kk = 0; kk < 0; ++kk) {\n    const unsigned char* vk")],
    "part_loads_only": [
        (SRC, "  for (int p = 0; p < panels; ++p) {", "  for (int p = 0; p < 0; ++p) {"),
        (SRC, "  for (int kk = 0; kk < BK / 16; ++kk) {\n    const unsigned char* vk",
         "  for (int kk = 0; kk < 0; ++kk) {\n    const unsigned char* vk"),
        (SRC, "float c) {\n  if (causal && k0", "float c) {\n  return;\n  if (causal && k0"),
        (SRC, "const float* alpha) {\n", "const float* alpha) {\n  return;\n"),
        (SRC, "const float* sc) {\n", "const float* sc) {\n  return;\n")],
    # past D 256: O rescaled on every key tile, not only where a row's max rose
    "part_always_rescale": [(SRC, "    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) "
                                  "rescale_o<NO>(o, alpha);", "    rescale_o<NO>(o, alpha);")],
    # f32 past D 256 (fwd_part_kernel): without S's products, without P V's
    "part_f32_no_s": [(TF32_SRC, "      for (int c = 0; c < a.D / 32; ++c)  // 32-column panels",
                       "      for (int c = 0; c < 0; ++c)  // 32-column panels")],
    "part_f32_no_pv": [(TF32_SRC, "    for (int kk = 0; kk < BK / 8; ++kk) {  // DCMAX / 2",
                        "    for (int kk = 0; kk < 0; ++kk) {  // DCMAX / 2")],
    # past D 512: parts of DC_LARGE columns (32-key tiles in 16-bit) at every
    # D, in place of flash_part.cuh's rule (the fewer parts, then the narrower)
    "part_dc_large": [("flash_part.cuh", "  p.dc = dc_of(D);\n",
                       "  p.dc = D <= DC_LARGE ? D : DC_LARGE;\n"),
                      ("flash_part.cuh", "  p.dcmax = dcmax_of(D);\n", "  p.dcmax = DC_LARGE;\n")],
    # 16-bit parts of up to 320 columns on 32-key tiles (as the 512-column
    # parts), in place of 64-key tiles
    "part_bk32": [("flash_part.cuh", "  p.bk = es == 4 ? 16 : p.dcmax == DC_SMALL ? 64 : 32;\n",
                   "  p.bk = es == 4 ? 16 : 32;\n"),
                  (SRC, "launch_part<T, fpart::DC_SMALL, 64, true>(c, p)",
                   "launch_part<T, fpart::DC_SMALL, 32, true>(c, p)")],
    # 128-key tiles at D 128 too (S, O and P then exceed the registers)
    "bkv128": [(SRC, "BKV = D == 64 ? 128 : 64;", "BKV = 128;"),
               (SRC, "NT = D == 64 ? 3 : 4;", "NT = D == 64 ? 3 : 2;")],
    # the backward past D 256 (flash_bwd_dq_part_kernel, flash_bwd_dkv_part_kernel):
    # without S's and dP's products, without the accumulated ones (dQ, dK,
    # dV), with neither (the loads, the hand-over and the element-wise work
    # left; wrong results, times only), or one kernel alone (the other's
    # outputs left as they are)
    "bwd_no_s": [(BWD_SRC, "  for (int kk = 0; kk < 4; ++kk)\n    wgmma_m64n64k16<T, 0>(x,",
                  "  for (int kk = 0; kk < 0; ++kk)\n    wgmma_m64n64k16<T, 0>(x,")],
    "bwd_no_acc": [(BWD_SRC, "    for (int kk = 0; kk < 4; ++kk)\n      wgmma_m64n64k16_rs<T, 1>(",
                    "    for (int kk = 0; kk < 0; ++kk)\n      wgmma_m64n64k16_rs<T, 1>(")],
    "bwd_loads_only": [
        (BWD_SRC, "  for (int kk = 0; kk < 4; ++kk)\n    wgmma_m64n64k16<T, 0>(x,",
         "  for (int kk = 0; kk < 0; ++kk)\n    wgmma_m64n64k16<T, 0>(x,"),
        (BWD_SRC, "    for (int kk = 0; kk < 4; ++kk)\n      wgmma_m64n64k16_rs<T, 1>(",
         "    for (int kk = 0; kk < 0; ++kk)\n      wgmma_m64n64k16_rs<T, 1>(")],
    "bwd_dkv_only": [(BWD_SRC, "  if (const int e = dkv(c)) return e;\n  return dq(c);",
                      "  return dkv(c);")],
    "bwd_dq_only": [(BWD_SRC, "  if (const int e = dkv(c)) return e;\n  return dq(c);",
                     "  return dq(c);")],
    # a producer warpgroup (384 threads) that lowers its registers to 24 a
    # thread, the consumers raised to 240 (setmaxnreg)
    "bwd_setmaxnreg": [
        (BWD_SRC, "constexpr int THREADS = 288;", "constexpr int THREADS = 384;"),
        (BWD_SRC, "// the producer warp: one thread issues every job\n",
         "// the producer warp: one thread issues every job\n"
         "    asm volatile(\"setmaxnreg.dec.sync.aligned.u32 24;\\n\" ::: \"memory\");\n"),
        (BWD_SRC, "  bpart::Ring rg{sm, p.ring};\n",
         "  asm volatile(\"setmaxnreg.inc.sync.aligned.u32 240;\\n\" ::: \"memory\");\n"
         "  bpart::Ring rg{sm, p.ring};\n")],
}
# (B, Tq, Tkv, NH, NKV, D, statistics): chip_smoke's four primal rows and its
# three statistics rows.
SHAPES = {
    "B1_T4096": (1, 4096, 4096, 32, 8, 64, False),
    "B4_T2048": (4, 2048, 2048, 32, 8, 64, False),
    "D128_T2048": (1, 2048, 2048, 24, 8, 128, False),
    "Tq512_Tkv2048": (1, 512, 2048, 32, 8, 64, False),
    "stats_B8_T1024": (8, 1024, 1024, 12, 12, 64, True),
    "stats_gqa_B2_T2048": (2, 2048, 2048, 32, 8, 64, True),
    "stats_D128_T2048": (1, 2048, 2048, 24, 8, 128, True),
    # chip_smoke's D 192 and 256 rows (Llama-3.2-1B's GQA heads at T 2048)
    "D192_T2048": (1, 2048, 2048, 16, 8, 192, False),
    "D256_T2048": (1, 2048, 2048, 16, 8, 256, False),
    "stats_D192_T2048": (1, 2048, 2048, 16, 8, 192, True),
    "stats_D256_T2048": (1, 2048, 2048, 16, 8, 256, True),
    # chip_smoke's rows past D 256 (flash_fwd_part_kernel)
    "stats_D320_T2048": (1, 2048, 2048, 16, 8, 320, True),
    "stats_D512_T2048": (1, 2048, 2048, 16, 8, 512, True),
    # two column parts (flash_part.cuh: dc_of): 320 + 256 and 320 + 320
    "stats_D576_T2048": (1, 2048, 2048, 16, 8, 576, True),
    "stats_D640_T2048": (1, 2048, 2048, 16, 8, 640, True),
    # --bwd: chip_smoke's backward rows past D 256, two dQ parts (D 576) and
    # operands streamed (D 1024)
    "bwd_D320_T2048": (1, 2048, 2048, 16, 8, 320, True),
    "bwd_D512_T2048": (1, 2048, 2048, 16, 8, 512, True),
    "bwd_D576_T2048": (1, 2048, 2048, 16, 8, 576, True),
    "bwd_D1024_T2048": (1, 2048, 2048, 16, 8, 1024, True),
}
SCRATCH = {}  # variant -> its library's flash_tf32_fwd_scratch


def build(names, sources=None, src=SRC) -> dict:
    """Compile a copy of ``src`` (flash_fwd.cu, or flash_tf32_fwd.cu for
    f32) per variant with its edits applied, or the given source (name ->
    path), the headers copied beside it, one nvcc each, all at once. Returns
    name -> (library's entry function, its name)."""
    procs = {}
    sources = sources or {}
    heads = {f.name: f.read_text() for f in _build.CSRC.glob("*.cuh")}
    for name in [*names, *sources]:
        vdir = _build.BUILD_DIR / f"flash_variant_{name}"
        vdir.mkdir(parents=True, exist_ok=True)
        if name in sources:  # its own headers where they sit beside it
            path = Path(sources[name])
            texts = {**heads, **{f.name: f.read_text() for f in path.parent.glob("*.cuh")},
                     src: path.read_text()}
        else:
            texts = {**heads, src: (_build.CSRC / src).read_text()}
            for fname, old, new in VARIANTS[name]:
                if fname.endswith(".cu") and fname != src:  # the edit of the other source
                    continue
                if old not in texts.get(fname, ""):
                    raise RuntimeError(f"variant {name}: {fname} (building {src}) has no {old!r}")
                texts[fname] = texts[fname].replace(old, new)
        for fname, text in texts.items():
            (vdir / fname).write_text(text)
        entry = next(e for e in ("flash_tf32_fwd", "flash_bwd", "flash_fwd")
                     if f'extern "C" int {e}(' in texts[src])
        procs[name] = (subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(vdir / "libflash.so"), str(vdir / src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT), entry)
    libs = {}
    for name, (proc, entry) in procs.items():
        log = proc.communicate()[0].decode()
        if proc.returncode:
            raise RuntimeError(f"variant {name}: nvcc failed\n{log[-3000:]}")
        ptxas = [ln.strip() for ln in log.splitlines()
                 if re.search(r"registers|spill|Compiling entry|warning|Performance Loss", ln)]
        print(json.dumps({"variant": name, "ptxas": ptxas}), flush=True)
        lib = ctypes.CDLL(str(_build.BUILD_DIR / f"flash_variant_{name}" / "libflash.so"))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn = getattr(lib, entry)
        if entry == "flash_tf32_fwd":  # a scratch pointer more, no type code
            fn.argtypes = [vp] * 7 + [ci] * 6 + [ctypes.c_float, ci, ci, vp]
            lib.flash_tf32_fwd_scratch.argtypes = [ci] * 4
            lib.flash_tf32_fwd_scratch.restype = ctypes.c_longlong
            SCRATCH[name] = lib.flash_tf32_fwd_scratch
        elif entry == "flash_bwd":
            fn.argtypes = [vp] * 12 + [ci] * 7 + [ctypes.c_float, ci, ci, vp]
        else:
            fn.argtypes = [vp] * 6 + [ci] * 7 + [ctypes.c_float, ci, ci, vp]
        fn.restype = ci
        libs[name] = (fn, entry)
    return libs


def time_ms(fn, launches: int = 10, repeats: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(repeats):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(launches):
            fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / launches)
    return statistics.median(out)


def row_err(got, want, floor: float = 0.0) -> float:
    """Worst row's max |got - want| over its max |want|, that scale floored at
    ``floor`` x the tensor's max |want| (dq of query 0 under the causal
    mask is exactly 0)."""
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        return float("inf")
    scale = want.abs().amax(-1).clamp_min(floor * want.abs().max().item() + 1e-30)
    return ((got - want).abs().amax(-1) / scale).max().item()


def main_bwd(libs, shapes, dtype, tag) -> None:
    """Per ``bwd_*`` shape, one JSON line: every variant's dq, dk, dv row
    errors and ms per call, and SDPA's backward alone."""
    from mila_tpu_torch.kernels import flash_attention_bwd as fb

    rng = np.random.default_rng(0)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for name in shapes:
        B, Tq, Tkv, NH, NKV, D, _ = SHAPES[name]
        q, k, v, do = (torch.from_numpy(rng.standard_normal((B, T, n, D)).astype(np.float32))
                       .to("cuda", dtype) for T, n in ((Tq, NH), (Tkv, NKV), (Tkv, NKV), (Tq, NH)))
        sm = D ** -0.5
        o, l, m = fa.flash_attention_forward(q, k, v, causal=True, sm_scale=sm)
        hm = [t.transpose(1, 2) for t in (q, k, v, o, do)]
        want = fb.flash_attention_bwd_plain(*hm[:4], l, m, hm[4], causal=True, sm_scale=sm)
        tq64 = -(-Tq // 64) * 64
        lse2, delta = (torch.empty(B, NH, tq64, device="cuda") for _ in range(2))
        outs = [torch.empty_like(t) for t in (q, k, v)]
        pairs = B * NH * sum(min(Tkv, i + 1) for i in range(Tq))
        row = {"shape": name, "dtype": tag, "card": torch.cuda.get_device_name(0)}
        for vname, (fn, _) in libs.items():
            def call(fn=fn, vname=vname):
                rc = fn(*(_build.ptr(t) for t in (q, k, v, o, do, l, m, lse2, delta, *outs)),
                        B, Tq, Tkv, NH, NKV, D, _build.DTYPE_CODES[dtype], sm, 0, 1,
                        _build.stream_of(q))
                if rc:
                    raise RuntimeError(f"{vname}: CUDA error {rc}")
            for t in outs:
                t.fill_(float("nan"))
            call()
            torch.cuda.synchronize()
            errs = {n: row_err(a, b.transpose(1, 2), floor=1e-3)
                    for n, a, b in zip(("dq", "dk", "dv"), outs, want)}
            ms = time_ms(call)
            row[vname] = {**errs, "ms": ms, "tflops": 10 * D * pairs / (ms * 1e-3) / 1e12}
        leaves = [t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v)]
        s_out = sdpa(*leaves, is_causal=True, enable_gqa=NH != NKV)
        dos = do.transpose(1, 2).contiguous()
        row["sdpa_bwd_ms"] = time_ms(
            lambda: torch.autograd.grad(s_out, leaves, dos, retain_graph=True))
        print(json.dumps(row), flush=True)
        del q, k, v, do, o, l, m, hm, want, outs, leaves, s_out, dos


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS), choices=list(VARIANTS))
    ap.add_argument("--shapes", nargs="+", default=list(SHAPES), choices=list(SHAPES))
    ap.add_argument("--source", nargs="*", default=[], metavar="NAME=PATH",
                    help="a whole other flash_fwd.cu or flash_tf32_fwd.cu, timed as NAME")
    ap.add_argument("--dtype", default="bf16", choices=["bf16", "fp16", "f32"])
    ap.add_argument("--bwd", action="store_true",
                    help="the 16-bit backward past D 256 (csrc/flash_bwd.cu) and its variants")
    args = ap.parse_args()
    dtype = {"bf16": torch.bfloat16, "fp16": torch.float16, "f32": torch.float32}[args.dtype]
    if args.bwd:
        if dtype == torch.float32:
            raise SystemExit("--bwd: the 16-bit backward (bf16 or fp16)")
        shapes = [s for s in args.shapes if s.startswith("bwd_")]
        variants = [v for v in args.variants if v == "committed" or v.startswith("bwd_")]
        libs = build(variants, dict(s.split("=", 1) for s in args.source), BWD_SRC)
        main_bwd(libs, shapes, dtype, args.dtype)
        return
    libs = build([v for v in args.variants if not v.startswith("bwd_")],
                 dict(s.split("=", 1) for s in args.source),
                 TF32_SRC if dtype == torch.float32 else SRC)
    rng = np.random.default_rng(0)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for name in (s for s in args.shapes if not s.startswith("bwd_")):
        B, Tq, Tkv, NH, NKV, D, stats = SHAPES[name]
        off = Tkv - Tq
        q, k, v = (torch.from_numpy(rng.standard_normal((B, T, n, D)).astype(np.float32))
                   .to("cuda", dtype) for T, n in ((Tq, NH), (Tkv, NKV), (Tkv, NKV)))
        sm = D ** -0.5
        o_ref, l_ref, m_ref = fa.flash_attention_plain(q, k, v, scale=sm, kv_offset=off,
                                                       save_stats=True)
        out = torch.empty_like(q)
        l = torch.empty(B, NH, Tq, device="cuda") if stats else None
        m = torch.empty_like(l) if stats else None
        stream = _build.stream_of(q)
        pairs = B * NH * sum(min(Tkv, i + off + 1) for i in range(Tq))
        row = {"shape": name, "dtype": args.dtype, "card": torch.cuda.get_device_name(0)}
        for vname, (fn, entry) in libs.items():
            lm = (None if l is None else _build.ptr(l), None if m is None else _build.ptr(m))
            if entry == "flash_tf32_fwd":
                scratch = torch.empty(SCRATCH[vname](B, Tkv, NKV, D), device="cuda")
                head, mid = (*lm, _build.ptr(scratch)), ()
            else:
                head, mid = lm, (_build.DTYPE_CODES[dtype],)

            def call(fn=fn, vname=vname, head=head, mid=mid):
                rc = fn(_build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out), *head,
                        B, Tq, Tkv, NH, NKV, D, *mid, sm, off, 1, stream)
                if rc:
                    raise RuntimeError(f"{vname}: CUDA error {rc}")
            for t in (out, l, m):  # nothing left over from the variant before
                if t is not None:
                    t.fill_(float("nan"))
            call()
            torch.cuda.synchronize()
            res = {"entry": entry, "row_err": row_err(out, o_ref)}  # inf if not finite
            if stats:
                res["l_rel_err"] = ((l - l_ref).abs() / l_ref).max().item()
                res["m_abs_err"] = (m - m_ref).abs().max().item()
            res["ms"] = time_ms(call)
            res["tflops"] = 4 * D * pairs / (res["ms"] * 1e-3) / 1e12
            row[vname] = res
        qs, ks, vs = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        cm = None if off == 0 else causal_mask(Tq, Tkv, off, device="cuda")
        row["sdpa_ms"] = time_ms(lambda: sdpa(qs, ks, vs, attn_mask=cm, is_causal=cm is None,
                                              enable_gqa=NH != NKV))
        print(json.dumps(row), flush=True)
        del q, k, v, o_ref, l_ref, m_ref, out, qs, ks, vs


if __name__ == "__main__":
    main()
