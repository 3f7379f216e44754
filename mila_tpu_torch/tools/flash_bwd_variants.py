"""Check and time the flash-attention backward (``csrc/flash_bwd.cu``) and
variants of it, on the GPU, at the shapes ``chip_smoke.py`` gives its
``kernels train`` rows.

    python -m mila_tpu_torch.tools.flash_bwd_variants [--variants committed ...]
        [--source NAME=PATH ...] [--shapes ...] [--dtype bf16|fp16|f32]

``--dtype f32`` (or ``--family sync``, with bf16 or fp16 past D 256) times
``csrc/flash_sync_bwd.cu`` (entry ``flash_sync_bwd``; its variants are
``F32_VARIANTS``) in place of ``csrc/flash_bwd.cu``, and ``--source`` then
names whole other ``flash_sync_bwd.cu`` files (with the ``*.cuh`` files beside them, where
there are any, in place of the package's). Each variant is a copy of the
source (and its headers) with edits,
compiled with the package's nvcc flags into ``csrc/build/``; ``onepass``
is ``flash_bwd_onepass.cu`` beside this tool (dQ from the dK/dV pass
through f32 atomics); ``--source`` adds a whole other source as a variant
(an earlier stage of the kernel,
e.g. ``git show <commit>:mila_tpu_torch/csrc/flash_bwd.cu > stage.cu``, in
a directory ``.gitignore`` lists). A source whose ``flash_bwd`` takes the
precomputed D (the design before the statistics launch) is timed with D
computed by PyTorch inside the timed call, as its wrapper did. Each
variant's ptxas report (registers, spills per kernel) is printed first.
Per shape one JSON line: each variant's worst row error of dq, dk and dv
against the plain version (each (b, t, head) row against its own largest
value, floored at 1e-3 of the tensor's), its median ms per call (CUDA
events around 20 back-to-back calls, 5 repeats) and causal TFLOP/s (10 D
operations per visible pair and head), beside SDPA's backward alone timed
the same way (``autograd.grad`` with ``retain_graph`` on one saved
forward); and, for SDPA's backward and every variant, the device's own
time per call from the profiler's kernel times (``autograd.grad`` can
leave the card waiting on the host). Needs a CUDA device and nvcc.
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
from mila_tpu_torch.kernels import flash_attention_bwd as fb

SRC = "flash_bwd.cu"
SYNC_SRC = "flash_sync_bwd.cu"  # the f32 backward (--dtype f32)
DKV_LAUNCH = "  kern<<<dim3(c.NKV, c.B, (c.Tkv + KC::BK - 1) / KC::BK)"
DQ_LAUNCH = "  kern<<<grid, C::THREADS"
SPLIT_RULE = "const bool split = (long long)c.B * c.NKV * ((c.Tkv + BK - 1) / BK) < 2LL * n_sm;"
# (file, old, new) edits that drop one part (wrong results: only their
# times mean anything)
NO_EX2 = [(SRC, "float p = ex2(fmaf(sc[e], c, -((i & 1) ? ls.y : ls.x)));",
           "float p = fmaf(sc[e], c, -((i & 1) ? ls.y : ls.x));"),
          (SRC, "float p = ex2(fmaf(sc[e], c, -lse2[hr]));", "float p = fmaf(sc[e], c, -lse2[hr]);")]
NO_MMA = [(SRC, "for (int kk = 0; kk < D / 16; ++kk) {", "for (int kk = 0; kk < 0; ++kk) {"),
          (SRC, "for (int kk = 0; kk < 4; ++kk) {\n    const uint64_t bd",
           "for (int kk = 0; kk < 0; ++kk) {\n    const uint64_t bd")]
NO_ELEMENTWISE = [(SRC, "const float* st,\n                                         float scale) {\n",
                   "const float* st,\n                                         float scale) {\n"
                   "  return;\n"),
                  (SRC, "const float* dl, float scale) {\n",
                   "const float* dl, float scale) {\n  return;\n"),
                  (SRC, "const float* d) {\n", "const float* d) {\n  return;\n")]
DQ_WARP = "static constexpr bool WARP = D != 128;"
SPLIT_TRUE = [(SRC, SPLIT_RULE, "const bool split = true;")]
SPLIT_FALSE = [(SRC, SPLIT_RULE, "const bool split = false;")]
# At D 192 and 256 (the COLS block shape): both warpgroups form S^T and dP^T
# in full (the generic sweep, each warpgroup's dV and dK on its own columns)
# instead of forming them once and sharing them through shared memory (the
# committed loop).
BOTH_ST = [(SRC, "  if constexpr (C::COLS) {\n    // S^T and dP^T formed once",
            "  if constexpr (false) {\n    // S^T and dP^T formed once"),
           (SRC, "      issue_ab<T, D>(dv, pa, os + s * Q_TILE, PANEL64);  // dV += P^T dO\n"
                 "      issue_ab<T, D>(dk, da, qs + s * Q_TILE, PANEL64);  // dK += dS^T Q",
            "      const unsigned char* ot = os + s * Q_TILE + (cw / 64) * PANEL64;\n"
            "      const unsigned char* qt = qs + s * Q_TILE + (cw / 64) * PANEL64;\n"
            "      if (C::NC1 != C::NC0 && wg) {\n"
            "        issue_ab<T, C::NC1>(dv, pa, ot, PANEL64);\n"
            "        issue_ab<T, C::NC1>(dk, da, qt, PANEL64);\n"
            "      } else {\n"
            "        issue_ab<T, C::NC0>(dv, pa, ot, PANEL64);\n"
            "        issue_ab<T, C::NC0>(dk, da, qt, PANEL64);\n"
            "      }")]
VARIANTS = {  # name -> [(file, old text, new text)]
    "committed": [],
    # one pass at a time (the statistics launch always runs)
    "stats_only": [(SRC, DQ_LAUNCH, "  if (0)" + DQ_LAUNCH[1:]),
                   (SRC, DKV_LAUNCH, "  if (0)" + DKV_LAUNCH[1:])],
    "no_dkv": [(SRC, DKV_LAUNCH, "  if (0)" + DKV_LAUNCH[1:])],
    "no_dq": [(SRC, DQ_LAUNCH, "  if (0)" + DQ_LAUNCH[1:])],
    # what each part costs: no exponentials (the FFMA stays), no products,
    # no element-wise work (p, ds and their packing), neither (the rings)
    "no_ex2": NO_EX2,
    "no_mma": NO_MMA,
    "no_elementwise": NO_ELEMENTWISE,
    "loads_only": NO_MMA + NO_ELEMENTWISE,
    # the dK/dV pass's block shape forced: 64 keys, the warpgroups taking
    # the sweep's steps in turn, or 64 keys per warpgroup
    "dkv_split": SPLIT_TRUE,
    "dkv_shared": SPLIT_FALSE,
    # the dQ pass: no turns; a producer warp (288 threads) at both head
    # sizes; none (256 threads) at both
    "dq_no_turns": [(SRC, "{ named_bar_sync(SCHED + wg, 256); }", "{}"),
                    (SRC, "{ named_bar_arrive(SCHED + 1 - wg, 256); }", "{}")],
    "dq_warp": [(SRC, DQ_WARP, "static constexpr bool WARP = true;")],
    "dq_no_warp": [(SRC, DQ_WARP, "static constexpr bool WARP = false;")],
    # the dK/dV pass at D 64: two consumer warpgroups (as at D 128); a
    # ring of 9 stages (3 per warpgroup)
    "dkv_2wg": [(SRC, "NWG = D == 64 ? 3 : 2;", "NWG = 2;"),
                (SRC, "NT = D == 64 ? 6 :", "NT = D == 64 ? 8 :")],
    "dkv_nt9": [(SRC, "NT = D == 64 ? 6 :", "NT = D == 64 ? 9 :")],
    # D 192 and 256: S^T and dP^T formed by both warpgroups (BOTH_ST above)
    "dkv_both_st": BOTH_ST,
}
# --dtype f32: edits of flash_sync_bwd.cu (same form). Past D 256 (the split
# kernels): no S / dP products, no dQ (dK, dV) products, no copies from
# device memory (the ring's slots filled by stores, the staging stays);
# wrong results, only their times mean anything.
SYNC = "flash_sync_bwd.cu"
F32_VARIANTS = {
    "committed": [],
    "no_s_mma": [(SYNC, "    wgmma_m64n32k8_tf32(s, slice(q, kk), slice(k, kk), 1);\n"
                        "    wgmma_m64n32k8_tf32(acc, slice(oh, kk), slice(vh, kk), 1);\n"
                        "    wgmma_m64n32k8_tf32(acc, slice(oh, kk), slice(vl, kk), 1);\n"
                        "    wgmma_m64n32k8_tf32(acc, slice(ol, kk), slice(vh, kk), 1);\n", "")],
    "no_chunk_mma": [(SYNC, "          for (int rb = 0; rb < 2; ++rb) mma_tf32(dq[rb][ni], da[rb], bk);",
                      "          for (int rb = 0; rb < 0; ++rb) mma_tf32(dq[rb][ni], da[rb], bk);"),
                     (SYNC, "          mma_tf32(dv[ni], pa, bo);\n          mma_tf32(dk[ni], da, bq);\n",
                      "")],
    "no_loads": [(SYNC, "        cp_async16(d, from + (size_t)(r0 + r) * stride + c);",
                  "        *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, (float)r);")],
    # no staging of the panels (wgmma reads the staging tiles as they are)
    "no_stage": [(SYNC, "    static_assert(W == 32, \"swizzled rows are 128 bytes\");\n",
                  "    static_assert(W == 32, \"swizzled rows are 128 bytes\");\n    return;\n")],
    # dS (P^T, dS^T) without its exponential and division; none at all
    "cheap_ds": [(SYNC, "p = expf(s[e] * a.sm_scale - mr[hr]) * il[hr];",
                  "p = s[e] * a.sm_scale - mr[hr];")],
    "no_ds": [(SYNC, "    for (int jj = 0; jj < 4; ++jj)\n#pragma unroll\n      for (int hr = 0; hr < 2; ++hr) {",
               "    for (int jj = 0; jj < 0; ++jj)\n#pragma unroll\n      for (int hr = 0; hr < 2; ++hr) {")],
}
F32_VARIANTS["no_math"] = F32_VARIANTS["no_s_mma"] + F32_VARIANTS["no_chunk_mma"]
# Whole other sources kept beside this tool, timed like --source ones.
SOURCE_VARIANTS = {"onepass": Path(__file__).with_name("flash_bwd_onepass.cu")}
# (B, T, NH, NKV, D): chip_smoke's three flash backward rows, all causal.
SHAPES = {
    "B8_T1024": (8, 1024, 12, 12, 64),
    "gqa_B2_T2048": (2, 2048, 32, 8, 64),
    "D128_T2048": (1, 2048, 24, 8, 128),
    "D192_T2048": (1, 2048, 16, 8, 192),
    "D256_T2048": (1, 2048, 16, 8, 256),
    "D320_T2048": (1, 2048, 16, 8, 320),
    "D512_T2048": (1, 2048, 16, 8, 512),
    "D1024_T2048": (1, 2048, 16, 8, 1024),
}
NEW_ABI = "void* lse2"  # the entry takes the statistics scratch, not D
DTYPE_ABI = "int D, int dtype"  # the entry takes a type code after D


def ptxas_report(log: str) -> dict:
    """{"<kernel> D<d>[ split|shared]": "<registers> registers; <spills>"}
    from nvcc's -Xptxas -v output (kernels named flash_bwd_<kernel>_kernel<D[,
    SPLIT]>; flash_sync_bwd.cu's <kernel>_kernel<type[, D]> as "<kernel>
    <type>[ D<d>]")."""
    out, entry = {}, None
    types = {"6__half": " fp16", "f": " f32", None: ""}
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '.*?\dflash_bwd_(\w+?)_kernelI"
                      r"(13__nv_bfloat16|6__half)?Li(\d+)E(Lb(\d))?", ln)
        ms = re.search(r"Compiling entry function '.*?\d(\w+?)_kernelI"
                       r"(f|13__nv_bfloat16|6__half|Li(\d+)E)(Li(\d+)E)?", ln)
        if m:
            ty = types.get(m.group(2), " bf16")
            entry = f"{m.group(1)}{ty} D{m.group(3)}" + (
                "" if m.group(4) is None else " split" if m.group(5) == "1" else " shared")
        elif ms and ms.group(3) is not None:  # split kernels: <columns a block>
            entry = f"{re.sub(r'.*[0-9]', '', ms.group(1))} f32 DC{ms.group(3)}"
        elif ms:
            entry = f"{re.sub(r'.*[0-9]', '', ms.group(1))}{types.get(ms.group(2), ' bf16')}" + (
                "" if ms.group(5) is None else f" D{ms.group(5)}")
        elif entry and "spill" in ln:
            out[entry] = ln.strip()
        elif entry and "registers" in ln:
            out[entry] = re.search(r"Used \d+ registers", ln).group(0) + "; " + out.get(entry, "")
        elif "warning" in ln or "Performance Loss" in ln:  # e.g. wgmma serialized
            out.setdefault("warnings", []).append(ln.strip())
    return out


def build(names, sources, sync: bool = False) -> dict:
    """Compile a copy of flash_bwd.cu (flash_sync_bwd.cu with ``sync``) per
    variant with its edits applied (or the given source), the headers copied
    beside it, one nvcc each, all at once. Returns name -> (library, takes
    the statistics scratch, takes a type code); sync libraries export
    flash_sync_bwd."""
    procs = {}
    src, edits = (SYNC_SRC, F32_VARIANTS) if sync else (SRC, VARIANTS)
    heads = {f.name: f.read_text() for f in _build.CSRC.glob("*.cuh")}
    for name in [*names, *sources]:
        vdir = _build.BUILD_DIR / f"flash_bwd_variant_{name}"
        vdir.mkdir(parents=True, exist_ok=True)
        if name in sources:  # its own headers where they sit beside it
            path = Path(sources[name])
            texts = {**heads, **{f.name: f.read_text() for f in path.parent.glob("*.cuh")},
                     src: path.read_text()}
        else:
            texts = {**heads, src: (_build.CSRC / src).read_text()}
            for fname, old, new in edits[name]:
                fname = src if fname == SRC else fname
                if old not in texts[fname]:
                    raise RuntimeError(f"variant {name}: {fname} no longer has {old!r}")
                texts[fname] = texts[fname].replace(old, new)
        for fname, text in texts.items():
            (vdir / fname).write_text(text)
        procs[name] = (subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(vdir / "libflash_bwd.so"),
             str(vdir / src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT),
            (NEW_ABI in texts[src], DTYPE_ABI in texts[src]))
    libs = {}
    for name, (proc, (new_abi, typed)) in procs.items():
        log = proc.communicate()[0].decode()
        if proc.returncode:
            raise RuntimeError(f"variant {name}: nvcc failed\n{log[-3000:]}")
        print(json.dumps({"variant": name, "ptxas": ptxas_report(log)}), flush=True)
        lib = ctypes.CDLL(str(_build.BUILD_DIR / f"flash_bwd_variant_{name}" / "libflash_bwd.so"))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        if sync:
            lib.flash_sync_bwd.argtypes = [vp] + [ci] * 7 + [ctypes.c_float, ci, ci, vp]
            lib.flash_sync_bwd.restype = ci
        else:
            lib.flash_bwd.argtypes = ([vp] * (12 if new_abi else 10) + [ci] * (7 if typed else 6)
                                      + [ctypes.c_float, ci, ci, vp])
            lib.flash_bwd.restype = ci
        libs[name] = (lib, new_abi, typed)
    return libs


def time_ms(fn, calls: int = 20, repeats: int = 5) -> float:
    """Median over ``repeats`` of the ms per call of ``calls`` back-to-back
    calls between CUDA events."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(repeats):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / calls)
    return statistics.median(out)


def device_ms(fn, calls: int = 20) -> dict:
    """ms of device work per call of ``fn``, from the profiler's kernel
    times over ``calls`` calls (the host's pace left out): {"total": ...,
    "<kernel name>": ...}."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    per = {e.key[:60]: e.self_device_time_total / 1e3 / calls for e in prof.key_averages()
           if e.self_device_time_total > 0}
    return {"total": sum(per.values()), **per}


def row_err(got, want, floor: float = 1e-3) -> float:
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        return float("inf")
    d = (got - want).abs().amax(-1)
    scale = want.abs().amax(-1).clamp_min(floor * want.abs().max().item() + 1e-30)
    return (d / scale).max().item()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", nargs="+", default=None,
                    choices=[*VARIANTS, *F32_VARIANTS, *SOURCE_VARIANTS],
                    help="default: every variant of the type's source")
    ap.add_argument("--source", nargs="*", default=[], metavar="NAME=PATH",
                    help="a whole other flash_bwd.cu (flash_sync_bwd.cu with --dtype f32), "
                         "timed as a variant named NAME")
    ap.add_argument("--shapes", nargs="+", default=list(SHAPES), choices=list(SHAPES))
    ap.add_argument("--dtype", default="bf16", choices=["bf16", "fp16", "f32"],
                    help="the inputs' type (a source that takes no type code runs bf16 only)")
    ap.add_argument("--family", default=None, choices=["wgmma", "sync"],
                    help="flash_bwd.cu (wgmma, bf16 and fp16 up to D 256) or flash_sync_bwd.cu "
                         "(sync; f32's only one)")
    args = ap.parse_args()
    dtype = {"bf16": torch.bfloat16, "fp16": torch.float16, "f32": torch.float32}[args.dtype]
    sync = dtype == torch.float32 or args.family == "sync"  # flash_sync_bwd.cu
    edits = F32_VARIANTS if sync else VARIANTS
    variants = list(edits) if args.variants is None else args.variants
    sources = dict(s.split("=", 1) for s in args.source)
    sources.update({n: SOURCE_VARIANTS[n] for n in variants if n in SOURCE_VARIANTS and not sync})
    libs = build([n for n in variants if n in edits], sources, sync)
    rng = np.random.default_rng(0)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for name in args.shapes:
        B, T, NH, NKV, D = SHAPES[name]
        q, k, v, do = (torch.from_numpy(rng.standard_normal((B, T, n, D)).astype(np.float32))
                       .to("cuda", dtype) for n in (NH, NKV, NKV, NH))
        sm = D ** -0.5
        o, l, m = fa.flash_attention_forward(q, k, v, causal=True, sm_scale=sm)
        hm = [t.transpose(1, 2) for t in (q, k, v, o, do)]
        want = [t.transpose(1, 2) for t in fb.flash_attention_bwd_plain(
            *hm[:4], l, m, hm[4], causal=True, sm_scale=sm)]
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        tq64 = -(-T // 64) * 64
        lse2 = torch.empty(B, NH, tq64, device="cuda")
        delta = torch.empty_like(lse2)
        stream = _build.stream_of(q)
        pairs = B * NH * T * (T + 1) // 2
        row = {"shape": name, "dtype": args.dtype, "card": torch.cuda.get_device_name(0)}
        for vname, (lib, new_abi, typed) in libs.items():
            def call(lib=lib, new_abi=new_abi, typed=typed, vname=vname):
                if sync:  # flash_sync_bwd: one pointer array, D scratch [B, NH, T]
                    ptrs = (ctypes.c_void_p * 11)(*(t.data_ptr() for t in (
                        q, k, v, o, do, l, m, delta, dq, dk, dv)))
                    rc = lib.flash_sync_bwd(ptrs, B, T, T, NH, NKV, D, _build.DTYPE_CODES[dtype],
                                            sm, 0, 1, stream)
                    if rc:
                        raise RuntimeError(f"{vname}: CUDA error {rc}")
                    return
                if new_abi:
                    ptrs = (q, k, v, o, do, l, m, lse2, delta, dq, dk, dv)
                else:  # D by PyTorch, as the wrapper of that design did
                    dl = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
                    ptrs = (q, k, v, do, m, l, dl, dq, dk, dv)
                code = (_build.DTYPE_CODES[dtype],) if typed else ()
                rc = lib.flash_bwd(*(_build.ptr(t) for t in ptrs), B, T, T, NH, NKV, D, *code, sm,
                                   0, 1, stream)
                if rc:
                    raise RuntimeError(f"{vname}: CUDA error {rc}")
            for t in (dq, dk, dv):  # nothing left over from the variant before
                t.fill_(float("nan"))
            call()
            torch.cuda.synchronize()
            res = {f"{n}_row_err": row_err(a, b) for n, a, b in zip(("dq", "dk", "dv"),
                                                                   (dq, dk, dv), want)}
            res["ms"] = time_ms(call)
            res["tflops"] = 10 * D * pairs / (res["ms"] * 1e-3) / 1e12
            res["device_ms"] = device_ms(call)
            row[vname] = res
        leaves = [t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v)]
        s_out = sdpa(*leaves, is_causal=True, enable_gqa=NH != NKV)
        dos = do.transpose(1, 2).contiguous()

        def sdpa_bwd():
            return torch.autograd.grad(s_out, leaves, dos, retain_graph=True)

        row["sdpa_bwd_ms"] = time_ms(sdpa_bwd)
        row["sdpa_bwd_device_ms"] = device_ms(sdpa_bwd)
        print(json.dumps(row), flush=True)
        del q, k, v, do, o, l, m, hm, want, dq, dk, dv, leaves, s_out, dos


if __name__ == "__main__":
    main()
