"""Time each phase of the layer-tail kernel (``csrc/layer_tail_int8.cu`` with
``csrc/tail_phases.cuh``) on
the GPU, at Llama-3.2-1B's tail (H 2048, I 8192, wqkv 3072 columns, bn 512,
M 8, random int8 weights).

    python -m mila_tpu_torch.tools.tail_phases [--min-blocks 2 3] [--plan one-round fill]

It compiles a copy of the kernel in which block 0 stamps ``%globaltimer``
after every grid barrier (into ``csrc/build/``), runs the tail 12 times per
variant and prints, per variant, one JSON line with the median µs of each
phase (wo, fin1, gu, fin_h, down, fin2, qkv, fin3) and in all, then the time
of a launch of grid barriers alone (1 and 8 of them). Variants: the
registers bounded for ``--min-blocks`` resident blocks per SM, and the K
slice plan: ``one-round`` (the committed ``plan_tail``: at most one unit per
block) or ``fill`` (the fewest slices that give every block a unit).
Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess

import numpy as np
import torch

from mila_tpu_torch.inference.quantize import quantize
from mila_tpu_torch.kernels import _build
from mila_tpu_torch.kernels import layer_fused as lf
from mila_tpu_torch.kernels import layer_stream as ls

PHASES = ("wo", "fin1", "gu", "fin_h", "down", "fin2", "qkv", "fin3")
_STAMP = ('__device__ unsigned long long g_trace[32];\n'
          '__device__ __forceinline__ void stamp(int i) {\n'
          '  if (blockIdx.x == 0 && threadIdx.x == 0) {\n'
          '    unsigned long long t;\n'
          '    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));\n'
          '    g_trace[i] = t;\n  }\n}\n')
_EXTRA = '''
__global__ void barriers_only(int n) {
  cg::grid_group g = cg::this_grid();
  for (int i = 0; i < n; ++i) g.sync();
}
extern "C" int run_barriers(int grid, int n, void* stream) {
  void* args[] = {&n};
  return (int)cudaLaunchCooperativeKernel((const void*)barriers_only, dim3(grid), dim3(256),
                                          args, 0, (cudaStream_t)stream);
}
extern "C" void get_trace(unsigned long long* out) {
  cudaMemcpyFromSymbol(out, g_trace, sizeof(unsigned long long) * 32);
}
'''


def stamped_source() -> str:
    """layer_tail_int8.cu with tail_phases.cuh inlined and a stamp after
    every barrier, numbered in the order a layer meets them (qkv_phases,
    defined first, holds the seventh)."""
    head = (_build.CSRC / "tail_phases.cuh").read_text()
    head = head.replace('#include "common.cuh"',
                        f'#include "{_build.CSRC / "common.cuh"}"\n{_STAMP}')
    split = head.index("__device__ void tail_phases")
    first, rest = head[:split], head[split:]
    first = first.replace("grid.sync();", "grid.sync(); stamp(7);")
    count = iter(range(1, 7))
    rest = re.sub(r"grid\.sync\(\);", lambda _: f"grid.sync(); stamp({next(count)});", rest)
    head = first + rest
    head = head.replace("  // 1 wo.", "  stamp(0);\n  // 1 wo.")
    head = head.replace("  if (p.n_qkv == 0) return;",
                        "  if (p.n_qkv == 0) { stamp(20); return; }")
    head = head.replace("    qkv[i] = from_f<T>(v);\n  }\n}",
                        "    qkv[i] = from_f<T>(v);\n  }\n  stamp(20);\n}")
    if head.count("stamp(") < 10:
        raise RuntimeError("the kernel source no longer has the expected phase markers")
    src = (_build.CSRC / "layer_tail_int8.cu").read_text()
    return src.replace('#include "tail_phases.cuh"', head) + _EXTRA


def build(min_blocks) -> dict:
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = _build.BUILD_DIR / "tail_phases.cu"
    cu.write_text(stamped_source())
    procs = {}
    for mb in min_blocks:
        out = _build.BUILD_DIR / f"libtail_phases_{mb}.so"
        procs[mb] = (out, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, f"-DTAIL_MIN_BLOCKS={mb}", "-o", str(out),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for mb, (out, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed:\n{log[-3000:]}")
        lib = ctypes.CDLL(str(out))
        lib.layer_tail_int8.argtypes = lf._lib().layer_tail_int8.argtypes
        lib.layer_tail_int8.restype = ctypes.c_int
        lib.layer_tail_int8_blocks_per_sm.argtypes = [ctypes.c_int, ctypes.c_int,
                                                      ctypes.POINTER(ctypes.c_int)]
        lib.layer_tail_int8_blocks_per_sm.restype = ctypes.c_int
        lib.get_trace.argtypes = [ctypes.c_void_p]
        lib.run_barriers.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib._typed = True
        libs[mb] = lib
    return libs


def fill_plan(M, H, bn, tiles, grid):
    """The fewest power-of-two K slices that give every block a unit."""
    mt = 8 if M <= 8 else 32
    ks = {}
    for name, n in tiles.items():
        k = 1
        while H % (2 * k) == 0 and H // (2 * k) >= 64 and (
                (H // k) * mt * 4 > 32 * 1024 or n * (bn // 128) * k < grid):
            k *= 2
        ks[name] = k
    return mt, ks


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--min-blocks", type=int, nargs="+", default=[2])
    ap.add_argument("--plan", nargs="+", default=["one-round"], choices=["one-round", "fill"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("tail_phases needs a CUDA device")
    libs = build(args.min_blocks)
    rng = np.random.default_rng(0)

    def w(*shape):
        return quantize(torch.from_numpy((rng.standard_normal(shape) * 0.05).astype(
            np.float32)).cuda(), "int8")

    H, I, NQ, bn, M = 2048, 8192, 3072, 512, 8
    ws = [(w(H, H), w(H, 2 * I), w(I, H), w(H, NQ)) for _ in range(3)]
    packs = [lf.pack_layer(*ws[i][:3], ws[i + 1][3] if i < 2 else None, bn=bn)
             for i in range(3)]
    stream = ls.pack_layer_stream(packs)
    att = torch.randn(M, 1, H, device="cuda").bfloat16()
    x = torch.randn(M, 1, H, device="cuda").bfloat16()
    g = torch.ones(H, device="cuda")
    plans = {"one-round": lf.plan_tail, "fill": fill_plan}
    card = torch.cuda.get_device_name(0)
    committed = (lf._lib, lf.plan_tail, lf._BLOCKS_PER_SM)
    try:
        for mb, lib in libs.items():
            for name in args.plan:
                lf._lib, lf.plan_tail, lf._BLOCKS_PER_SM = (lambda lib=lib: lib), plans[name], mb
                lf._grid.cache_clear()
                rows = []
                for rep in range(12):
                    ls.layer_tail_stream(att, x, g, stream, rep % 2, g)
                    torch.cuda.synchronize()
                    tr = (ctypes.c_ulonglong * 32)()
                    lib.get_trace(tr)
                    t = [tr[i] for i in range(8)] + [tr[20]]
                    rows.append([(t[i + 1] - t[i]) / 1e3 for i in range(8)] + [(t[8] - t[0]) / 1e3])
                med = np.median(np.array(rows[2:]), axis=0)
                print(json.dumps({"card": card, "min_blocks": mb, "plan": name,
                                  "grid": lf._grid(0, 8, 0), "total_us": med[-1],
                                  **{p: v for p, v in zip(PHASES, med[:-1])}}), flush=True)
    finally:
        lf._lib, lf.plan_tail, lf._BLOCKS_PER_SM = committed
        lf._grid.cache_clear()
    lib = next(iter(libs.values()))
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
