"""Time the prefill GEMM (``csrc/qmm_int8.cu``) and variants of it that drop
one stage of its pipeline, on the GPU, at Llama-3.2-1B's prefill
projections for 1024 rows (random int8 weights, per-channel scales).

    python -m mila_tpu_torch.tools.qmm_variants [--shapes wgu down]

Each variant is a copy of the source (and its headers) with edits,
compiled with the package's nvcc flags into ``csrc/build/``: ``committed``
(none), ``no_convert`` (no int8 -> bf16 pass), ``no_mma`` (no wgmma),
``loads_only`` (neither: the TMA ring alone), ``bn128`` / ``bn256`` (one
tile width for every shape). Only ``bn128`` and ``bn256`` compute the
product; the others are wrong by design and only their times mean
anything. Per shape it prints one JSON line with the median ms of a launch
of each variant (CUDA events over 20 launches, cycling over 3 weight
copies, 5 repeats) beside ``torch.matmul`` on the weight in bf16. Needs a
CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess

import torch

from mila_tpu_torch.kernels import _build

SHAPES = {"wqkv": (2048, 3072), "wo": (2048, 2048), "wgu": (2048, 16384), "down": (8192, 2048)}
QMM = "qmm_int8.cu"
VARIANTS = {  # name -> [(file, old text, new text)]
    "committed": [],
    "no_convert": [(QMM, "it < BK * BN / 16 / CONSUMERS", "it < 0")],
    "no_mma": [(QMM, "for (int i = 0; i < BK / 16; ++i) wgmma_bf16<BN>(acc,",
                "for (int i = 0; i < 0; ++i) wgmma_bf16<BN>(acc,")],
    "loads_only": [(QMM, "it < BK * BN / 16 / CONSUMERS", "it < 0"),
                   (QMM, "for (int i = 0; i < BK / 16; ++i) wgmma_bf16<BN>(acc,",
                    "for (int i = 0; i < 0; ++i) wgmma_bf16<BN>(acc,")],
    "bn128": [(QMM, "const bool wide = ", "const bool wide = false && ")],
    "bn256": [(QMM, "const bool wide = ", "const bool wide = block_size == K || ")],
}


def build(names) -> dict:
    """Compile a copy of qmm_int8.cu per variant with its edits applied (the
    headers copied beside it), one nvcc each, all at once."""
    procs = {}
    for name in names:
        vdir = _build.BUILD_DIR / f"qmm_variant_{name}"
        vdir.mkdir(parents=True, exist_ok=True)
        texts = {f.name: f.read_text() for f in [_build.CSRC / QMM, *_build.CSRC.glob("*.cuh")]}
        for fname, old, new in VARIANTS[name]:
            if old not in texts[fname]:
                raise RuntimeError(f"variant {name}: {fname} no longer has {old!r}")
            texts[fname] = texts[fname].replace(old, new)
        for fname, text in texts.items():
            (vdir / fname).write_text(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(vdir / "libqmm.so"), str(vdir / QMM)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0].decode()
        if proc.returncode:
            raise RuntimeError(f"variant {name}: nvcc failed\n{log[-3000:]}")
        lib = ctypes.CDLL(str(_build.BUILD_DIR / f"qmm_variant_{name}" / "libqmm.so"))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.qmm_int8.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, vp]
        lib.qmm_int8.restype = ci
        libs[name] = lib
    return libs


def time_ms(fn, launches: int = 20, repeats: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(repeats):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for i in range(launches):
            fn(i)
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / launches)
    return statistics.median(out)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", nargs="+", default=["wgu", "down"], choices=sorted(SHAPES))
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS), choices=list(VARIANTS))
    ap.add_argument("--rows", type=int, default=1024)
    args = ap.parse_args()
    libs = build(args.variants)
    gen = torch.Generator(device="cuda").manual_seed(0)
    M = args.rows
    for shape in args.shapes:
        K, N = SHAPES[shape]
        x = torch.randn(M, K, device="cuda", generator=gen).to(torch.bfloat16)
        ws = [torch.randint(-127, 128, (K, N), device="cuda", dtype=torch.int8, generator=gen)
              for _ in range(3)]
        scale = torch.rand(1, N, device="cuda", generator=gen) * 0.01
        out = torch.empty(M, N, device="cuda", dtype=torch.bfloat16)
        stream = _build.stream_of(x)
        row = {"shape": f"{shape} M={M} K={K} N={N}", "card": torch.cuda.get_device_name(0)}
        for v, lib in libs.items():
            def call(i=0, lib=lib):
                rc = lib.qmm_int8(_build.ptr(x), _build.ptr(ws[i % 3]), _build.ptr(scale), None,
                                  _build.ptr(out), M, N, K, K, 0, 0, 0, stream)
                if rc:
                    raise RuntimeError(f"{v}: CUDA error {rc}")
            row[v] = time_ms(call)
        wb = [w.to(torch.bfloat16) for w in ws]
        row["matmul_bf16"] = time_ms(lambda i=0: torch.matmul(x, wb[i % 3]))
        row["tflops_committed"] = (2 * M * K * N / (row["committed"] * 1e-3) / 1e12
                                   if "committed" in row else None)
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
