"""Build and load the CUDA kernels in ``mila_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` compiles on its own with ``nvcc`` for ``sm_90a``
into ``csrc/build/lib<name>-<hash>.so``, a library with a plain C interface
loaded through ``ctypes``. ``<hash>`` covers the source and the shared
header, so an edited source rebuilds at its next use and an unchanged one
loads from the build directory. ``build_all`` starts one ``nvcc`` per
source at once and waits for all of them. A source with many kernel
instantiations builds as parts (``PARTS``): one ``nvcc -c -DMILA_PART=k``
each, started with the rest, then linked into its library.

Nothing here runs at import: the CPU tests import every module of the
package on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
KERNELS = ("qmm_int8", "qgemv_int8", "paged_decode_attn", "dense_decode_attn",
           "layer_tail_int8", "decode_step_int8", "qgemv_int4", "flash_fwd", "flash_bwd",
           "flash_sync_bwd", "flash_tf32_fwd", "flash_tf32_bwd",
           "fused_adamw", "softmax_ce")
# The float type codes of the C entry points that take f32, bf16 or fp16
# (fused_adamw.cu, softmax_ce.cu, flash_sync_bwd.cu).
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# Sources built in parts, and how many (the source says what each holds).
PARTS = {"decode_step_int8": 4, "flash_fwd": 7, "flash_bwd": 9, "flash_sync_bwd": 2,
         "flash_tf32_fwd": 4, "flash_tf32_bwd": 3,
         "dense_decode_attn": 4, "paged_decode_attn": 2}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit (set CUDA_HOME)")


def _digest(name: str) -> str:
    h = hashlib.sha256()
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def _run(cmd: list, log_name: str):
    log = open(BUILD_DIR / log_name, "w")
    return subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), log_name, log


def _wait(started) -> str:
    """The empty string when the process succeeded, else its exit code and
    the end of its log."""
    proc, log_name, log = started
    rc = proc.wait()
    log.close()
    return "" if rc == 0 else f"rc {rc}:\n{(BUILD_DIR / log_name).read_text()[-4000:]}"


def _start(name: str):
    """Start nvcc for one source (each of its parts); None when its library
    is already built."""
    out = lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    src = str(CSRC / f"{name}.cu")
    if name not in PARTS:
        return [_run([nvcc(), *NVCC_FLAGS, "-o", str(tmp), src], f"{name}.log")], tmp, out, []
    flags = [f for f in NVCC_FLAGS if f != "-shared"]
    objs = [f"{tmp}.{k}.o" for k in range(PARTS[name])]
    procs = [_run([nvcc(), *flags, f"-DMILA_PART={k}", "-c", "-o", obj, src], f"{name}.{k}.log")
             for k, obj in enumerate(objs)]
    return procs, tmp, out, objs


def _finish(name: str, started) -> None:
    procs, tmp, out, objs = started
    err = next((e for e in [_wait(p) for p in procs] if e), "")  # waits for every part
    if objs and not err:
        err = _wait(_run([nvcc(), "-shared", "-o", str(tmp), *objs], f"{name}.link.log"))
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    if err:
        raise RuntimeError(f"nvcc failed for {name}.cu ({err}")
    os.replace(tmp, out)


def build_all(names=KERNELS) -> None:
    """Compile every source that has no up-to-date library, in parallel."""
    with _lock:
        started = {n: _start(n) for n in names}
        errors = []
        for n, s in started.items():
            if s is not None:
                try:
                    _finish(n, s)
                except RuntimeError as e:
                    errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build_all((name,))
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(lib_path(name)))
                _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise on the cudaError_t a C entry point returned (after its launch)."""
    if rc != 0:
        lib.mila_cuda_error_string.restype = ctypes.c_char_p
        lib.mila_cuda_error_string.argtypes = [ctypes.c_int]
        msg = lib.mila_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
