"""ctypes binding to the native IO library (port of ``mila_tpu/native.py``).

The library is the JAX package's C++ (``native/mila_io.cpp`` and
``native/mila_bpe.cpp``: IDX parsing, llm.c token shards, next-token window
gathers, byte LUT encoding and the BPE encoder). The port builds its own
copy at first use with ``g++`` (``$CXX`` where set) into
``mila_tpu_torch/csrc/build/libmila_io.so``, a git-ignored directory, and
rebuilds it when a source is newer. JAX's Makefile adds ``-march=native``
and ``-fopenmp``; the port leaves both out, so a build copied to another
host still runs and a compiler without OpenMP's runtime (the GPU machine's
has none) still builds it: the sources' ``omp`` pragmas then compile to
the same loops, run on one thread. Every entry point returns None when
the library cannot be built or loaded, and the readers then take their
numpy path, as JAX's do; :func:`load_error` says why.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

log = logging.getLogger("mila_tpu_torch")

_SRC_DIR = Path(__file__).resolve().parent.parent / "native"
_SOURCES = ("mila_io.cpp", "mila_bpe.cpp")
_BUILD_DIR = Path(__file__).resolve().parent / "csrc" / "build"
_LIB_PATH = _BUILD_DIR / "libmila_io.so"
CXXFLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")

_lib: Optional[ctypes.CDLL] = None
_load_attempted = False
_error: Optional[str] = None


def _stale() -> bool:
    if not _LIB_PATH.exists():
        return True
    built = _LIB_PATH.stat().st_mtime
    return any((_SRC_DIR / s).stat().st_mtime > built for s in _SOURCES)


def _build() -> None:
    """Compile the sources into a temporary file, then move it into place
    (processes that build at once each finish with a whole library)."""
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = _BUILD_DIR / f".libmila_io.{os.getpid()}.so"
    cmd = [os.environ.get("CXX", "g++"), *CXXFLAGS, "-o", str(tmp),
           *(str(_SRC_DIR / s) for s in _SOURCES)]
    subprocess.run(cmd, capture_output=True, check=True, timeout=300)
    os.replace(tmp, _LIB_PATH)


def _bind(lib: ctypes.CDLL) -> None:
    i64, i32p, i64p = ctypes.c_int64, ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64)
    f32p, u8p = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8)
    sigs = {
        "mila_read_idx_images": (i64, [ctypes.c_char_p, f32p, i64, i32p, i32p]),
        "mila_read_idx_labels": (i64, [ctypes.c_char_p, i32p, i64]),
        "mila_read_token_file": (i64, [ctypes.c_char_p, i32p, i64]),
        "mila_gather_windows": (None, [i32p, i64, i64p, ctypes.c_int32, ctypes.c_int32, i32p,
                                       i32p]),
        "mila_lut_encode": (None, [u8p, i64, i32p, i32p]),
        "mila_io_version": (ctypes.c_int, []),
        "mila_bpe_new": (ctypes.c_void_p, [u8p, i64, ctypes.c_int32, i32p, i64]),
        "mila_bpe_encode": (i64, [ctypes.c_void_p, u8p, i64, i32p, i64]),
        "mila_bpe_free": (None, [ctypes.c_void_p]),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library (building it if needed), or None."""
    global _lib, _load_attempted, _error
    if _lib is not None or _load_attempted:
        return _lib
    _load_attempted = True
    try:
        if _stale():
            _build()
        lib = ctypes.CDLL(str(_LIB_PATH))
        _bind(lib)
    except (subprocess.SubprocessError, OSError, AttributeError) as e:
        detail = getattr(e, "stderr", b"") or b""
        _error = f"{type(e).__name__}: {e} {detail.decode(errors='replace')[-2000:]}".strip()
        log.warning("native IO library unavailable (%s); the numpy paths stand in", _error)
        return None
    _lib = lib
    return _lib


def available() -> bool:
    return get_lib() is not None


def load_error() -> Optional[str]:
    """Why the library did not load (None when it did or was not tried)."""
    return _error


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def read_token_file(path: str) -> Optional[np.ndarray]:
    """A token shard as int32 [N]; None: use the numpy path."""
    lib = get_lib()
    if lib is None:
        return None
    cap = max(Path(path).stat().st_size // 2 + 16, 1024)
    out = np.empty(cap, np.int32)
    n = lib.mila_read_token_file(str(path).encode(), _ptr(out, ctypes.c_int32), cap)
    return None if n < 0 else out[:n].copy()


def read_idx_images(path: str) -> Optional[np.ndarray]:
    """An IDX3 image file as float32 [N, rows * cols] in [0, 1]."""
    lib = get_lib()
    if lib is None:
        return None
    cap = max(Path(path).stat().st_size, 1024)
    out = np.empty(cap, np.float32)
    rows, cols = ctypes.c_int32(0), ctypes.c_int32(0)
    n = lib.mila_read_idx_images(str(path).encode(), _ptr(out, ctypes.c_float), cap,
                                 ctypes.byref(rows), ctypes.byref(cols))
    if n < 0:
        return None
    stride = rows.value * cols.value
    return out[: n * stride].reshape(n, stride).copy()


def read_idx_labels(path: str) -> Optional[np.ndarray]:
    lib = get_lib()
    if lib is None:
        return None
    out = np.empty(max(Path(path).stat().st_size, 16), np.int32)
    n = lib.mila_read_idx_labels(str(path).encode(), _ptr(out, ctypes.c_int32), out.size)
    return None if n < 0 else out[:n].copy()


def gather_windows(tokens: np.ndarray, starts: np.ndarray,
                   seq_len: int) -> Optional[tuple[np.ndarray, np.ndarray]]:
    """(x, y) int32 [B, seq_len] next-token windows at ``starts``."""
    lib = get_lib()
    if lib is None:
        return None
    tokens = np.ascontiguousarray(tokens, np.int32)
    starts64 = np.ascontiguousarray(starts, np.int64)
    B = len(starts64)
    x = np.empty((B, seq_len), np.int32)
    y = np.empty((B, seq_len), np.int32)
    lib.mila_gather_windows(_ptr(tokens, ctypes.c_int32), tokens.size,
                            _ptr(starts64, ctypes.c_int64), B, seq_len,
                            _ptr(x, ctypes.c_int32), _ptr(y, ctypes.c_int32))
    return x, y


def lut_encode(data: bytes | np.ndarray, lut256: np.ndarray) -> Optional[np.ndarray]:
    """lut256[byte] for every byte of ``data``, int32."""
    lib = get_lib()
    if lib is None:
        return None
    buf = (np.frombuffer(data, np.uint8) if isinstance(data, (bytes, bytearray))
           else np.ascontiguousarray(data, np.uint8))
    lut = np.ascontiguousarray(lut256, np.int32)
    out = np.empty(buf.size, np.int32)
    lib.mila_lut_encode(_ptr(buf, ctypes.c_uint8), buf.size, _ptr(lut, ctypes.c_int32),
                        _ptr(out, ctypes.c_int32))
    return out


def bpe_new(vocab: list[bytes], merges: list[tuple[int, int, int]]) -> Optional[int]:
    """A native BPE encoder handle for ``vocab`` and ranked merge triples,
    or None. Free it with :func:`bpe_free`."""
    lib = get_lib()
    if lib is None:
        return None
    blob = bytearray()
    for tok in vocab:
        blob += len(tok).to_bytes(4, "little") + tok
    blob_np = np.frombuffer(bytes(blob), np.uint8)
    merges_np = np.ascontiguousarray(np.asarray(merges, np.int32).reshape(-1))
    handle = lib.mila_bpe_new(_ptr(blob_np, ctypes.c_uint8), blob_np.size, len(vocab),
                              _ptr(merges_np, ctypes.c_int32), len(merges))
    return handle or None


def bpe_encode(handle: int, data: bytes) -> Optional[np.ndarray]:
    """Token ids of ``data`` (None on an encoder error, e.g. a byte missing
    from the vocabulary)."""
    buf = np.frombuffer(data, np.uint8)
    out = np.empty(len(data), np.int32)
    n = get_lib().mila_bpe_encode(handle, _ptr(buf, ctypes.c_uint8), buf.size,
                                  _ptr(out, ctypes.c_int32), out.size)
    return None if n < 0 else out[:n].copy()


def bpe_free(handle: int) -> None:
    lib = get_lib()
    if lib is not None:
        lib.mila_bpe_free(handle)
