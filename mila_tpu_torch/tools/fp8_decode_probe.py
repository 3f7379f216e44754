"""Does the TPU kernels' fp8 bit decode survive Hopper's tensor cores?

    python -m mila_tpu_torch.tools.fp8_decode_probe

The JAX package decodes an fp8 weight by moving its 7-bit payload into a
bf16's exponent and mantissa fields (``mila_tpu/kernels/quant_matmul.py:
_load_w``): the operand is the fp8 value times 2^-120 (e4m3) or 2^-112
(e5m2), a bf16 subnormal for the fp8 subnormal codes, and the scale row
carries the power of two back. The port's kernels multiply the operand by
that power of two first (``csrc/gemv.cuh:F8Pair``), so it is the fp8 value
itself. This builds a copy of ``csrc/qgemv_int8.cu`` with the TPU kernels'
decode instead (the payload and sign bits as the operand, no FMA, the
power of two folded into each scale row as ``_rms_qmm_kernel``'s
``scale_fix``) and runs both on three
cases at wqkv's shape (K 2048, N 3072, M 8, the residual epilogue with a
zero residual): random weights; columns whose every weight is a subnormal
code (0x01-0x07, 0x81-0x87); and a row of x scaled by 2^-16, whose products
fall under f32's smallest normal, 2^-126, with the TPU decode. Each case
prints one JSON line per format and decode: the max abs error of the
case's outputs against ``scaled_partials`` (exact fp8 values, f32 sums)
over the largest of those outputs.
"""

from __future__ import annotations

import json

import torch

from mila_tpu_torch.inference.quantize import quantize
from mila_tpu_torch.kernels import _build
from mila_tpu_torch.kernels import decode_fused as df
from mila_tpu_torch.kernels import quant_matmul as qm
from mila_tpu_torch.tools.decode_variants import INT8_SRC, _typed_int8, build_sources

# The TPU kernels' decode: the payload and sign bits are the operand (no FMA),
# the fixup in the scale row.
JAX_DECODE = {
    "gemv.cuh": [('asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(v) : "r"(m), "r"(k), '
                  '"r"(0x80008000u));', "v = m | (p & 0x80008000u);")],
    INT8_SRC: [("const float lo = n ? s4.z : s4.x, hi = n ? s4.w : s4.y;",
                "const float fix = a.wfmt == WFMT_E4M3 ? 0x1p120f : 0x1p112f;\n"
                "        const float lo = (n ? s4.z : s4.x) * fix, hi = (n ? s4.w : s4.y) * fix;")],
}
CODES = (1, 2, 3, 4, 5, 6, 7, 0x81, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87)


def _texts() -> dict:
    files = {}
    for fname, edits in JAX_DECODE.items():
        text = (_build.CSRC / fname).read_text()
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{fname} no longer has {old!r}")
            text = text.replace(old, new)
        files[fname] = text
    return {"jax_decode": files}


def _residual(lib, x, qt, res):
    M, K = x.shape
    N = qt.q.shape[1]
    out = torch.empty_like(res)
    mt, ks = df.plan_qgemv(M, K, N, qt.block_size,
                           torch.cuda.get_device_properties(0).multi_processor_count)
    rc = lib.qgemv_int8(_build.ptr(x), None, _build.ptr(qt.q), _build.ptr(qt.scale),
                        _build.ptr(res), _build.ptr(out), M, N, K, N, qt.block_size, 1, 0,
                        0.0, ks, mt, 0, qm.WFMT[qt.q.dtype], _build.stream_of(x))
    _build.check(lib, rc, "qgemv_int8")
    torch.cuda.synchronize()
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("fp8_decode_probe needs a CUDA device")
    libs = build_sources(INT8_SRC, "int8", _texts(), df._qgemv_lib(), _typed_int8)
    gen = torch.Generator(device="cuda").manual_seed(0)
    M, K, N, C = 8, 2048, 3072, 256
    card = torch.cuda.get_device_name(0)
    for wdt in ("fp8_e4m3", "fp8_e5m2"):
        qt = quantize(torch.randn(K, N, device="cuda", generator=gen) * 0.05, wdt)
        sub = quantize(torch.randn(K, N, device="cuda", generator=gen) * 0.05, wdt)
        codes = torch.tensor(CODES, dtype=torch.uint8, device="cuda")
        idx = (torch.arange(K, device="cuda")[:, None] + torch.arange(C, device="cuda")) % 14
        sub.q.view(torch.uint8)[:, :C] = codes[idx]
        x = torch.randn(M, K, device="cuda", generator=gen).to(torch.bfloat16)
        tiny = x.clone()
        tiny[0] *= 2.0 ** -16
        res = torch.zeros(M, N, device="cuda", dtype=torch.bfloat16)
        cases = {"random": (x, qt, (slice(None), slice(None))),
                 "subnormal_codes": (x, sub, (slice(None), slice(0, C))),
                 "row_x_2^-16": (tiny, qt, (0, slice(None)))}
        for case, (xc, w, sel) in cases.items():
            want = qm.scaled_partials(xc, w)[sel].float()
            for name, lib in libs.items():
                got = _residual(lib, xc, w, res)[sel].float()
                ref = want.abs().max().item()
                print(json.dumps({"case": case, "wdtype": wdt, "decode": name, "card": card,
                                  "rel_err": (got - want).abs().max().item() / ref,
                                  "zeros": int((got == 0).sum()), "max_ref": ref}), flush=True)


if __name__ == "__main__":
    main()
