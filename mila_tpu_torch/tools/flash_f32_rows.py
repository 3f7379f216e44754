"""The f32 flash backward's worst (b, t, head) rows of dq, dk and dv against a
float64 reference, beside the plain f32 version's, per head size, on the GPU.

    python -m mila_tpu_torch.tools.flash_f32_rows [--dims 64 128 192 256 320]
        [--truncating]

The f32 backward (``csrc/flash_tf32_bwd.cu`` at D 64 and 128,
``csrc/flash_sync_bwd.cu``'s split kernels past them) multiplies on tf32
operands (ROADMAP §C.2). The reference takes the same q, k, v, the kernel forward's o, l, m
and the same do, and computes in float64. A row's error is its max |got -
ref| over its max |ref|, floored at 1e-3 of the tensor's max (as the card
tests take it); the first query's row is printed apart, since there dS = P
(dP - D) is only the forward's rounding residue. ``--truncating`` also
checks a copy of the backward source each head size routes to whose dP sums
its split products on the tensor cores alone (``flash_tf32_bwd.cu``: RN
covering every k-slice; ``flash_sync_bwd.cu`` from D 192: without
``split::s_dp_panel``'s f32 adds): the tensor cores' own sums, rounded
toward 0. One JSON line per head size; about a minute with the
builds.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import torch

from mila_tpu_torch.kernels import _build
from mila_tpu_torch.kernels import flash_attention as fa
from mila_tpu_torch.kernels import flash_attention_bwd as fb


def row_errs(got, want, floor: float = 1e-3) -> torch.Tensor:
    """Per (b, t, head) row of [B, T, H, D] tensors."""
    got, want = got.double(), want.double()
    d = (got - want).abs().amax(-1)
    return d / want.abs().amax(-1).clamp_min(floor * want.abs().max().item() + 1e-30)


def reference(q, k, v, o, l, m, do, sm: float):
    """dq, dk, dv in float64 from model-layout [B, T, H, D] tensors, causal."""
    G = q.shape[2] // k.shape[2]
    qh, oh, doh = (t.double().transpose(1, 2) for t in (q, o, do))
    kh, vh = (t.double().transpose(1, 2).repeat_interleave(G, 1) for t in (k, v))
    T = q.shape[1]
    s = (qh @ kh.transpose(-1, -2)) * sm
    s = s.masked_fill(~torch.ones(T, T, dtype=torch.bool, device=q.device).tril(), float("-inf"))
    p = torch.exp(s - m.double()[..., None]) / l.double()[..., None]
    ds = p * (doh @ vh.transpose(-1, -2) - (oh * doh).sum(-1, keepdim=True)) * sm
    B, NKV = k.shape[0], k.shape[2]
    dk = (ds.transpose(-1, -2) @ qh).reshape(B, NKV, G, T, -1).sum(2)
    dv = (p.transpose(-1, -2) @ doh).reshape(B, NKV, G, T, -1).sum(2)
    return (ds @ kh).transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2)


# dP's f32 adds (flash_tf32_bwd.cu: RN k-slices at a time; flash_sync_bwd.cu
# from D 192: split::s_dp_panel, every k-slice), and the same products summed
# into dP on the tensor cores alone: per backward family, (file, rn text,
# truncating).
TRUNCATING = {
    "tf32": [("flash_tf32_bwd.cu", "constexpr int RN = 2;", "constexpr int RN = 1 << 10;")],
    "sync": [
        ("flash_sync_bwd.cu", "    wgmma_m64n32k8_tf32(acc, ", "    wgmma_m64n32k8_tf32(dp, "),
        ("flash_sync_bwd.cu", "    wgmma_fence_operand<16>(acc);",
         "    wgmma_fence_operand<16>(dp);"),
        ("flash_sync_bwd.cu", "    for (int e = 0; e < 16; ++e) dp[e] += acc[e];", ""),
    ],
}


def truncating_lib(family: str) -> ctypes.CDLL:
    """A copy of the family's backward source with dP summed on the tensor
    cores alone, all of it in one nvcc."""
    src = TRUNCATING[family][0][0]
    vdir = _build.BUILD_DIR / f"{src[:-3]}_truncating"
    vdir.mkdir(parents=True, exist_ok=True)
    texts = {f.name: f.read_text() for f in [*_build.CSRC.glob("*.cuh"), _build.CSRC / src]}
    for fname, rn, tc in TRUNCATING[family]:
        if rn not in texts[fname]:
            raise RuntimeError(f"{fname} no longer has dP's f32 step as this tool knows it")
        texts[fname] = texts[fname].replace(rn, tc)
    for fname, text in texts.items():
        (vdir / fname).write_text(text)
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(vdir / "lib.so"),
                    str(vdir / src)], check=True, capture_output=True)
    return ctypes.CDLL(str(vdir / "lib.so"))


def backward(hm, l, m, sm: float, lib=None):
    """flash_attention_bwd on head-major views, through the wrapper's
    launch; with ``lib``, that build of the family's source in place of
    the package's (the wrapper types it as it types its own)."""
    return fb._launch(*hm[:4], l, m, hm[4], True, sm, 0, lib=lib)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dims", nargs="+", type=int, default=[64, 128, 192, 256, 320])
    ap.add_argument("--truncating", action="store_true")
    args = ap.parse_args()
    libs = {}
    if args.truncating:
        libs = {f: truncating_lib(f) for f in {fa.routes(torch.float32, D)[1] for D in args.dims}}
    card = torch.cuda.get_device_name(0)
    for D in args.dims:
        g = torch.Generator(device="cuda").manual_seed(0)
        B, T, NH, NKV = 1, 256 if D < 1024 else 128, 4, 2
        q, k, v, do = (torch.randn(B, T, n, D, device="cuda", generator=g)
                       for n in (NH, NKV, NKV, NH))
        sm = D ** -0.5
        o, l, m = fa.flash_attention_forward(q, k, v, causal=True, sm_scale=sm)
        ref = reference(q, k, v, o, l, m, do, sm)
        hm = [t.transpose(1, 2) for t in (q, k, v, o, do)]
        family = fa.routes(torch.float32, D)[1]
        outs = {"kernel": [t.transpose(1, 2) for t in backward(hm, l, m, sm)],
                "plain": [t.transpose(1, 2) for t in fb.flash_attention_bwd_plain(
                    *hm[:4], l, m, hm[4], causal=True, sm_scale=sm)]}
        if family in libs:
            outs["truncating"] = [t.transpose(1, 2) for t in backward(hm, l, m, sm,
                                                                      libs[family])]
        row = {"D": D, "T": T, "family": family, "card": card}
        for name, got in outs.items():
            errs = [row_errs(a, b) for a, b in zip(got, ref)]
            row[name] = {n: e.max().item() for n, e in zip(("dq", "dk", "dv"), errs)}
            row[name]["dq_first_query"] = errs[0][:, 0].max().item()
            row[name]["dq_later_queries"] = errs[0][:, 1:].max().item()
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
