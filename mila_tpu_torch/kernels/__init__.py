"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

Every wrapper launches its kernel for CUDA tensors and counts the launch in
its ``launches`` attribute; for CPU tensors it runs the plain version. The
sources live in ``mila_tpu_torch/csrc`` and build at first use
(:mod:`mila_tpu_torch.kernels._build`).
"""

from __future__ import annotations


def entry_points() -> dict:
    """name -> wrapper, for every kernel entry point of the package."""
    from mila_tpu_torch.kernels import decode_fused, paged_attention, quant_matmul

    return {
        "quant_linear": quant_matmul.quant_linear,
        "rms_quant_linear": decode_fused.rms_quant_linear,
        "quant_linear_residual": decode_fused.quant_linear_residual,
        "rms_quant_linear_swiglu": decode_fused.rms_quant_linear_swiglu,
        "paged_decode_attention": paged_attention.paged_decode_attention,
    }


def reset_launches() -> None:
    for fn in entry_points().values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in entry_points().items()}
