"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

Every wrapper launches its kernel for CUDA tensors and counts the launch in
its ``launches`` attribute; for CPU tensors it runs the plain version. The
sources live in ``mila_tpu_torch/csrc`` and build at first use
(:mod:`mila_tpu_torch.kernels._build`).
"""

from __future__ import annotations


def entry_points() -> dict:
    """name -> wrapper, for every kernel entry point of the package."""
    from mila_tpu_torch.kernels import (
        decode_fused,
        dense_attention,
        layer_fused,
        layer_stream,
        paged_attention,
        quant_matmul,
    )

    return {
        "quant_linear": quant_matmul.quant_linear,
        "rms_quant_linear": decode_fused.rms_quant_linear,
        "quant_linear_residual": decode_fused.quant_linear_residual,
        "rms_quant_linear_swiglu": decode_fused.rms_quant_linear_swiglu,
        "paged_decode_attention": paged_attention.paged_decode_attention,
        "rms_quant_linear_argmax": decode_fused.rms_quant_linear_argmax,
        "dense_decode_attention": dense_attention.dense_decode_attention,
        "fused_decode_attention": dense_attention.fused_decode_attention,
        "layer_tail_stream": layer_stream.layer_tail_stream,
        "mlp_qkv_fused": layer_fused.mlp_qkv_fused,
    }


def plain_versions() -> tuple:
    """Every plain version that counts its calls (``calls``)."""
    from mila_tpu_torch.kernels import (
        decode_fused,
        dense_attention,
        layer_fused,
        paged_attention,
        quant_matmul,
    )

    return (quant_matmul.quant_linear_plain, decode_fused.rms_quant_linear_plain,
            decode_fused.quant_linear_residual_plain,
            decode_fused.rms_quant_linear_swiglu_plain,
            decode_fused.rms_quant_linear_argmax_plain,
            paged_attention.paged_decode_attention_plain,
            dense_attention.dense_decode_attention_plain,
            dense_attention.fused_decode_attention_plain,
            layer_fused.layer_tail_plain, layer_fused.qkv_tail_plain)


def reset_launches() -> None:
    for fn in entry_points().values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in entry_points().items()}


def plain_calls() -> tuple:
    return tuple(f.calls for f in plain_versions())
