"""Module system, layers, convolution layers and blocks (port of
``mila_tpu/nn``)."""

from mila_tpu_torch.nn.blocks import MLP, MLPConfig, TransformerBlock, TransformerBlockConfig
from mila_tpu_torch.nn.conv import Conv2D, Conv2DConfig, Flatten, Pool2D, Pool2DConfig
from mila_tpu_torch.nn.layers import (
    Attention,
    AttentionConfig,
    Dropout,
    DropoutConfig,
    Encoder,
    EncoderConfig,
    Gelu,
    GeluConfig,
    LayerNorm,
    LayerNormConfig,
    Linear,
    LinearConfig,
    Residual,
    RMSNorm,
    Softmax,
    SoftmaxConfig,
    SoftmaxCrossEntropy,
    SoftmaxCrossEntropyConfig,
)
from mila_tpu_torch.nn.module import CompositeModule, Lambda, Module, Params, Sequential

__all__ = [
    "MLP", "MLPConfig", "TransformerBlock", "TransformerBlockConfig", "Attention",
    "AttentionConfig", "Dropout", "DropoutConfig", "Encoder", "EncoderConfig", "Gelu",
    "GeluConfig", "LayerNorm", "LayerNormConfig", "Linear", "LinearConfig", "Residual",
    "RMSNorm", "Softmax", "SoftmaxConfig", "SoftmaxCrossEntropy", "SoftmaxCrossEntropyConfig",
    "CompositeModule", "Lambda", "Module", "Params", "Sequential", "Conv2D", "Conv2DConfig",
    "Flatten", "Pool2D", "Pool2DConfig",
]
