"""mila_tpu_torch: the PyTorch/CUDA port of ``mila_tpu`` for NVIDIA Hopper.

The JAX package ``mila_tpu`` is the reference; every module here mirrors a
counterpart there (``ops/``, ``inference/``, ``kernels/``, ``models/``) and is
held against it by ``tests/test_torch_*.py``. This package imports ``torch``,
numpy and the standard library only.

Entry points (``Llama``, ``InferenceEngine``, ``init_llama_params``,
``quantize_model_params``) run on ``cuda`` unless the caller passes
``device="cpu"``; without a GPU and without an explicit ``cpu`` they raise.
"""

__version__ = "0.1.0"
