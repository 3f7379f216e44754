"""Tensor helpers (counterpart of ``mila_tpu/tensor``)."""
