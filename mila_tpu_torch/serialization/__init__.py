"""Serialization (port of ``mila_tpu/serialization``): llm.c GPT-2
checkpoints and tokenizers, and HF safetensors files with the Llama and
GPT-2 name maps. The JAX package's ``archive`` and ``checkpoint`` modules
are not ported yet."""

from mila_tpu_torch.serialization.llmc import (
    GPT2Tokenizer,
    read_gpt2_checkpoint,
    write_gpt2_checkpoint,
)
from mila_tpu_torch.serialization.safetensors_io import (
    SafetensorsFile,
    hf_gpt2_to_params,
    hf_llama_to_params,
    load_safetensors,
    save_safetensors,
)

__all__ = [
    "GPT2Tokenizer",
    "SafetensorsFile",
    "hf_gpt2_to_params",
    "hf_llama_to_params",
    "load_safetensors",
    "read_gpt2_checkpoint",
    "save_safetensors",
    "write_gpt2_checkpoint",
]
