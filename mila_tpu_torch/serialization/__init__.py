"""Serialization (port of ``mila_tpu/serialization``): the model archive and
training checkpoints, llm.c GPT-2 checkpoints and tokenizers, and HF
safetensors files with the Llama and GPT-2 name maps."""

from mila_tpu_torch.serialization.archive import (
    ModelArchive,
    OpenMode,
    SerializationMode,
    restore_tree,
)
from mila_tpu_torch.serialization.checkpoint import (
    CheckpointMetadata,
    find_latest_checkpoint,
    generate_checkpoint_filename,
    load_checkpoint,
    save_checkpoint,
    to_device_tree,
)
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
    "CheckpointMetadata",
    "GPT2Tokenizer",
    "ModelArchive",
    "OpenMode",
    "SafetensorsFile",
    "SerializationMode",
    "find_latest_checkpoint",
    "generate_checkpoint_filename",
    "hf_gpt2_to_params",
    "hf_llama_to_params",
    "load_checkpoint",
    "load_safetensors",
    "read_gpt2_checkpoint",
    "restore_tree",
    "save_checkpoint",
    "to_device_tree",
    "write_gpt2_checkpoint",
]
