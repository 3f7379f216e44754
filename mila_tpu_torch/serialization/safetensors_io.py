"""HF safetensors files without the ``safetensors`` package, and the Llama
and GPT-2 HF name maps (port of ``mila_tpu/serialization/safetensors_io.py``).

Format: a u64-LE header length, a JSON header {name: {dtype, shape,
data_offsets}} (an optional ``__metadata__`` entry), then one flat byte
buffer. Tensors are made from the raw bytes with ``torch.frombuffer``:
BF16, F8_E4M3 and F8_E5M2 are ``torch.bfloat16``, ``torch.float8_e4m3fn``
and ``torch.float8_e5m2`` (the JAX package reads them through
``ml_dtypes``). The writer lays a file out as the JAX package's does
(names sorted, the same header JSON), so the two write the same bytes for
the same tensors, and each reads what the other writes.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Any

import numpy as np
import torch

from mila_tpu_torch.device import DeviceLike, resolve_device

_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "F8_E4M3": torch.float8_e4m3fn, "F8_E5M2": torch.float8_e5m2, "I64": torch.int64,
    "I32": torch.int32, "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


class SafetensorsFile:
    """Lazy reader over one .safetensors file (mmap-backed); ``read`` gives
    a CPU tensor."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        with open(self.path, "rb") as f:
            (hlen,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(hlen))
        self.metadata = header.pop("__metadata__", {})
        self.entries: dict[str, dict] = header
        self._data_start = 8 + hlen
        self._mm = np.memmap(self.path, dtype=np.uint8, mode="r")

    def keys(self) -> list[str]:
        return sorted(self.entries)

    def read(self, name: str) -> torch.Tensor:
        e = self.entries[name]
        lo, hi = e["data_offsets"]
        dtype = _DTYPES[e["dtype"]]
        if hi == lo:
            return torch.empty(e["shape"], dtype=dtype)
        buf = bytearray(self._mm[self._data_start + lo: self._data_start + hi])
        return torch.frombuffer(buf, dtype=dtype).reshape(e["shape"])


def load_safetensors(path_or_dir: str | Path,
                     pattern: str = "*.safetensors") -> dict[str, torch.Tensor]:
    """Every tensor of a file, or of a sharded directory's files (CPU)."""
    p = Path(path_or_dir)
    files = sorted(p.glob(pattern)) if p.is_dir() else [p]
    if not files:
        raise FileNotFoundError(f"no safetensors under {path_or_dir}")
    out: dict[str, torch.Tensor] = {}
    for f in files:
        sf = SafetensorsFile(f)
        for k in sf.keys():
            out[k] = sf.read(k)
    return out


def save_safetensors(path: str | Path, tensors: dict[str, torch.Tensor]) -> None:
    """Minimal writer: tensors on any device, in the dtypes of ``_DTYPES``."""
    header: dict[str, Any] = {}
    off = 0
    blobs = []
    for name in sorted(tensors):
        t = tensors[name].detach().cpu().contiguous()
        blob = t.reshape(-1).view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [off, off + len(blob)]}
        blobs.append(blob)
        off += len(blob)
    hjson = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hjson)))
        f.write(hjson)
        for b in blobs:
            f.write(b)


# ---------------------------------------------------------------------------
# HF -> the port's param trees
# ---------------------------------------------------------------------------

def hf_llama_to_params(tensors: dict, num_layers: int, device: DeviceLike = None) -> dict:
    """HF ``LlamaForCausalLM`` names -> the ``Llama`` tree on ``device`` (the
    GPU unless the caller names another). HF's ``nn.Linear`` weights are
    [out, in]; the port's are [in, out], so they are transposed."""
    dev = resolve_device(device)

    def a(name):
        return tensors[name].to(dev)

    def t(name):
        return tensors[name].T.contiguous().to(dev)

    params: dict = {"embed": {"wte": a("model.embed_tokens.weight")},
                    "norm_f": {"gamma": a("model.norm.weight")}}
    if "lm_head.weight" in tensors:
        params["lm_head"] = {"weight": t("lm_head.weight")}
    for i in range(num_layers):
        pre = f"model.layers.{i}"
        params[f"h{i}"] = {
            "ln_attn": {"gamma": a(f"{pre}.input_layernorm.weight")},
            "wq": {"weight": t(f"{pre}.self_attn.q_proj.weight")},
            "wk": {"weight": t(f"{pre}.self_attn.k_proj.weight")},
            "wv": {"weight": t(f"{pre}.self_attn.v_proj.weight")},
            "wo": {"weight": t(f"{pre}.self_attn.o_proj.weight")},
            "ln_mlp": {"gamma": a(f"{pre}.post_attention_layernorm.weight")},
            "gate": {"weight": t(f"{pre}.mlp.gate_proj.weight")},
            "up": {"weight": t(f"{pre}.mlp.up_proj.weight")},
            "down": {"weight": t(f"{pre}.mlp.down_proj.weight")},
        }
    return params


def hf_gpt2_to_params(tensors: dict, num_layers: int, device: DeviceLike = None) -> dict:
    """HF ``GPT2LMHeadModel`` names -> the ``GPT2`` tree on ``device``. HF
    GPT-2's ``Conv1D`` weights are [in, out] already: no transpose."""
    dev = resolve_device(device)

    def a(name):
        return tensors[name].to(dev)

    def lin(pre):
        return {"weight": a(f"{pre}.weight"), "bias": a(f"{pre}.bias")}

    params: dict = {"encoder": {"wte": a("wte.weight"), "wpe": a("wpe.weight")},
                    "ln_f": {"gamma": a("ln_f.weight"), "beta": a("ln_f.bias")}}
    for i in range(num_layers):
        pre = f"h.{i}"
        params[f"h{i}"] = {
            "ln1": {"gamma": a(f"{pre}.ln_1.weight"), "beta": a(f"{pre}.ln_1.bias")},
            "qkv": lin(f"{pre}.attn.c_attn"),
            "attn": {},
            "proj": lin(f"{pre}.attn.c_proj"),
            "ln2": {"gamma": a(f"{pre}.ln_2.weight"), "beta": a(f"{pre}.ln_2.bias")},
            "mlp": {"fc1": lin(f"{pre}.mlp.c_fc"), "act": {}, "fc2": lin(f"{pre}.mlp.c_proj")},
        }
    return params
