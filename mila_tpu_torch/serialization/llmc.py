"""llm.c GPT-2 checkpoints and tokenizer (port of
``mila_tpu/serialization/llmc.py``).

A checkpoint is a 256-int32 header (magic 20240326, version, maxT, V, L,
NH, C and, from version 3, the padded vocabulary Vp) followed by the f32
parameters in llm.c's order. llm.c stores Linear weights [out, in]; the
port's are [in, out], so they are transposed on load and on save. The
tokenizer file (magic 20240328) holds length-prefixed byte strings; it
decodes only, as llm.c's does.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import BinaryIO

import numpy as np
import torch

from mila_tpu_torch.device import DeviceLike, resolve_device

GPT2_MODEL_MAGIC = 20240326
TOKENIZER_MAGIC = 20240328


def _read_f32(f: BinaryIO, *shape: int) -> np.ndarray:
    n = int(np.prod(shape))
    return np.frombuffer(f.read(n * 4), dtype="<f4", count=n).reshape(shape)


def read_gpt2_checkpoint(path: str | Path, device: DeviceLike = None):
    """Read an llm.c ``gpt2_124M.bin``-style checkpoint. Returns (the
    port's ``GPT2Config``, params): the ``GPT2`` tree (tied embeddings) of
    f32 tensors on ``device``, the GPU unless the caller names another."""
    from mila_tpu_torch.models.gpt2 import GPT2Config

    dev = resolve_device(device)
    with open(path, "rb") as f:
        header = np.frombuffer(f.read(256 * 4), dtype="<i4")
        if header[0] != GPT2_MODEL_MAGIC:
            raise ValueError(f"{path}: bad magic {header[0]} (want {GPT2_MODEL_MAGIC})")
        version = int(header[1])
        maxT, V, L, NH, C = (int(x) for x in header[2:7])
        Vp = int(header[7]) if version >= 3 and header[7] > 0 else V
        cfg = GPT2Config(name="gpt2-llmc", vocab_size=V, padded_vocab_size=Vp,
                         max_seq_len=maxT, num_layers=L, num_heads=NH, embedding_dim=C,
                         tie_embeddings=True)
        # llm.c's order (train_gpt2.c): wte, wpe, then per kind stacked over
        # the layers: ln1w ln1b qkvw qkvb attprojw attprojb ln2w ln2b fcw fcb
        # fcprojw fcprojb; then lnfw lnfb.
        shapes = {"wte": (Vp, C), "wpe": (maxT, C), "ln1w": (L, C), "ln1b": (L, C),
                  "qkvw": (L, 3 * C, C), "qkvb": (L, 3 * C), "projw": (L, C, C),
                  "projb": (L, C), "ln2w": (L, C), "ln2b": (L, C), "fcw": (L, 4 * C, C),
                  "fcb": (L, 4 * C), "fcprojw": (L, C, 4 * C), "fcprojb": (L, C),
                  "lnfw": (C,), "lnfb": (C,)}
        raw = {k: _read_f32(f, *s) for k, s in shapes.items()}

    def t(a, transpose=False):
        a = a.T if transpose else a
        return torch.from_numpy(np.array(a, np.float32)).to(dev)  # a writable copy

    params = {"encoder": {"wte": t(raw["wte"]), "wpe": t(raw["wpe"])},
              "ln_f": {"gamma": t(raw["lnfw"]), "beta": t(raw["lnfb"])}}
    for i in range(L):
        params[f"h{i}"] = {
            "ln1": {"gamma": t(raw["ln1w"][i]), "beta": t(raw["ln1b"][i])},
            "qkv": {"weight": t(raw["qkvw"][i], True), "bias": t(raw["qkvb"][i])},
            "attn": {},
            "proj": {"weight": t(raw["projw"][i], True), "bias": t(raw["projb"][i])},
            "ln2": {"gamma": t(raw["ln2w"][i]), "beta": t(raw["ln2b"][i])},
            "mlp": {"fc1": {"weight": t(raw["fcw"][i], True), "bias": t(raw["fcb"][i])},
                    "act": {},
                    "fc2": {"weight": t(raw["fcprojw"][i], True),
                            "bias": t(raw["fcprojb"][i])}},
        }
    return cfg, params


def _np(x) -> np.ndarray:
    return x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _get(tree: dict, dotted: str) -> np.ndarray:
    for k in dotted.split("."):
        tree = tree[k]
    return _np(tree)


def write_gpt2_checkpoint(path: str | Path, cfg, params) -> None:
    """Inverse of :func:`read_gpt2_checkpoint`: version 3, every leaf as f32
    (tensors on any device, in any float dtype)."""
    L, C = cfg.num_layers, cfg.embedding_dim
    header = np.zeros(256, "<i4")
    header[0] = GPT2_MODEL_MAGIC
    header[1] = 3
    header[2:8] = [cfg.max_seq_len, cfg.vocab_size, L, cfg.num_heads, C, cfg.vp]

    def stack(name, transpose=False):
        return np.stack([_get(params[f"h{i}"], name).T if transpose
                         else _get(params[f"h{i}"], name) for i in range(L)])

    parts = [_np(params["encoder"]["wte"]), _np(params["encoder"]["wpe"]),
             stack("ln1.gamma"), stack("ln1.beta"), stack("qkv.weight", True),
             stack("qkv.bias"), stack("proj.weight", True), stack("proj.bias"),
             stack("ln2.gamma"), stack("ln2.beta"), stack("mlp.fc1.weight", True),
             stack("mlp.fc1.bias"), stack("mlp.fc2.weight", True), stack("mlp.fc2.bias"),
             _np(params["ln_f"]["gamma"]), _np(params["ln_f"]["beta"])]
    with open(path, "wb") as f:
        f.write(header.tobytes())
        for a in parts:
            f.write(np.ascontiguousarray(a, "<f4").tobytes())


class GPT2Tokenizer:
    """llm.c's ``gpt2_tokenizer.bin``: magic 20240328, version, vocab size,
    (version 2) the end-of-text id, then length-prefixed byte strings.
    Decode only."""

    def __init__(self, path: str | Path):
        raw = Path(path).read_bytes()
        header = np.frombuffer(raw[: 256 * 4], dtype="<i4")
        if header[0] != TOKENIZER_MAGIC:
            raise ValueError(f"bad tokenizer magic {header[0]}")
        version = int(header[1])
        self.vocab_size = int(header[2])
        self.eot_token = int(header[3]) if version >= 2 else 50256
        self.tokens: list[bytes] = []
        off = 256 * 4
        for _ in range(self.vocab_size):
            (length,) = struct.unpack_from("<B", raw, off)
            off += 1
            self.tokens.append(raw[off: off + length])
            off += length

    def decode(self, ids) -> str:
        return b"".join(self.tokens[int(i)] for i in ids
                        if 0 <= int(i) < self.vocab_size).decode("utf-8", errors="replace")
