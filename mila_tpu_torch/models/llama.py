"""Llama-3.x: RMSNorm + RoPE + GQA + SwiGLU with the paged KV-cache protocol
(port of ``mila_tpu/models/llama.py``, paged path).

Parameters are a plain dict of tensors with the JAX package's tree layout
(``embed/wte``, ``h{i}/{ln_attn,wq,...}/...``, ``norm_f/gamma``, optional
``lm_head_q``), so ``mila_tpu_torch.bridge.params_from_jax`` maps a JAX
tree 1:1. Weights are [in, out].

The kernel dispatch mirrors the JAX model exactly, so that both sides take
the same arithmetic: quantized fused projections at B*T <= 32 rows run the
decode kernels (``kernels/decode_fused.py``), every other quantized weight
goes through ``quant_linear`` (``kernels/quant_matmul.py``), and decode
attention reads pages through ``kernels/paged_attention.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from mila_tpu_torch import ops
from mila_tpu_torch.device import DeviceLike, resolve_device
from mila_tpu_torch.inference.kv_cache import (
    make_paged_pools,
    paged_attention_read,
    paged_scatter,
)
from mila_tpu_torch.inference.quantize import QTensor, quantize
from mila_tpu_torch.kernels.decode_fused import (
    quant_linear_residual,
    rms_quant_linear,
    rms_quant_linear_swiglu,
)
from mila_tpu_torch.kernels.quant_matmul import quant_linear
from mila_tpu_torch.utils.config import BaseConfig, ConfigError

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class LlamaConfig(BaseConfig):
    vocab_size: int = 128256
    hidden_size: int = 2048
    intermediate_size: int = 8192
    num_layers: int = 16
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 0  # 0 -> hidden_size // num_heads
    max_seq_len: int = 8192
    rope_theta: float = 500000.0
    rope_scaling: Optional[dict] = None
    rms_eps: float = 1e-5
    tie_embeddings: bool = True
    param_dtype: str = "bfloat16"

    def validate(self):
        if min(self.vocab_size, self.hidden_size, self.num_layers, self.num_heads) <= 0:
            raise ConfigError("all Llama dims must be positive")
        if self.num_heads % self.num_kv_heads != 0:
            raise ConfigError("num_heads must divide by num_kv_heads")

    @property
    def hd(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    @staticmethod
    def llama32_1b() -> "LlamaConfig":
        """Llama-3.2-1B (HF config.json values)."""
        return LlamaConfig(
            name="llama-3.2-1b", vocab_size=128256, hidden_size=2048,
            intermediate_size=8192, num_layers=16, num_heads=32, num_kv_heads=8,
            head_dim=64, max_seq_len=131072, rope_theta=500000.0,
            rope_scaling={"rope_type": "llama3", "factor": 32.0, "low_freq_factor": 1.0,
                          "high_freq_factor": 4.0,
                          "original_max_position_embeddings": 8192},
            tie_embeddings=True,
        )

    @staticmethod
    def tiny(vocab_size: int = 512) -> "LlamaConfig":
        """Small config for tests."""
        return LlamaConfig(
            name="llama-tiny", vocab_size=vocab_size, hidden_size=128,
            intermediate_size=256, num_layers=2, num_heads=4, num_kv_heads=2,
            max_seq_len=128, rope_theta=10000.0, param_dtype="float32",
        )


def _is_q(w) -> bool:
    return isinstance(w, QTensor)


def linear_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    """``mila_tpu.nn.Linear.apply``: quantized weights take ``quant_linear``."""
    w = p["weight"]
    if _is_q(w):
        return quant_linear(x, w, p.get("bias"))
    return ops.linear(x, w, p.get("bias"))


class LlamaBlock:
    """Decoder layer: x += wo(attn(rope(q, k), v)) after ln_attn;
    x += down(swiglu(gate, up)) after ln_mlp."""

    def __init__(self, config: LlamaConfig):
        self.cfg = config

    def _fused_decode(self, params: dict, x: torch.Tensor) -> bool:
        B, T = x.shape[:2]
        return (B * T <= 32 and "wqkv" in params and "wgu" in params
                and _is_q(params["wqkv"]["weight"]) and _is_q(params["wgu"]["weight"]))

    def _qkv(self, params: dict, x: torch.Tensor):
        cfg = self.cfg
        B, T, _ = x.shape
        NQ = cfg.num_heads * cfg.hd
        NKVD = cfg.num_kv_heads * cfg.hd
        if self._fused_decode(params, x):
            qkv = rms_quant_linear(x, params["ln_attn"]["gamma"], params["wqkv"]["weight"],
                                   eps=cfg.rms_eps)
            q, k, v = qkv.split([NQ, NKVD, NKVD], dim=-1)
        elif "wqkv" in params:
            h = ops.rms_norm(x, params["ln_attn"]["gamma"], cfg.rms_eps)
            q, k, v = linear_apply(params["wqkv"], h).split([NQ, NKVD, NKVD], dim=-1)
        else:
            h = ops.rms_norm(x, params["ln_attn"]["gamma"], cfg.rms_eps)
            q = linear_apply(params["wq"], h)
            k = linear_apply(params["wk"], h)
            v = linear_apply(params["wv"], h)
        return (q.reshape(B, T, cfg.num_heads, cfg.hd),
                k.reshape(B, T, cfg.num_kv_heads, cfg.hd),
                v.reshape(B, T, cfg.num_kv_heads, cfg.hd))

    def _finish_attn(self, params: dict, x: torch.Tensor, att: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        B, T = att.shape[:2]
        if self._fused_decode(params, x):
            wo_q, down_q = params["wo"]["weight"], params["down"]["weight"]
            if _is_q(wo_q) and _is_q(down_q):
                x = quant_linear_residual(att.reshape(B, T, -1), wo_q, x)
                h = rms_quant_linear_swiglu(x, params["ln_mlp"]["gamma"],
                                            params["wgu"]["weight"], eps=cfg.rms_eps)
                return quant_linear_residual(h, down_q, x)
        h = linear_apply(params["wo"], att.reshape(B, T, -1))
        x = ops.residual(h, x)
        h = ops.rms_norm(x, params["ln_mlp"]["gamma"], cfg.rms_eps)
        if "wgu" in params:
            g, u = linear_apply(params["wgu"], h).chunk(2, dim=-1)
        else:
            g = linear_apply(params["gate"], h)
            u = linear_apply(params["up"], h)
        h = linear_apply(params["down"], ops.swiglu(g, u))
        return ops.residual(h, x)

    def apply(self, params: dict, x: torch.Tensor, cos, sin) -> torch.Tensor:
        q, k, v = self._qkv(params, x)
        q = ops.apply_rope(q, cos, sin)
        k = ops.apply_rope(k, cos, sin)
        att = ops.dot_product_attention(q, k, v, causal=True)
        return self._finish_attn(params, x, att)


class Llama:
    """The model's forward passes over a params dict (see module doc).

    ``device`` is where caches are allocated; it is the GPU unless the
    caller passes ``device="cpu"``, and without a GPU it raises.
    """

    def __init__(self, config: LlamaConfig, device: DeviceLike = None):
        config.validate()
        self.config = config
        self.device = resolve_device(device)
        self.blocks = [LlamaBlock(config) for _ in range(config.num_layers)]

    def _rope(self, positions: torch.Tensor):
        cfg = self.config
        return ops.rope_cos_sin(positions, cfg.hd, cfg.rope_theta, cfg.rope_scaling)

    def _logits(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        if "lm_head_q" in params:
            return quant_linear(x, params["lm_head_q"])[..., : self.config.vocab_size]
        if self.config.tie_embeddings:
            return ops.linear(x, params["embed"]["wte"].T, None)
        return linear_apply(params["lm_head"], x)

    def _norm_logits(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        """norm_f + head; the RMSNorm folds into the quantized head stream at
        decode shapes."""
        B, T = x.shape[:2]
        if "lm_head_q" in params and B * T <= 32:
            logits = rms_quant_linear(x, params["norm_f"]["gamma"], params["lm_head_q"],
                                      eps=self.config.rms_eps)
            return logits[..., : self.config.vocab_size]
        x = ops.rms_norm(x, params["norm_f"]["gamma"], self.config.rms_eps)
        return self._logits(params, x)

    def apply(self, params: dict, tokens: torch.Tensor) -> torch.Tensor:
        """Full causal forward: tokens [B, T] -> logits [B, T, V]."""
        B, T = tokens.shape
        x = params["embed"]["wte"][tokens.long()]
        cos, sin = self._rope(torch.arange(T, device=tokens.device)[None].expand(B, T))
        for i, blk in enumerate(self.blocks):
            x = blk.apply(params[f"h{i}"], x, cos, sin)
        x = ops.rms_norm(x, params["norm_f"]["gamma"], self.config.rms_eps)
        return self._logits(params, x)

    # --- paged KV-cache protocol (the engine's layout) ---

    def init_paged_cache(self, num_pages: int, page_size: int = 128,
                         dtype=torch.bfloat16) -> dict:
        cfg = self.config
        return make_paged_pools(cfg.num_layers, cfg.num_kv_heads, cfg.hd, num_pages,
                                page_size, dtype, self.device)

    def forward_paged_prefill(self, params: dict, tokens: torch.Tensor, pools: dict,
                              page_table: torch.Tensor, true_len: torch.Tensor):
        """Batched prompt prefill into pages (fresh sequences, position 0).

        tokens [B, T] right-padded, page_table [B, W], true_len [B]. Pages
        are written for the whole bucket. Returns (logits of each row's last
        valid token [B, V], pools); norm and head run on those B rows only.
        """
        B, T = tokens.shape
        ps = pools["k"].shape[4]
        W = page_table.shape[1]
        x = params["embed"]["wte"][tokens.long()]
        pos_ids = torch.arange(T, device=tokens.device)[None].expand(B, T)
        cos, sin = self._rope(pos_ids)
        page_ids = torch.gather(page_table.long(), 1, (pos_ids // ps).clamp_max(W - 1))
        offs = pos_ids % ps
        for i, blk in enumerate(self.blocks):
            bp = params[f"h{i}"]
            q, k, v = blk._qkv(bp, x)
            q = ops.apply_rope(q, cos, sin)
            k = ops.apply_rope(k, cos, sin)
            att = ops.dot_product_attention(q, k, v, causal=True)
            pools = paged_scatter(pools, i, page_ids, offs, k, v)
            x = blk._finish_attn(bp, x, att)
        rows = torch.arange(B, device=x.device)
        last = x[rows, (true_len.long() - 1).clamp_min(0)][:, None]
        return self._norm_logits(params, last)[:, 0], pools

    def forward_paged_ragged(self, params: dict, tokens: torch.Tensor, pools: dict,
                             page_table: torch.Tensor, positions: torch.Tensor):
        """Single-token decode with per-row positions: tokens [B, 1],
        positions [B] = tokens already stored per row. Writes K/V through the
        page table, reads them back through the paged attention kernel.
        Returns (logits [B, 1, V], pools)."""
        B = tokens.shape[0]
        ps = pools["k"].shape[4]
        W = page_table.shape[1]
        positions = positions.long()
        x = params["embed"]["wte"][tokens.long()]
        cos, sin = self._rope(positions[:, None])
        rows = torch.arange(B, device=tokens.device)
        page_ids = page_table.long()[rows, (positions // ps).clamp_max(W - 1)]
        offs = positions % ps
        lens = (positions + 1).to(torch.int32)
        for i, blk in enumerate(self.blocks):
            bp = params[f"h{i}"]
            q, k, v = blk._qkv(bp, x)
            q = ops.apply_rope(q, cos, sin)
            k = ops.apply_rope(k, cos, sin)
            pools = paged_scatter(pools, i, page_ids, offs, k[:, 0], v[:, 0])
            att = paged_attention_read(pools, i, q, page_table, lens)
            x = blk._finish_attn(bp, x, att)
        return self._norm_logits(params, x), pools


def fuse_llama_projections(params: dict) -> dict:
    """[wq|wk|wv] -> wqkv and [gate|up] -> wgu per block (concatenated on the
    out axis). Run before ``quantize_model_params``."""
    out = dict(params)
    for name, blk in params.items():
        if not (isinstance(blk, dict) and "wq" in blk and "gate" in blk):
            continue
        b = dict(blk)
        b["wqkv"] = {"weight": torch.cat(
            [b["wq"]["weight"], b["wk"]["weight"], b["wv"]["weight"]], dim=1)}
        b["wgu"] = {"weight": torch.cat([b["gate"]["weight"], b["up"]["weight"]], dim=1)}
        for k in ("wq", "wk", "wv", "gate", "up"):
            del b[k]
        out[name] = b
    return out


def add_quantized_lm_head(params: dict, dtype: str = "int8", pad_to: int = 2048) -> dict:
    """Add a quantized copy of wte^T for the tied head, its vocab axis
    zero-padded to a multiple of ``pad_to`` (logits are sliced back)."""
    out = dict(params)
    wt = params["embed"]["wte"].T
    V = wt.shape[1]
    vpad = -(-V // pad_to) * pad_to
    if vpad != V:
        wt = torch.nn.functional.pad(wt, (0, vpad - V))
    out["lm_head_q"] = quantize(wt.contiguous(), dtype)
    return out


def init_llama_params(cfg: LlamaConfig, generator: Optional[torch.Generator] = None,
                      device: DeviceLike = None, dtype=None) -> dict:
    """Random Llama parameters on ``device``: every weight and the embedding
    normal(0, 0.02), as ``mila_tpu/tensor/init.py:normal``; gammas ones.
    ``generator`` must live on ``device`` (``torch.Generator(device=...)``)."""
    dev = resolve_device(device)
    dt = dtype or DTYPES[cfg.param_dtype]
    H, I = cfg.hidden_size, cfg.intermediate_size
    NQ, NKVD = cfg.num_heads * cfg.hd, cfg.num_kv_heads * cfg.hd

    def normal(*shape):
        w = torch.empty(shape, dtype=torch.float32, device=dev)
        return w.normal_(0.0, 0.02, generator=generator).to(dt)

    def ones(n):
        return torch.ones(n, dtype=dt, device=dev)

    params = {"embed": {"wte": normal(cfg.vocab_size, H)}}
    for i in range(cfg.num_layers):
        params[f"h{i}"] = {
            "ln_attn": {"gamma": ones(H)},
            "wq": {"weight": normal(H, NQ)},
            "wk": {"weight": normal(H, NKVD)},
            "wv": {"weight": normal(H, NKVD)},
            "wo": {"weight": normal(NQ, H)},
            "ln_mlp": {"gamma": ones(H)},
            "gate": {"weight": normal(H, I)},
            "up": {"weight": normal(H, I)},
            "down": {"weight": normal(I, H)},
        }
    params["norm_f"] = {"gamma": ones(H)}
    if not cfg.tie_embeddings:
        params["lm_head"] = {"weight": normal(H, cfg.vocab_size)}
    return params
