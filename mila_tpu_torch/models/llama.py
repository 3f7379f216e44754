"""Llama-3.x: RMSNorm + RoPE + GQA + SwiGLU with the paged and the
contiguous KV-cache protocols (port of ``mila_tpu/models/llama.py``).

Parameters are a plain dict of tensors with the JAX package's tree layout
(``embed/wte``, ``h{i}/{ln_attn,wq,...}/...``, ``norm_f/gamma``, optional
``lm_head_q`` and ``layer_stream``), so
``mila_tpu_torch.bridge.params_from_jax`` maps a JAX tree 1:1. Weights are
[in, out].

The kernel dispatch mirrors the JAX model exactly, so that both sides take
the same arithmetic: quantized fused projections at B*T <= 32 rows run the
decode kernels (``kernels/decode_fused.py``), every other quantized weight
goes through ``quant_linear`` (``kernels/quant_matmul.py``), paged decode
attention reads pages through ``kernels/paged_attention.py``, and
contiguous decode attention reads the cache through
``kernels/dense_attention.py``. With ``pack_decode_layers`` params a decode
step runs two kernels per layer: ``fused_decode_attention`` and
``layer_tail_stream`` (``kernels/layer_stream.py``); the greedy head fuses
its argmax (``rms_quant_linear_argmax``).

JAX's caches are immutable values; the port's contiguous caches are
written in place (the new rows of each step go into the tensors passed
in), and the functions return the same tensors, so callers may rebind as
with JAX.
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
    rms_quant_linear_argmax,
    rms_quant_linear_swiglu,
)
from mila_tpu_torch.kernels.dense_attention import (
    dense_decode_attention,
    fused_decode_attention,
)
from mila_tpu_torch.kernels.layer_fused import pack_layer
from mila_tpu_torch.kernels.layer_stream import layer_tail_stream, pack_layer_stream
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

    def apply_with_cache(self, params: dict, x: torch.Tensor, cache: dict, pos: int,
                         cos, sin):
        """Incremental step: x [B, t, H] at absolute position ``pos``; the
        cache [B, maxT, NKV, HD] (token-major) takes rows pos..pos+t-1 in
        place. One token attends through the dense decode kernel, a prompt
        through the plain masked attention. Returns (x, cache)."""
        q, k, v = self._qkv(params, x)
        q = ops.apply_rope(q, cos, sin)
        k = ops.apply_rope(k, cos, sin)
        kc, vc = cache["k"], cache["v"]
        B, t = x.shape[:2]
        kc[:, pos:pos + t] = k.to(kc.dtype)
        vc[:, pos:pos + t] = v.to(vc.dtype)
        total = pos + t
        if t == 1:
            lens = torch.full((B,), total, dtype=torch.int32, device=x.device)
            att = dense_decode_attention(q, kc, vc, lens)
        else:
            maxT = kc.shape[1]
            kj = torch.arange(maxT, device=x.device)[None, :]
            qi = torch.arange(t, device=x.device)[:, None] + pos
            mask = (kj <= qi)[None].expand(B, t, maxT)
            att = ops.dot_product_attention(q, kc, vc, causal=False, mask=mask)
        return self._finish_attn(params, x, att), {"k": kc, "v": vc}


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

    # --- contiguous KV-cache protocol (Generator, bench decode, engine) ---

    def init_kv_cache(self, batch_size: int, max_len: int = 0, dtype=torch.bfloat16) -> dict:
        """Per-layer token-major caches {"h{i}": {"k", "v"}} of [B, maxT, NKV,
        HD] zeros; maxT rounded up to a multiple of 8 (the fused decode
        kernel's alignment rule)."""
        cfg = self.config
        maxT = max_len or min(cfg.max_seq_len, 4096)
        maxT = (maxT + 7) // 8 * 8
        shape = (batch_size, maxT, cfg.num_kv_heads, cfg.hd)
        return {f"h{i}": {"k": torch.zeros(shape, dtype=dtype, device=self.device),
                          "v": torch.zeros(shape, dtype=dtype, device=self.device)}
                for i in range(cfg.num_layers)}

    @staticmethod
    def _fused_decode_ready(params: dict) -> bool:
        return "layer_stream" in params or "mega_pack" in params.get("h0", {})

    def _backbone_with_cache(self, params: dict, tokens: torch.Tensor, cache: dict, pos: int):
        """Embed + decoder stack (no head): returns (x [B, t, H], cache)."""
        B, t = tokens.shape
        pos = int(pos)
        x = params["embed"]["wte"][tokens.long()]
        positions = pos + torch.arange(t, device=tokens.device)[None].expand(B, t)
        cos, sin = self._rope(positions)
        if t == 1 and B <= 32 and self._fused_decode_ready(params):
            old_lens = torch.full((B,), pos, dtype=torch.int32, device=tokens.device)
            return self._backbone_fused_decode(params, x, cache, old_lens, cos, sin)
        new_cache = {}
        for i, blk in enumerate(self.blocks):
            x, new_cache[f"h{i}"] = blk.apply_with_cache(params[f"h{i}"], x, cache[f"h{i}"],
                                                         pos, cos, sin)
        return x, new_cache

    def _backbone_fused_decode(self, params: dict, x: torch.Tensor, cache: dict,
                               old_lens: torch.Tensor, cos, sin):
        """Two kernels per layer: fused decode attention (RoPE, attention,
        cache write-back) then the layer tail with the NEXT layer's
        rms + wqkv (``layer_stream``). Per-row ``old_lens`` (ragged)."""
        if "mega_pack" in params.get("h0", {}):
            raise NotImplementedError("layer_megakernel (kernel table row 14, "
                                      "pack_decode_megalayers) is not ported yet")
        cfg = self.config
        B = x.shape[0]
        NH, NKV, HD = cfg.num_heads, cfg.num_kv_heads, cfg.hd
        NQ, KD = NH * HD, NKV * HD
        # Full-width tiled RoPE tables, once per step: cos duplicated across
        # the split halves, sin pre-signed [-sin | sin].
        c2, s2 = cos.reshape(B, HD // 2), sin.reshape(B, HD // 2)
        cos_t = torch.cat([c2, c2], dim=-1).repeat(1, NKV)
        sin_t = torch.cat([-s2, s2], dim=-1).repeat(1, NKV)
        qkv = rms_quant_linear(x, params["h0"]["ln_attn"]["gamma"],
                               params["h0"]["wqkv"]["weight"], eps=cfg.rms_eps)
        new_cache = {}
        for i in range(cfg.num_layers):
            lc = cache[f"h{i}"]
            att, _, k_c, v_c = fused_decode_attention(
                qkv.reshape(B, NQ + 2 * KD), None, cos_t, sin_t, lc["k"], lc["v"], old_lens,
                num_heads=NH)
            new_cache[f"h{i}"] = {"k": k_c, "v": v_c}
            gamma_next = (params[f"h{i + 1}"]["ln_attn"]["gamma"]
                          if i + 1 < cfg.num_layers else None)
            x, qkv = layer_tail_stream(att.reshape(B, 1, NQ), x,
                                       params[f"h{i}"]["ln_mlp"]["gamma"],
                                       params["layer_stream"], i, gamma_next, eps=cfg.rms_eps)
        return x, new_cache

    def forward_with_cache(self, params: dict, tokens: torch.Tensor, cache: dict, pos: int):
        """tokens [B, t] at absolute position ``pos`` -> (logits [B, t, V],
        cache)."""
        x, new_cache = self._backbone_with_cache(params, tokens, cache, pos)
        return self._norm_logits(params, x), new_cache

    def greedy_step_with_cache(self, params: dict, tokens: torch.Tensor, cache: dict,
                               pos: int):
        """Greedy decode step: (next_token [B, 1] int32, cache). At decode
        shapes with a quantized head the argmax fuses into the head's weight
        stream; otherwise forward_with_cache + argmax."""
        V = self.config.vocab_size
        B, t = tokens.shape
        if "lm_head_q" in params and B * t <= 32:
            x, new_cache = self._backbone_with_cache(params, tokens, cache, pos)
            tok = rms_quant_linear_argmax(x[:, -1:, :], params["norm_f"]["gamma"],
                                          params["lm_head_q"], vocab_size=V,
                                          eps=self.config.rms_eps)
            if tok is not None:
                return tok.reshape(B, 1), new_cache
            logits = self._norm_logits(params, x[:, -1:, :])
        else:
            logits, new_cache = self.forward_with_cache(params, tokens, cache, pos)
        nxt = torch.argmax(logits[:, -1, :V], dim=-1)
        return nxt.to(torch.int32)[:, None], new_cache

    def forward_with_cache_ragged(self, params: dict, tokens: torch.Tensor, cache: dict,
                                  positions: torch.Tensor):
        """Single-token decode with per-row positions (continuous batching):
        tokens [B, 1], positions [B] = rows already stored per sequence.
        Returns (logits [B, 1, V], cache)."""
        B = tokens.shape[0]
        x = params["embed"]["wte"][tokens.long()]
        cos, sin = self._rope(positions[:, None])
        if B <= 32 and self._fused_decode_ready(params):
            x, new_cache = self._backbone_fused_decode(
                params, x, cache, positions.to(torch.int32), cos, sin)
            return self._norm_logits(params, x), new_cache
        rows = torch.arange(B, device=tokens.device)
        pos = positions.long()
        lens = (positions + 1).to(torch.int32)
        new_cache = {}
        for i, blk in enumerate(self.blocks):
            bp, lc = params[f"h{i}"], cache[f"h{i}"]
            q, k, v = blk._qkv(bp, x)
            q = ops.apply_rope(q, cos, sin)
            k = ops.apply_rope(k, cos, sin)
            lc["k"][rows, pos] = k[:, 0].to(lc["k"].dtype)
            lc["v"][rows, pos] = v[:, 0].to(lc["v"].dtype)
            att = dense_decode_attention(q, lc["k"], lc["v"], lens)
            x = blk._finish_attn(bp, x, att)
            new_cache[f"h{i}"] = {"k": lc["k"], "v": lc["v"]}
        return self._norm_logits(params, x), new_cache


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


def pack_decode_layers(params: dict, *, bn: int = 512) -> dict:
    """Add the whole-layer decode weight stream (``layer_stream``: wo, wgu
    and down of layer i plus wqkv of layer i+1, stacked for every layer).
    Run after ``fuse_llama_projections`` + ``quantize_model_params``. The
    original QTensors stay for prefill, so the stream is a second int8 image
    of those weights. All or nothing: params come back unchanged when any
    layer does not pack."""

    def get_qt(blk, name):
        w = blk.get(name, {}).get("weight") if isinstance(blk, dict) else None
        return w if isinstance(w, QTensor) else None

    names = sorted((n for n in params if n.startswith("h") and n[1:].isdigit()),
                   key=lambda n: int(n[1:]))
    packs = []
    for idx, name in enumerate(names):
        wo, wgu, down = (get_qt(params[name], k) for k in ("wo", "wgu", "down"))
        if not all((wo, wgu, down)):
            return params
        wqkv_next = None
        if idx + 1 < len(names):
            wqkv_next = get_qt(params[names[idx + 1]], "wqkv")
            if wqkv_next is None:
                return params
        pack = pack_layer(wo, wgu, down, wqkv_next, bn=bn)
        if pack is None:
            return params
        packs.append(pack)
    stream = pack_layer_stream(packs)
    if stream is None:
        return params
    return {**params, "layer_stream": stream}


def decode_step_bytes(params: dict, cfg: LlamaConfig, batch: int, cache_len: int,
                      kv_bytes_per_el: int = 2) -> dict:
    """Device-memory bytes one decode step must move (port of
    ``benchmarks/llama_bench.py:decode_step_bytes``): every quantized weight
    (q and scales) and 2-D weight once, the bf16 embedding only when it is
    the head, and the K/V cache rows read at ``cache_len``. The decode packs
    (``layer_stream``) are a second image of weights already counted."""
    has_qhead = isinstance(params.get("lm_head_q"), QTensor)
    weight = 0

    def visit(node):
        nonlocal weight
        if isinstance(node, QTensor):
            weight += node.q.nbytes + node.scale.nbytes
        elif isinstance(node, dict):
            for v in node.values():
                visit(v)
        elif isinstance(node, torch.Tensor) and node.ndim == 2:
            weight += node.nbytes

    for name, sub in params.items():
        if name == "embed":
            if not has_qhead and "lm_head" not in params:
                weight += sub["wte"].nbytes
        elif name != "layer_stream":
            visit(sub)
    kv = 2 * batch * cache_len * cfg.num_kv_heads * cfg.hd * kv_bytes_per_el * cfg.num_layers
    return {"weight_bytes": int(weight), "kv_read_bytes": int(kv)}


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
