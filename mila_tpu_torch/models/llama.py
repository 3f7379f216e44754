"""Llama-3.x: RMSNorm + RoPE + GQA + SwiGLU with the paged and the
contiguous KV-cache protocols (port of ``mila_tpu/models/llama.py``).
``LlamaBlock`` and ``Llama`` are ``CompositeModule``s with JAX's children,
so ``Model`` builds (``init``) and trains (``apply(..., training=True)``)
a Llama as it does GPT-2.

Parameters are a plain dict of tensors with the JAX package's tree layout
(``embed/wte``, ``h{i}/{ln_attn,wq,...}/...``, ``norm_f/gamma``, optional
``lm_head_q`` and ``layer_stream``), so
``mila_tpu_torch.bridge.params_from_jax`` maps a JAX tree 1:1. Weights are
[in, out].

The kernel dispatch mirrors the JAX model exactly, so that both sides take
the same arithmetic: quantized fused projections at B*T <= 32 rows run the
decode kernels (``kernels/decode_fused.py``), every other quantized weight
goes through ``quant_linear`` (``kernels/quant_matmul.py``; packed int4
weights take its int4 kernel at decode shapes and are unpacked to int8 for
prefill), the full forward and the paged prefill attend through
``ops.attention.attention`` (``config.attention_impl``: the flash kernel of
``kernels/flash_attention.py`` on the card from ``FLASH_MIN_SEQ`` keys,
else the plain product), paged decode
attention reads pages through ``kernels/paged_attention.py``, and
contiguous decode attention reads the cache through
``kernels/dense_attention.py``. With ``pack_decode_layers`` params a decode
step runs two kernels per layer: ``fused_decode_attention`` and
``layer_tail_stream`` (``kernels/layer_stream.py``); the greedy head fuses
its argmax (``rms_quant_linear_argmax``). With ``pack_decode_megalayers``
params a step runs one kernel per layer (``layer_megakernel``); with
``pack_decode_mlp`` params the MLP block of a decode layer is one weight
stream (``mlp_block_fused``); with ``pack_decode_giga`` params ``giga_step``
runs the whole step, embedding to argmax, as one kernel
(``giga_decode_step``) over stacked [L, B, T, NKV*HD] pools.

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
from mila_tpu_torch.inference.quantize import QTensor, quantize, unit_qtensor, unpack_int4
from mila_tpu_torch.inference.requant import requantize_int8
from mila_tpu_torch.kernels.decode_fused import (
    quant_linear_residual,
    rms_quant_linear,
    rms_quant_linear_argmax,
    rms_quant_linear_swiglu,
)
from mila_tpu_torch.kernels.decode_giga import giga_decode_step, pack_giga
from mila_tpu_torch.kernels.decode_mlp import mlp_block_fused, pack_mlp
from mila_tpu_torch.kernels.dense_attention import (
    dense_decode_attention,
    fused_decode_attention,
)
from mila_tpu_torch.kernels.layer_fused import pack_layer
from mila_tpu_torch.kernels.layer_mega import (
    layer_megakernel,
    pack_mega_layer,
    permute_q_columns,
)
from mila_tpu_torch.kernels.layer_stream import layer_tail_stream, pack_layer_stream
from mila_tpu_torch.kernels.quant_matmul import quant_linear
from mila_tpu_torch.nn import Encoder, EncoderConfig, Linear, LinearConfig, RMSNorm
from mila_tpu_torch.nn.layers import LayerNormConfig
from mila_tpu_torch.nn.module import CompositeModule, Params
from mila_tpu_torch.ops.attention import attention
from mila_tpu_torch.utils.config import BaseConfig, ConfigError
from mila_tpu_torch.utils.rng import split_named

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
    attention_impl: str = "auto"  # auto | xla (the plain product) | flash

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


class LlamaBlock(CompositeModule):
    """Decoder layer: x += wo(attn(rope(q, k), v)) after ln_attn;
    x += down(swiglu(gate, up)) after ln_mlp. Children and parameter names
    are JAX's: ln_attn, wq, wk, wv, wo, ln_mlp, gate, up, down (Linear
    weights [in, out], no bias, normal(0, 0.02); RMSNorm gammas ones)."""

    def __init__(self, config: LlamaConfig, name: str):
        super().__init__(BaseConfig(name=name))
        self.cfg = config
        H, HD = config.hidden_size, config.hd
        NH, NKV, FF = config.num_heads, config.num_kv_heads, config.intermediate_size
        dt = config.param_dtype

        def lin(n, i, o):
            return Linear(LinearConfig(name=n, in_features=i, out_features=o, has_bias=False,
                                       initializer="normal", param_dtype=dt))

        def norm(n):
            return RMSNorm(LayerNormConfig(name=n, features=H, eps=config.rms_eps,
                                           param_dtype=dt))

        for n, m in (("ln_attn", norm("ln_attn")), ("wq", lin("wq", H, NH * HD)),
                     ("wk", lin("wk", H, NKV * HD)), ("wv", lin("wv", H, NKV * HD)),
                     ("wo", lin("wo", NH * HD, H)), ("ln_mlp", norm("ln_mlp")),
                     ("gate", lin("gate", H, FF)), ("up", lin("up", H, FF)),
                     ("down", lin("down", FF, H))):
            self.add(n, m)

    def init(self, gen, input_shape, device=None) -> Params:
        device = resolve_device(device)
        gens = split_named(gen, *[n for n, _ in self.children()])
        cfg, out = self.cfg, {}
        for name, child in self.children():
            shape = tuple(input_shape)
            if name == "down":
                shape = (*shape[:-1], cfg.intermediate_size)
            elif name == "wo":
                shape = (*shape[:-1], cfg.num_heads * cfg.hd)
            out[name] = child.init(gens[name], shape, device=device)
        return out

    def output_shape(self, input_shape):
        return tuple(input_shape)

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
            q, k, v = self.get("wq").apply(params["wqkv"], h).split([NQ, NKVD, NKVD], dim=-1)
        else:
            h = ops.rms_norm(x, params["ln_attn"]["gamma"], cfg.rms_eps)
            q = self.get("wq").apply(params["wq"], h)
            k = self.get("wk").apply(params["wk"], h)
            v = self.get("wv").apply(params["wv"], h)
        return (q.reshape(B, T, cfg.num_heads, cfg.hd),
                k.reshape(B, T, cfg.num_kv_heads, cfg.hd),
                v.reshape(B, T, cfg.num_kv_heads, cfg.hd))

    def _finish_attn(self, params: dict, x: torch.Tensor, att: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        B, T = att.shape[:2]
        if self._fused_decode(params, x):
            if "mlp_pack" in params:
                return mlp_block_fused(att.reshape(B, T, -1), x, params["ln_mlp"]["gamma"],
                                       params["mlp_pack"], eps=cfg.rms_eps)
            wo_q, down_q = params["wo"]["weight"], params["down"]["weight"]
            if _is_q(wo_q) and _is_q(down_q):
                x = quant_linear_residual(att.reshape(B, T, -1), wo_q, x)
                h = rms_quant_linear_swiglu(x, params["ln_mlp"]["gamma"],
                                            params["wgu"]["weight"], eps=cfg.rms_eps)
                return quant_linear_residual(h, down_q, x)
        h = self.get("wo").apply(params["wo"], att.reshape(B, T, -1))
        x = ops.residual(h, x)
        h = ops.rms_norm(x, params["ln_mlp"]["gamma"], cfg.rms_eps)
        if "wgu" in params:
            g, u = self.get("gate").apply(params["wgu"], h).chunk(2, dim=-1)
        else:
            g = self.get("gate").apply(params["gate"], h)
            u = self.get("up").apply(params["up"], h)
        h = self.get("down").apply(params["down"], ops.swiglu(g, u))
        return ops.residual(h, x)

    def apply(self, params, x, *, cos=None, sin=None, training=False, rngs=None):
        """Full causal forward of x [B, T, H] with RoPE tables cos, sin."""
        q, k, v = self._qkv(params, x)
        q = ops.apply_rope(q, cos, sin)
        k = ops.apply_rope(k, cos, sin)
        att = attention(q, k, v, causal=True, impl=self.cfg.attention_impl)
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


class Llama(CompositeModule):
    """Llama as a module (children embed, h0..h{L-1}, norm_f, and lm_head
    when the embeddings are untied; JAX's names) with its forward passes
    over a params dict (see the module doc). ``init`` and ``apply`` are
    the training interface ``Model`` calls.

    ``device`` is where caches, and by default ``init``'s params, are
    allocated; it is the GPU unless the caller passes ``device="cpu"``,
    and without a GPU it raises.
    """

    def __init__(self, config: LlamaConfig, device: DeviceLike = None):
        super().__init__(config)
        self.device = resolve_device(device)
        cfg = config
        self.add("embed", Encoder(EncoderConfig(
            name="embed", vocab_size=cfg.vocab_size, embedding_dim=cfg.hidden_size,
            max_seq_len=0, param_dtype=cfg.param_dtype)))
        for i in range(cfg.num_layers):
            self.add(f"h{i}", LlamaBlock(cfg, f"h{i}"))
        self.add("norm_f", RMSNorm(LayerNormConfig(
            name="norm_f", features=cfg.hidden_size, eps=cfg.rms_eps,
            param_dtype=cfg.param_dtype)))
        if not cfg.tie_embeddings:
            self.add("lm_head", Linear(LinearConfig(
                name="lm_head", in_features=cfg.hidden_size, out_features=cfg.vocab_size,
                has_bias=False, param_dtype=cfg.param_dtype)))
        self.blocks = [self.get(f"h{i}") for i in range(cfg.num_layers)]

    def init(self, gen, input_shape, device=None) -> Params:
        """Random params on ``device`` (the model's own unless named), drawn
        on ``gen``'s device: a generator on the card draws there."""
        device = self.device if device is None else resolve_device(device)
        gens = split_named(gen, *[n for n, _ in self.children()])
        B, T = input_shape
        out: Params = {"embed": self.get("embed").init(gens["embed"], (B, T), device=device)}
        shape = (B, T, self.config.hidden_size)
        for name, child in self.children():
            if name != "embed":
                out[name] = child.init(gens[name], shape, device=device)
        return out

    def output_shape(self, input_shape):
        return (*tuple(input_shape), self.config.vocab_size)

    def _rope(self, positions: torch.Tensor):
        cfg = self.config
        return ops.rope_cos_sin(positions, cfg.hd, cfg.rope_theta, cfg.rope_scaling)

    def _logits(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        if "lm_head_q" in params:
            return quant_linear(x, params["lm_head_q"])[..., : self.config.vocab_size]
        if self.config.tie_embeddings:
            return ops.linear(x, params["embed"]["wte"].T, None)
        return self.get("lm_head").apply(params["lm_head"], x)

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

    def apply(self, params, tokens, *, training=False, rngs=None):
        """Full causal forward: tokens [B, T] -> logits [B, T, V]. Under
        autograd every op carries JAX's VJP (``embedding_lookup``'s ordered
        segment sum, ``rms_norm``, ``linear``, ``swiglu``, ``residual``; the
        flash kernel's backward where ``attention`` takes it)."""
        B, T = tokens.shape
        x = ops.embedding_lookup(tokens, params["embed"]["wte"])
        cos, sin = self._rope(torch.arange(T, device=tokens.device)[None].expand(B, T))
        for i, blk in enumerate(self.blocks):
            x = blk.apply(params[f"h{i}"], x, cos=cos, sin=sin, training=training, rngs=rngs)
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
            att = attention(q, k, v, causal=True, impl=self.config.attention_impl)
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

    def forward_paged_chunk(self, params: dict, tokens: torch.Tensor, pools: dict,
                            page_table: torch.Tensor, positions: torch.Tensor):
        """Multi-token paged forward with per-row start positions (the
        speculative verify): tokens [B, t], positions [B] = tokens already
        stored per row; token j of row b sits at positions[b] + j. K/V are
        written through the page table; the [B, t] queries are flattened to
        B*t rows of the paged attention kernel, each row's table repeated t
        times and its length its own causal prefix. The projections and the
        head take the fused decode kernels at B*t <= 32 rows and
        ``quant_linear`` beyond, as every other forward does. Returns
        (logits [B, t, V], pools)."""
        cfg = self.config
        B, t = tokens.shape
        ps = pools["k"].shape[4]
        W = page_table.shape[1]
        x = params["embed"]["wte"][tokens.long()]
        pos_bt = positions.long()[:, None] + torch.arange(t, device=tokens.device)[None]
        cos, sin = self._rope(pos_bt)
        page_ids = torch.gather(page_table.long(), 1, (pos_bt // ps).clamp_max(W - 1))
        offs = pos_bt % ps
        flat_table = page_table.repeat_interleave(t, dim=0)
        flat_lens = (pos_bt + 1).to(torch.int32).reshape(-1)
        for i, blk in enumerate(self.blocks):
            bp = params[f"h{i}"]
            q, k, v = blk._qkv(bp, x)
            q = ops.apply_rope(q, cos, sin)
            k = ops.apply_rope(k, cos, sin)
            pools = paged_scatter(pools, i, page_ids, offs, k, v)
            qf = q.reshape(B * t, 1, cfg.num_heads, cfg.hd)
            att = paged_attention_read(pools, i, qf, flat_table, flat_lens)
            x = blk._finish_attn(bp, x, att.reshape(B, t, cfg.num_heads, cfg.hd))
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

    @staticmethod
    def _tiled_tables(cos, sin, nkv: int):
        """Full-width tiled RoPE tables [B, NKV*HD]: cos duplicated across the
        split halves, sin pre-signed [-sin | sin]."""
        B = cos.shape[0]
        c2, s2 = cos.reshape(B, -1), sin.reshape(B, -1)
        return (torch.cat([c2, c2], dim=-1).repeat(1, nkv),
                torch.cat([-s2, s2], dim=-1).repeat(1, nkv))

    def _backbone_fused_decode(self, params: dict, x: torch.Tensor, cache: dict,
                               old_lens: torch.Tensor, cos, sin):
        """Two kernels per layer: fused decode attention (RoPE, attention,
        cache write-back) then the layer tail with the NEXT layer's
        rms + wqkv (``layer_stream``); or one (``layer_megakernel``) with
        ``mega_pack`` params. Per-row ``old_lens`` (ragged)."""
        cfg = self.config
        B = x.shape[0]
        NH, NKV, HD = cfg.num_heads, cfg.num_kv_heads, cfg.hd
        NQ, KD = NH * HD, NKV * HD
        cos_t, sin_t = self._tiled_tables(cos, sin, NKV)
        # The JAX package's route rule, kept so that both sides take the same
        # route: its megakernel holds a layer's whole cache in VMEM (double-
        # buffered, within 72 MB) unless there is no layer_stream to fall back to.
        kc0 = cache["h0"]["k"]
        fits = (2 * 2 * kc0.numel() * kc0.element_size() <= 72 * 1024 * 1024
                or "layer_stream" not in params)
        if "mega_pack" in params["h0"] and fits:
            return self._backbone_mega_decode(params, x, cache, old_lens, cos_t, sin_t)
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

    def _backbone_mega_decode(self, params: dict, x: torch.Tensor, cache: dict,
                              old_lens: torch.Tensor, cos_t, sin_t):
        """One kernel per layer (``layer_megakernel``): attention with the
        cache write and the whole layer tail, from the slot-ordered qkv row
        of layer 0's ``wqkv_slot``."""
        cfg = self.config
        B, H = x.shape[0], cfg.hidden_size
        qkv = rms_quant_linear(x, params["h0"]["ln_attn"]["gamma"], params["h0"]["wqkv_slot"],
                               eps=cfg.rms_eps).reshape(B, -1)
        x2 = x.reshape(B, H)
        new_cache = {}
        for i in range(cfg.num_layers):
            bp, lc = params[f"h{i}"], cache[f"h{i}"]
            gamma_next = (params[f"h{i + 1}"]["ln_attn"]["gamma"]
                          if i + 1 < cfg.num_layers else None)
            x2, qkv, k_c, v_c = layer_megakernel(
                qkv, x2, bp["ln_mlp"]["gamma"], bp["mega_pack"], lc["k"], lc["v"], old_lens,
                cos_t, sin_t, gamma_next, num_heads=cfg.num_heads, eps=cfg.rms_eps)
            new_cache[f"h{i}"] = {"k": k_c, "v": v_c}
        return x2.reshape(B, 1, H), new_cache

    # --- whole-model single-kernel decode (kernels/decode_giga.py) ---

    def stack_kv_cache(self, cache: dict):
        """Per-layer dict cache -> stacked (k_pool, v_pool) [L, B, T,
        NKV*HD] (a copy; kept 4-D, as JAX keeps them)."""
        L = self.config.num_layers
        k = torch.stack([cache[f"h{i}"]["k"] for i in range(L)])
        v = torch.stack([cache[f"h{i}"]["v"] for i in range(L)])
        _, B, T, NKV, HD = k.shape
        return k.reshape(L, B, T, NKV * HD), v.reshape(L, B, T, NKV * HD)

    def unstack_kv_cache(self, k_pool: torch.Tensor, v_pool: torch.Tensor) -> dict:
        """Stacked pools -> the per-layer dict cache. The layers are views of
        the pools (JAX returns new arrays): writes through either side land
        in the other."""
        cfg = self.config
        L, B, T, _ = k_pool.shape
        NKV, HD = cfg.num_kv_heads, cfg.hd
        return {f"h{i}": {"k": k_pool[i].view(B, T, NKV, HD), "v": v_pool[i].view(B, T, NKV, HD)}
                for i in range(L)}

    def _giga_tables(self, lens: torch.Tensor):
        """Full-width tiled RoPE tables for the giga kernel's x mode."""
        cos, sin = self._rope(lens[:, None])
        return self._tiled_tables(cos, sin, self.config.num_kv_heads)

    def giga_step(self, params: dict, tokens: torch.Tensor, k_pool: torch.Tensor,
                  v_pool: torch.Tensor, lens: torch.Tensor):
        """One whole-model decode step as one kernel (``giga_decode_step`` in
        the tokens mode: embedding, RoPE tables, every layer, the head and
        its argmax). ``lens`` [B] int32 = live cache rows per sequence (the
        current token excluded). Returns (next_token [B, 1] int32, logits
        [B, vocab], k_pool, v_pool), the pools written in place."""
        tok, logits, k_pool, v_pool = giga_decode_step(
            params["embed"]["wte"], None, None, lens, params["giga_pack"], k_pool, v_pool,
            tokens=tokens.reshape(-1))
        return tok, logits[:, :self.config.vocab_size], k_pool, v_pool

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


def _layer_names(params: dict) -> list:
    return sorted((n for n in params if n.startswith("h") and n[1:].isdigit()),
                  key=lambda n: int(n[1:]))


def _get_qt(blk, name: str) -> Optional[QTensor]:
    w = blk.get(name, {}).get("weight") if isinstance(blk, dict) else None
    return w if isinstance(w, QTensor) else None


def pack_decode_mlp(params: dict, *, bn: int = 2048) -> dict:
    """Add the MLP-block weight stream (``mlp_pack``: wo, wgu and down) to
    every quantized block that packs. Run after ``fuse_llama_projections``
    + ``quantize_model_params``; the QTensors stay for prefill."""
    out = dict(params)
    for name, blk in params.items():
        if not (isinstance(blk, dict) and "wgu" in blk and "wo" in blk):
            continue
        wo, wgu, down = (_get_qt(blk, k) for k in ("wo", "wgu", "down"))
        if not all((wo, wgu, down)):
            continue
        pack = pack_mlp(wo, wgu, down, bn=bn)
        if pack is not None:
            out[name] = {**blk, "mlp_pack": pack}
    return out


def pack_decode_megalayers(params: dict, cfg: LlamaConfig, *, bn: int = 512) -> dict:
    """Per-layer single-kernel decode packs (``mega_pack``: layer i's
    slot-permuted wo, its wgu and down, layer i+1's slot-permuted wqkv) and
    a slot-permuted copy of layer 0's wqkv (``wqkv_slot``) for the first
    projection. Run after ``fuse_llama_projections`` +
    ``quantize_model_params``. All or nothing."""
    NH, NKV, HD = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    names = _layer_names(params)
    megas = []
    for idx, name in enumerate(names):
        wo, wgu, down = (_get_qt(params[name], k) for k in ("wo", "wgu", "down"))
        if not all((wo, wgu, down)):
            return params
        wqkv_next = None
        if idx + 1 < len(names):
            wqkv_next = _get_qt(params[names[idx + 1]], "wqkv")
            if wqkv_next is None:
                return params
        mp = pack_mega_layer(wo, wgu, down, wqkv_next, nh=NH, nkv=NKV, hd=HD, bn=bn)
        if mp is None:
            return params
        megas.append(mp)
    wqkv0 = _get_qt(params[names[0]], "wqkv")
    if wqkv0 is None:
        return params
    out = dict(params)
    for name, mp in zip(names, megas):
        out[name] = {**out[name], "mega_pack": mp}
    out[names[0]] = {**out[names[0]], "wqkv_slot": permute_q_columns(wqkv0, NH, NKV, HD)}
    return out


def pack_decode_giga(params: dict, cfg: LlamaConfig, *, bn: int = 512,
                     bf16_stream: bool = False) -> dict:
    """Add the whole-model decode weight stream (``giga_pack``): every
    layer's slot-permuted wo, wgu, down and the next layer's wqkv, layer 0's
    wqkv first, the padded quantized head last (``kernels/decode_giga.py``).
    Run after ``fuse_llama_projections`` + ``quantize_model_params`` +
    ``add_quantized_lm_head``. fp8 weights go onto an int8 grid
    (``requantize_int8``) and int4 weights are unpacked to int8 rows first,
    as JAX does. An unquantized model packs bf16 tiles with unit scales only
    with ``bf16_stream=True`` (the CPU path runs them; the kernel raises).
    All or nothing: params come back unchanged when a shape does not fit."""
    head = params.get("lm_head_q")
    if isinstance(head, QTensor):
        bf16_mode = False
        head = requantize_int8(unpack_int4(head))
    elif bf16_stream:
        bf16_mode = True
        wt = params["embed"]["wte"].T
        V = wt.shape[1]
        vpad = -(-V // bn) * bn
        if vpad != V:
            wt = torch.nn.functional.pad(wt, (0, vpad - V))
        head = unit_qtensor(wt)
    else:
        return params

    def stream_qt(blk, name):
        w = blk.get(name, {}).get("weight") if isinstance(blk, dict) else None
        if bf16_mode:
            if isinstance(w, QTensor) or w is None or w.ndim != 2:
                return None
            return unit_qtensor(w)
        if not isinstance(w, QTensor):
            return None
        return requantize_int8(unpack_int4(w))

    weights, ga, gm = [], [], []
    for name in _layer_names(params):
        blk = params[name]
        ws = tuple(stream_qt(blk, k) for k in ("wo", "wgu", "down", "wqkv"))
        if not all(w is not None for w in ws):
            return params
        weights.append(ws)
        ga.append(blk["ln_attn"]["gamma"].float())
        gm.append(blk["ln_mlp"]["gamma"].float())
    pack = pack_giga(weights, head, torch.stack(ga), torch.stack(gm),
                     params["norm_f"]["gamma"].float(), nh=cfg.num_heads,
                     nkv=cfg.num_kv_heads, hd=cfg.hd, vocab=cfg.vocab_size, eps=cfg.rms_eps,
                     bn=bn, rope_inv_freq=ops.rope_frequencies(cfg.hd, cfg.rope_theta,
                                                               cfg.rope_scaling))
    if pack is None:
        return params
    return {**params, "giga_pack": pack}


def decode_step_bytes(params: dict, cfg: LlamaConfig, batch: int, cache_len: int,
                      kv_bytes_per_el: int = 2) -> dict:
    """Device-memory bytes one decode step must move (port of
    ``benchmarks/llama_bench.py:decode_step_bytes``): every quantized weight
    (q and scales) and 2-D weight once, the bf16 embedding only when it is
    the head, and the K/V cache rows read at ``cache_len``. The decode packs
    (``layer_stream``, ``mlp_pack``, ``mega_pack``) are a second image of
    weights already counted. With a ``giga_pack`` the stream is the step's
    whole weight image: its tiles and scale rows are what is counted."""
    kv = 2 * batch * cache_len * cfg.num_kv_heads * cfg.hd * kv_bytes_per_el * cfg.num_layers
    if "giga_pack" in params:
        gp = params["giga_pack"]
        return {"weight_bytes": int(gp.w.nbytes + gp.s.nbytes), "kv_read_bytes": int(kv)}
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
