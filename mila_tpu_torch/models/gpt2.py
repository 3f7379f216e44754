"""GPT-2: encoder, N pre-LN transformer blocks, final LayerNorm and the LM
head, tied to the token table by default (port of ``mila_tpu/models/gpt2.py``:
``GPT2Config``, the training forward, and the two KV-cache protocols).

Parameters are the JAX package's tree: ``encoder/{wte, wpe}``, ``h{i}/{ln1,
qkv, proj, ln2, mlp/{fc1, fc2}}``, ``ln_f``, and ``lm_head`` when untied;
LayerNorm parameters stay f32 whatever ``param_dtype`` is.

The contiguous protocol (``init_kv_cache``, ``forward_with_cache``,
``forward_with_cache_ragged``; what ``Generator`` and the engine's
contiguous layout call) keeps per-layer caches [B, maxT, NH, HS] and
attends through the plain ``ops.decode_attention`` and the masked
``ops.dot_product_attention``, as JAX does: no kernel runs there. The paged
protocol (``init_paged_cache``, ``forward_paged_prefill``,
``forward_paged_ragged``; the engine's default layout) writes K/V through
the page table and reads them back through the paged attention kernel
(``inference/kv_cache.paged_attention_read``); its prefill attends through
``ops.attention.attention`` (flash only from ``FLASH_MIN_SEQ`` keys, which
GPT-2's 1024 positions never reach). JAX's caches are immutable values;
the port's are written in place, and the functions return the same tensors.

``device`` is where caches (and, by default, ``init``'s params) are
allocated: the GPU unless the caller passes ``device="cpu"``. It is
resolved at first use, so a model built only to train (``Model`` passes
its own device) never asks for it.
"""

from __future__ import annotations

import dataclasses

import torch

from mila_tpu_torch import ops
from mila_tpu_torch.device import DeviceLike, resolve_device
from mila_tpu_torch.inference.kv_cache import (
    make_paged_pools,
    paged_attention_read,
    paged_scatter,
)
from mila_tpu_torch.nn import (
    Encoder,
    EncoderConfig,
    LayerNorm,
    LayerNormConfig,
    Linear,
    LinearConfig,
    TransformerBlock,
    TransformerBlockConfig,
)
from mila_tpu_torch.nn.module import CompositeModule, Params
from mila_tpu_torch.ops.attention import attention
from mila_tpu_torch.utils.config import BaseConfig, ConfigError
from mila_tpu_torch.utils.rng import split_named


@dataclasses.dataclass(frozen=True)
class GPT2Config(BaseConfig):
    """Architecture config (llm.c's header fields: maxT, V, Vp, L, NH, C)."""

    vocab_size: int = 50257
    padded_vocab_size: int = 0  # 0 -> round up to a multiple of 128
    max_seq_len: int = 1024
    num_layers: int = 12
    num_heads: int = 12
    embedding_dim: int = 768
    mlp_ratio: int = 4
    dropout: float = 0.0
    tie_embeddings: bool = True
    param_dtype: str = "float32"
    remat: bool = False
    attention_impl: str = "auto"  # auto | xla | flash

    def validate(self):
        if min(self.vocab_size, self.max_seq_len, self.num_layers, self.num_heads,
               self.embedding_dim) <= 0:
            raise ConfigError("all GPT2 dims must be positive")
        if self.embedding_dim % self.num_heads != 0:
            raise ConfigError("embedding_dim must divide num_heads")

    @property
    def vp(self) -> int:
        """The padded vocabulary (llm.c's Vp)."""
        if self.padded_vocab_size:
            return self.padded_vocab_size
        return ((self.vocab_size + 127) // 128) * 128

    @staticmethod
    def gpt2_124m() -> "GPT2Config":
        return GPT2Config(name="gpt2-124M")

    @staticmethod
    def char_lm(vocab_size: int = 256) -> "GPT2Config":
        return GPT2Config(name="char-lm", vocab_size=vocab_size,
                          padded_vocab_size=max(128, ((vocab_size + 127) // 128) * 128),
                          max_seq_len=256, num_layers=4, num_heads=8, embedding_dim=256,
                          mlp_ratio=4)


class GPT2(CompositeModule):
    def __init__(self, config: GPT2Config, device: DeviceLike = None):
        super().__init__(config)
        self._device = device
        cfg = config
        C = cfg.embedding_dim
        self.add("encoder", Encoder(EncoderConfig(
            name="encoder", vocab_size=cfg.vp, embedding_dim=C, max_seq_len=cfg.max_seq_len,
            param_dtype=cfg.param_dtype)))
        for i in range(cfg.num_layers):
            self.add(f"h{i}", TransformerBlock(TransformerBlockConfig(
                name=f"h{i}", embedding_dim=C, num_heads=cfg.num_heads, mlp_ratio=cfg.mlp_ratio,
                dropout=cfg.dropout, param_dtype=cfg.param_dtype, remat=cfg.remat,
                attention_impl=cfg.attention_impl)))
        self.add("ln_f", LayerNorm(LayerNormConfig(name="ln_f", features=C)))
        if not cfg.tie_embeddings:
            self.add("lm_head", Linear(LinearConfig(
                name="lm_head", in_features=C, out_features=cfg.vp, has_bias=False,
                param_dtype=cfg.param_dtype)))

    def init(self, gen, input_shape, device=None) -> Params:
        """Random params on ``device``, by default the model's own."""
        device = resolve_device(self._device if device is None else device)
        gens = split_named(gen, *[n for n, _ in self.children()])
        B, T = input_shape
        params: Params = {"encoder": self.get("encoder").init(gens["encoder"], (B, T), device)}
        shape = (B, T, self.config.embedding_dim)
        for name, child in self.children():
            if name != "encoder":
                params[name] = child.init(gens[name], shape, device=device)
        return params

    def apply(self, params, tokens, *, training=False, rngs=None):
        """tokens [B, T] -> logits [B, T, Vp]."""
        x = self.get("encoder").apply(params["encoder"], tokens)
        for i in range(self.config.num_layers):
            x = self.get(f"h{i}").apply(params[f"h{i}"], x, training=training, rngs=rngs)
        x = self.get("ln_f").apply(params["ln_f"], x)
        return self._logits(params, x)

    def _logits(self, params, x):
        if self.config.tie_embeddings:
            return ops.linear(x, params["encoder"]["wte"].t(), None)  # lm_head = wte^T
        return self.get("lm_head").apply(params["lm_head"], x)

    def output_shape(self, input_shape):
        return (*tuple(input_shape), self.config.vp)

    @property
    def device(self) -> torch.device:
        return resolve_device(self._device)

    def _embed(self, params, tokens, positions):
        """wte[tokens] (+ wpe[positions]) in the table's dtype."""
        x = params["encoder"]["wte"][tokens.long()]
        wpe = params["encoder"].get("wpe")
        if wpe is not None:
            x = x + wpe[positions.long()]
        return x

    def _qkv_step(self, blk, bp, x):
        """ln1 + qkv of one block: q, k, v [B, t, NH, HS]."""
        cfg: GPT2Config = self.config
        B, t, C = x.shape
        NH = cfg.num_heads
        h = blk.get("ln1").apply(bp["ln1"], x)
        q, k, v = blk.get("qkv").apply(bp["qkv"], h).split(C, dim=-1)
        return (q.reshape(B, t, NH, C // NH), k.reshape(B, t, NH, C // NH),
                v.reshape(B, t, NH, C // NH))

    def _finish_block(self, blk, bp, x, att):
        """proj + residual, then ln2 + MLP + residual."""
        B, t = att.shape[:2]
        h = blk.get("proj").apply(bp["proj"], att.reshape(B, t, -1))
        x = ops.residual(h, x)
        h = blk.get("mlp").apply(bp["mlp"], blk.get("ln2").apply(bp["ln2"], x))
        return ops.residual(h, x)

    def _head(self, params, x):
        return self._logits(params, self.get("ln_f").apply(params["ln_f"], x))

    # --- contiguous KV-cache protocol (Generator, the engine's contiguous layout) ---

    def init_kv_cache(self, batch_size: int, max_len: int = 0, dtype=torch.float32) -> dict:
        """Per-layer token-major caches {"h{i}": {"k", "v"}} of [B, maxT, NH,
        HS] zeros (maxT = ``max_len`` or the model's ``max_seq_len``)."""
        cfg: GPT2Config = self.config
        maxT = max_len or cfg.max_seq_len
        shape = (batch_size, maxT, cfg.num_heads, cfg.embedding_dim // cfg.num_heads)
        return {f"h{i}": {"k": torch.zeros(shape, dtype=dtype, device=self.device),
                          "v": torch.zeros(shape, dtype=dtype, device=self.device)}
                for i in range(cfg.num_layers)}

    def _block_step(self, bp, blk, x, cache, pos: int):
        """One block over new tokens x [B, t, C] at absolute position ``pos``
        (tokens already cached): rows pos..pos+t-1 of the cache are written
        in place; one token attends through ``ops.decode_attention``, more
        through the masked product over the whole cache."""
        B, t, _ = x.shape
        q, k, v = self._qkv_step(blk, bp, x)
        kc, vc = cache["k"], cache["v"]
        kc[:, pos:pos + t] = k.to(kc.dtype)
        vc[:, pos:pos + t] = v.to(vc.dtype)
        if t == 1:
            lens = torch.full((B,), pos + 1, dtype=torch.int32, device=x.device)
            att = ops.decode_attention(q, kc, vc, lens)
        else:
            maxT = kc.shape[1]
            kj = torch.arange(maxT, device=x.device)[None, :]
            qi = torch.arange(t, device=x.device)[:, None] + pos
            mask = (kj <= qi)[None].expand(B, t, maxT)
            att = ops.dot_product_attention(q, kc, vc, causal=False, mask=mask)
        return self._finish_block(blk, bp, x, att), {"k": kc, "v": vc}

    def forward_with_cache(self, params, tokens, cache: dict, pos: int):
        """tokens [B, t] at absolute position ``pos`` -> (logits [B, t, Vp],
        cache)."""
        B, t = tokens.shape
        pos = int(pos)
        positions = pos + torch.arange(t, device=tokens.device)[None].expand(B, t)
        x = self._embed(params, tokens, positions)
        new_cache = {}
        for i in range(self.config.num_layers):
            x, new_cache[f"h{i}"] = self._block_step(params[f"h{i}"], self.get(f"h{i}"), x,
                                                     cache[f"h{i}"], pos)
        return self._head(params, x), new_cache

    def forward_with_cache_ragged(self, params, tokens, cache: dict, positions):
        """Single-token decode where each row sits at its own position:
        tokens [B, 1], positions [B] = tokens already cached per row.
        Returns (logits [B, 1, Vp], cache)."""
        B = tokens.shape[0]
        pos = positions.long()
        rows = torch.arange(B, device=tokens.device)
        x = self._embed(params, tokens, pos[:, None])
        lens = (pos + 1).to(torch.int32)
        new_cache = {}
        for i in range(self.config.num_layers):
            blk, bp, lc = self.get(f"h{i}"), params[f"h{i}"], cache[f"h{i}"]
            q, k, v = self._qkv_step(blk, bp, x)
            lc["k"][rows, pos] = k[:, 0].to(lc["k"].dtype)
            lc["v"][rows, pos] = v[:, 0].to(lc["v"].dtype)
            att = ops.decode_attention(q, lc["k"], lc["v"], lens)
            x = self._finish_block(blk, bp, x, att)
            new_cache[f"h{i}"] = {"k": lc["k"], "v": lc["v"]}
        return self._head(params, x), new_cache

    # --- paged KV-cache protocol (the engine's default layout) ---

    def init_paged_cache(self, num_pages: int, page_size: int = 128,
                         dtype=torch.bfloat16) -> dict:
        """Page pools [L, P, NH, HS, ps] (page-major, token-minor pages)."""
        cfg: GPT2Config = self.config
        return make_paged_pools(cfg.num_layers, cfg.num_heads,
                                cfg.embedding_dim // cfg.num_heads, num_pages, page_size,
                                dtype, self.device)

    def forward_paged_prefill(self, params, tokens, pools: dict, page_table, true_len):
        """Batched prompt prefill into pages (fresh sequences at position 0):
        tokens [B, T] right-padded, page_table [B, W], true_len [B]. Pages are
        written for the whole bucket. Returns (logits of each row's last valid
        token [B, Vp], pools); ln_f and the head run on those B rows only."""
        B, T = tokens.shape
        ps = pools["k"].shape[4]
        W = page_table.shape[1]
        pos_ids = torch.arange(T, device=tokens.device)[None].expand(B, T)
        x = self._embed(params, tokens, pos_ids)
        page_ids = torch.gather(page_table.long(), 1, (pos_ids // ps).clamp_max(W - 1))
        offs = pos_ids % ps
        for i in range(self.config.num_layers):
            blk, bp = self.get(f"h{i}"), params[f"h{i}"]
            q, k, v = self._qkv_step(blk, bp, x)
            att = attention(q, k, v, causal=True, impl=self.config.attention_impl)
            pools = paged_scatter(pools, i, page_ids, offs, k, v)
            x = self._finish_block(blk, bp, x, att)
        rows = torch.arange(B, device=x.device)
        last = x[rows, (true_len.long() - 1).clamp_min(0)][:, None]
        return self._head(params, last)[:, 0], pools

    def forward_paged_ragged(self, params, tokens, pools: dict, page_table, positions):
        """Single-token decode with per-row positions: tokens [B, 1],
        positions [B] = tokens already stored per row. Writes K/V through
        the page table and reads them back through the paged attention
        kernel. Returns (logits [B, 1, Vp], pools)."""
        B = tokens.shape[0]
        ps = pools["k"].shape[4]
        W = page_table.shape[1]
        pos = positions.long()
        x = self._embed(params, tokens, pos[:, None])
        rows = torch.arange(B, device=tokens.device)
        page_ids = page_table.long()[rows, (pos // ps).clamp_max(W - 1)]
        offs = pos % ps
        lens = (pos + 1).to(torch.int32)
        for i in range(self.config.num_layers):
            blk, bp = self.get(f"h{i}"), params[f"h{i}"]
            q, k, v = self._qkv_step(blk, bp, x)
            pools = paged_scatter(pools, i, page_ids, offs, k[:, 0], v[:, 0])
            att = paged_attention_read(pools, i, q, page_table, lens)
            x = self._finish_block(blk, bp, x, att)
        return self._head(params, x), pools
