"""GPT-2's serving protocols in the port (mirrors ``tests/models/test_gpt2.py``)
and against the JAX model.

The mirrored tests: the forward's shapes and tree, causality, the untied
head, the incremental forward through the cache equal to the full forward,
cache shapes, and ``Generator``'s greedy determinism, greedy equal to the
full forward's argmax rollout, sampling configurations and the overflow
check. Then the four cache protocols (``forward_with_cache``,
``forward_with_cache_ragged``, ``forward_paged_prefill``,
``forward_paged_ragged``) against JAX's on the same bridged weights at 3
layers, C 32, NH 2, V 61: logits and caches within 1e-5 of the reference's
max in f32 and 2e-2 in bf16; and the paged engine's greedy GPT-2 streams
equal to the JAX engine's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mila_tpu.inference.engine import EngineConfig as JEngineConfig
from mila_tpu.inference.engine import InferenceEngine as JEngine
from mila_tpu.models import gpt2 as jg
from mila_tpu_torch.bridge import params_from_jax
from mila_tpu_torch.inference import Generator, SamplingConfig
from mila_tpu_torch.inference.engine import EngineConfig, InferenceEngine
from mila_tpu_torch.models.gpt2 import GPT2, GPT2Config


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


@pytest.fixture(scope="module")
def tiny_gpt2():
    cfg = GPT2Config(name="tiny", vocab_size=97,  # unaligned: Vp padding
                     max_seq_len=32, num_layers=2, num_heads=2, embedding_dim=32)
    model = GPT2(cfg, device="cpu")
    return model, model.init(_gen(0), (2, 16), device="cpu"), cfg


class TestGPT2Forward:
    def test_vp_padding(self, tiny_gpt2):
        assert tiny_gpt2[2].vp == 128

    def test_logits_shape(self, tiny_gpt2):
        model, params, cfg = tiny_gpt2
        assert model.apply(params, torch.zeros((2, 16), dtype=torch.int32)).shape == \
            (2, 16, cfg.vp)

    def test_param_structure(self, tiny_gpt2):
        _, params, _ = tiny_gpt2
        assert set(params) == {"encoder", "h0", "h1", "ln_f"}
        assert params["encoder"]["wte"].shape == (128, 32)
        assert params["encoder"]["wpe"].shape == (32, 32)
        assert "lm_head" not in params

    def test_causality(self, tiny_gpt2):
        model, params, _ = tiny_gpt2
        toks = torch.from_numpy(np.random.default_rng(1).integers(0, 97, (1, 10)))
        l1 = model.apply(params, toks)
        toks2 = toks.clone()
        toks2[0, 7:] = 3
        torch.testing.assert_close(l1[0, :7], model.apply(params, toks2)[0, :7],
                                   rtol=1e-4, atol=1e-5)

    def test_untied_head(self):
        cfg = GPT2Config(vocab_size=64, max_seq_len=8, num_layers=1, num_heads=2,
                         embedding_dim=16, tie_embeddings=False)
        model = GPT2(cfg, device="cpu")
        params = model.init(_gen(2), (1, 8), device="cpu")
        assert "lm_head" in params
        assert model.apply(params, torch.zeros((1, 8), dtype=torch.int32)).shape == \
            (1, 8, cfg.vp)


class TestKVCache:
    def test_incremental_matches_full_forward(self, tiny_gpt2):
        model, params, _ = tiny_gpt2
        toks = torch.from_numpy(np.random.default_rng(2).integers(0, 97, (2, 12)))
        full = model.apply(params, toks)
        cache = model.init_kv_cache(2, 32)
        logits, cache = model.forward_with_cache(params, toks[:, :8], cache, 0)
        torch.testing.assert_close(logits, full[:, :8], rtol=2e-3, atol=2e-4)
        for t in range(8, 12):
            step, cache = model.forward_with_cache(params, toks[:, t:t + 1], cache, t)
            torch.testing.assert_close(step[:, 0], full[:, t], rtol=2e-3, atol=2e-4)

    def test_cache_shapes(self, tiny_gpt2):
        model = tiny_gpt2[0]
        cache = model.init_kv_cache(3, 16)
        assert set(cache) == {"h0", "h1"}
        assert cache["h0"]["k"].shape == (3, 16, 2, 16)
        assert cache["h0"]["k"].dtype == torch.float32


class TestGenerator:
    def test_greedy_deterministic(self, tiny_gpt2):
        model, params, _ = tiny_gpt2
        gen = Generator(model, params, max_len=32)
        prompt = torch.tensor([[5, 10, 15]], dtype=torch.int32)
        out1, out2 = gen.generate(prompt, 8), gen.generate(prompt, 8)
        assert out1.shape == (1, 11)
        assert torch.equal(out1, out2) and torch.equal(out1[:, :3], prompt)
        assert int(out1.max()) < 97  # never the Vp padding

    def test_greedy_matches_full_forward_argmax(self, tiny_gpt2):
        model, params, _ = tiny_gpt2
        prompt = torch.tensor([[1, 2, 3, 4]], dtype=torch.int32)
        out = Generator(model, params, max_len=32).generate(prompt, 6)
        toks = prompt
        for _ in range(6):
            nxt = torch.argmax(model.apply(params, toks)[:, -1, :97], -1).to(torch.int32)
            toks = torch.cat([toks, nxt[:, None]], dim=1)
        assert torch.equal(out, toks)

    def test_sampling_configs(self, tiny_gpt2):
        model, params, _ = tiny_gpt2
        gen = Generator(model, params, max_len=32)
        prompt = torch.tensor([[7]], dtype=torch.int32)
        for cfg_s in (SamplingConfig(temperature=0.8), SamplingConfig(top_k=5),
                      SamplingConfig(top_p=0.9)):
            out = gen.generate(prompt, 5, generator=_gen(0), sampling=cfg_s)
            assert out.shape == (1, 6) and int(out.max()) < 97

    def test_overflow_raises(self, tiny_gpt2):
        model, params, _ = tiny_gpt2
        with pytest.raises(ValueError, match="exceeds"):
            Generator(model, params, max_len=16).generate(torch.zeros((1, 10),
                                                                      dtype=torch.int32), 10)


def test_char_preset():
    cfg = GPT2Config.char_lm(vocab_size=70)
    cfg.validate()
    assert cfg.embedding_dim == 256 and cfg.num_layers == 4


# ---------------------------------------------------------------------------
# The four protocols against JAX (3 layers, C 32, NH 2, V 61)
# ---------------------------------------------------------------------------

V = 61
_DT = {"float32": (jnp.float32, torch.float32, 1e-5), "bfloat16": (jnp.bfloat16,
                                                                  torch.bfloat16, 2e-2)}


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def pair(request):
    kw = dict(vocab_size=V, max_seq_len=64, num_layers=3, num_heads=2, embedding_dim=32,
              param_dtype=request.param)
    jm = jg.GPT2(jg.GPT2Config(**kw))
    jp = jm.init(jax.random.key(4), (1, 16))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jm, jp, GPT2(GPT2Config(**kw), device="cpu"), tp, request.param


def _np(x):
    return np.asarray(x.astype(jnp.float32)) if isinstance(x, jax.Array) else x.float().numpy()


def _near(got, want, tol):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def _near_tree(got: dict, want: dict, tol):
    for name in want:
        for key in want[name]:
            _near(got[name][key], want[name][key], tol)


def test_forward_with_cache_matches_jax(pair):
    jm, jp, tm, tp, dt = pair
    jdt, tdt, tol = _DT[dt]
    toks = np.random.default_rng(5).integers(0, V, (2, 11)).astype(np.int32)
    jc = jm.init_kv_cache(2, 64, jdt)
    tc = tm.init_kv_cache(2, 64, tdt)
    step = jax.jit(jm.forward_with_cache)
    jl, jc = step(jp, jnp.asarray(toks[:, :8]), jc, jnp.int32(0))
    tl, tc = tm.forward_with_cache(tp, torch.from_numpy(toks[:, :8]), tc, 0)
    _near(tl, jl, tol)
    for t in range(8, 11):
        jl, jc = step(jp, jnp.asarray(toks[:, t:t + 1]), jc, jnp.int32(t))
        tl, tc = tm.forward_with_cache(tp, torch.from_numpy(toks[:, t:t + 1]), tc, t)
        _near(tl, jl, tol)
    _near_tree(tc, jc, tol)


def test_forward_with_cache_ragged_matches_jax(pair):
    jm, jp, tm, tp, dt = pair
    jdt, tdt, tol = _DT[dt]
    rng = np.random.default_rng(6)
    hist = rng.standard_normal((2, 3, 64, 2, 16)).astype(np.float32) * 0.5
    jc = {f"h{i}": {"k": jnp.asarray(hist[0], jdt), "v": jnp.asarray(hist[1], jdt)}
          for i in range(3)}
    tc = {f"h{i}": {"k": torch.from_numpy(hist[0]).to(tdt).clone(),  # written in place
                    "v": torch.from_numpy(hist[1]).to(tdt).clone()} for i in range(3)}
    positions = np.array([0, 17, 63], np.int32)
    toks = rng.integers(0, V, (3, 1)).astype(np.int32)
    jl, jc = jax.jit(jm.forward_with_cache_ragged)(jp, jnp.asarray(toks), jc,
                                                   jnp.asarray(positions))
    tl, tc = tm.forward_with_cache_ragged(tp, torch.from_numpy(toks), tc,
                                          torch.from_numpy(positions))
    _near(tl, jl, tol)
    _near_tree(tc, jc, tol)


def _tables(B, W, P, seed):
    rng = np.random.default_rng(seed)
    return (1 + rng.permutation(P - 1)[: B * W]).reshape(B, W).astype(np.int32)


def test_paged_protocol_matches_jax(pair):
    """forward_paged_prefill over a right-padded bucket, then
    forward_paged_ragged steps at each row's own position."""
    jm, jp, tm, tp, dt = pair
    jdt, tdt, tol = _DT[dt]
    B, T, ps, W, P = 3, 16, 8, 4, 13
    table = _tables(B, W, P, 7)
    true_len = np.array([16, 5, 9], np.int32)
    toks = np.random.default_rng(8).integers(0, V, (B, T)).astype(np.int32)
    jpools = jm.init_paged_cache(P, ps, jdt)
    tpools = tm.init_paged_cache(P, ps, tdt)
    jl, jpools = jax.jit(jm.forward_paged_prefill)(jp, jnp.asarray(toks), jpools,
                                                   jnp.asarray(table), jnp.asarray(true_len))
    ragged = jax.jit(jm.forward_paged_ragged)
    tl, tpools = tm.forward_paged_prefill(tp, torch.from_numpy(toks), tpools,
                                          torch.from_numpy(table), torch.from_numpy(true_len))
    _near(tl, jl, tol)
    pos = true_len.copy()
    nxt = np.argmax(_np(jl)[:, :V], -1).astype(np.int32)[:, None]
    for _ in range(3):
        jl, jpools = ragged(jp, jnp.asarray(nxt), jpools, jnp.asarray(table), jnp.asarray(pos))
        tl, tpools = tm.forward_paged_ragged(tp, torch.from_numpy(nxt), tpools,
                                             torch.from_numpy(table), torch.from_numpy(pos))
        _near(tl, jl, tol)
        nxt = np.argmax(_np(jl)[:, 0, :V], -1).astype(np.int32)[:, None]
        pos = pos + 1
    for key in ("k", "v"):
        _near(tpools[key], jpools[key], tol)


def test_paged_engine_streams_equal_jax():
    """The paged engines serve one GPT-2 (f32 params, f32 pages) to equal
    greedy streams: prompts of 3-20 tokens on three slots, two buckets,
    admission waves and page crossings."""
    kw = dict(vocab_size=V, max_seq_len=64, num_layers=3, num_heads=2, embedding_dim=32)
    jm = jg.GPT2(jg.GPT2Config(**kw))
    jp = jm.init(jax.random.key(9), (1, 16))
    tm = GPT2(GPT2Config(**kw), device="cpu")
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    base = dict(max_batch=3, max_len=64, prefill_buckets=(8, 32), cache_dtype="float32",
                page_size=8, decode_chunk=4)
    jeng = JEngine(jm, jp, JEngineConfig(kv_layout="paged", **base))
    teng = InferenceEngine(tm, tp, EngineConfig(**base), device="cpu")
    rng = np.random.default_rng(10)
    prompts = [rng.integers(0, V, n).astype(np.int32) for n in (3, 20, 7, 12, 5)]
    news = (6, 9, 4, 8, 7)
    jr = [jeng.submit(p, max_new_tokens=n) for p, n in zip(prompts, news)]
    tr = [teng.submit(p, max_new_tokens=n) for p, n in zip(prompts, news)]
    jeng.run()
    teng.run()
    assert teng.kv_layout == "paged"
    for j, t, n in zip(jr, tr, news):
        assert len(t.output) == n and t.output == j.output
    assert teng.alloc.free_pages == teng.alloc.num_pages - 1
