"""Speculative decoding in the port's paged engine (mirrors
``tests/inference/test_spec_engine.py``), its verify forward
(``Llama.forward_paged_chunk``) against the JAX model, and ``PagedKVCache``
against the JAX package's.

Greedy speculative streams must equal the port's target-only streams token
for token, across acceptance rates, batching, EOS and page pressure, and
the JAX engine's speculative streams on the same weights and prompts.
Sampled rows are checked for validity and token counts, and one round at a
fixed prefix, drawn many times, for its distribution: the emitted tokens'
counts against the JAX target's softmax (the port's random draws differ
from ``jax.random``'s). Tiny Llama (vocab 61) with f32 params
from ``jax.random.key(0)`` bridged to the port, draft caches bf16 as the
engine makes them. ``forward_paged_chunk`` logits and pools are held to JAX
in bf16 (2e-2 of the logits' max) and int8 weights (the same), f32 (1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mila_tpu.inference import kv_cache as jkv
from mila_tpu.inference.engine import EngineConfig as JEngineConfig
from mila_tpu.inference.engine import InferenceEngine as JInferenceEngine
from mila_tpu.inference.quantize import quantize_model_params as j_qmp
from mila_tpu.models import llama as jl
from mila_tpu_torch.bridge import params_from_jax
from mila_tpu_torch.inference import PagedCacheConfig, PagedKVCache, SamplingConfig
from mila_tpu_torch.inference.engine import EngineConfig, InferenceEngine
from mila_tpu_torch.models import llama as tl

V = 61


def _bridge(jparams):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), "cpu")


def _port_model():
    return tl.Llama(tl.LlamaConfig.tiny(vocab_size=V), device="cpu")


@pytest.fixture(scope="module")
def jax_target():
    jmodel = jl.Llama(jl.LlamaConfig.tiny(vocab_size=V))
    return jmodel, jmodel.init(jax.random.key(0), (1, 16))


@pytest.fixture(scope="module")
def target(jax_target):
    return _port_model(), _bridge(jax_target[1])


@pytest.fixture(scope="module")
def draft_same(target):
    """Draft == target: every proposal accepted."""
    return target


@pytest.fixture(scope="module")
def jax_draft_other():
    jmodel = jl.Llama(jl.LlamaConfig.tiny(vocab_size=V))
    return jmodel, jmodel.init(jax.random.key(99), (1, 16))


@pytest.fixture(scope="module")
def draft_other(jax_draft_other):
    """A differently initialised draft: frequent rejections."""
    return _port_model(), _bridge(jax_draft_other[1])


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(0, V, n).astype(np.int32)


def _engine(model, params, draft=None, k=0, **ekw):
    cfg = dict(max_batch=4, max_len=64, prefill_buckets=(8, 16, 32), decode_chunk=4,
               page_size=8)
    cfg.update(ekw)
    if draft is not None:
        cfg.update(speculative_k=k, draft_model=draft[0], draft_params=draft[1])
    return InferenceEngine(model, params, EngineConfig(**cfg), device="cpu")


def _run(model, params, prompts, max_new, draft=None, k=0, **ekw):
    eng = _engine(model, params, draft, k, **ekw)
    reqs = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    eng.run()
    return [r.output for r in reqs], eng


def bigram_params(jparams, gain: float) -> dict:
    """The tiny Llama's JAX params made a bigram table: attention and MLP
    outputs zeroed (each position's residual is its token's embedding) and
    an untied head whose column j is the embedding of token j - 1 times
    ``gain``, so the next token's logits peak at the current token + 1."""
    p = {key: (dict(val) if isinstance(val, dict) else val) for key, val in jparams.items()}
    for block in (key for key in p if key.startswith("h")):
        for w in ("wo", "down"):
            p[block][w] = {"weight": jnp.zeros_like(jparams[block][w]["weight"])}
    p["lm_head"] = {"weight": gain * jnp.roll(jparams["embed"]["wte"], 1, axis=0).T}
    return p


CHI2_2DOF = 18.42  # P(chi-square with 2 degrees of freedom > 18.42) = 1e-4


def chi2_stat(samples: np.ndarray, p: np.ndarray, a: int, b: int) -> float:
    """Pearson's chi-square of the samples' counts against ``p`` over three
    bins: token a, token b and every other token."""
    n = len(samples)
    obs = np.array([(samples == a).sum(), (samples == b).sum(), 0.0])
    exp = n * np.array([p[a], p[b], 0.0])
    obs[2], exp[2] = n - obs[:2].sum(), n - exp[:2].sum()
    return float(((obs - exp) ** 2 / exp).sum())


class TestSpecEngine:
    def test_self_draft_matches_plain(self, target, draft_same):
        model, params = target
        prompts = [_prompt(i, 5 + i) for i in range(3)]
        plain, _ = _run(model, params, prompts, 12)
        spec, eng = _run(model, params, prompts, 12, draft=draft_same, k=3)
        assert spec == plain
        # The draft reads a bf16 cache and the verify f32 pages: near-ties may split.
        assert eng.stats["spec_accepted"] >= 0.8 * eng.stats["spec_proposed"]

    def test_other_draft_matches_plain(self, target, draft_other):
        model, params = target
        prompts = [_prompt(10 + i, 6) for i in range(3)]
        plain, _ = _run(model, params, prompts, 14)
        spec, eng = _run(model, params, prompts, 14, draft=draft_other, k=3)
        assert spec == plain
        assert eng.stats["spec_rounds"] > 0

    @pytest.mark.parametrize("k", [1, 2, 4])
    def test_k_sweep(self, target, draft_other, k):
        model, params = target
        prompts = [_prompt(20, 7)]
        plain, _ = _run(model, params, prompts, 10)
        spec, _ = _run(model, params, prompts, 10, draft=draft_other, k=k)
        assert spec == plain

    def test_eos_mid_round(self, target, draft_same):
        model, params = target
        for seed in range(30, 40):  # the first prompt whose stream is not one token repeated
            p = _prompt(seed, 5)
            plain = _engine(model, params, max_batch=2, prefill_buckets=(8, 16))
            r0 = plain.submit(p, max_new_tokens=20)
            plain.run()
            if len(set(r0.output)) >= 2:
                break
        assert len(set(r0.output)) >= 2
        eos = r0.output[len(r0.output) // 2]
        cut = r0.output[: r0.output.index(eos) + 1]
        spec = _engine(model, params, draft_same, 3, max_batch=2, prefill_buckets=(8, 16))
        r1 = spec.submit(p, max_new_tokens=20, eos_token=eos)
        spec.run()
        assert r1.output == cut

    def test_sampled_requests_speculate(self, target, draft_same):
        model, params = target
        eng = _engine(model, params, draft_same, 3, max_batch=2, prefill_buckets=(8, 16))
        r = eng.submit(_prompt(40, 5), max_new_tokens=8,
                       sampling=SamplingConfig(greedy=False, temperature=1.0))
        g = eng.submit(_prompt(41, 5), max_new_tokens=8)
        eng.run()
        assert len(r.output) == 8 and len(g.output) == 8
        assert all(0 <= t < V for t in r.output + g.output)
        # Self-draft: p == q up to the cache dtypes, so rows accept nearly all.
        assert eng.stats["spec_accepted"] >= 0.5 * eng.stats["spec_proposed"]
        assert eng.stats["spec_rounds"] <= 6

    def test_sampled_mixed_temperatures(self, target, draft_other):
        model, params = target
        plain, _ = _run(model, params, [_prompt(42, 6)], 10)
        eng = _engine(model, params, draft_other, 2, prefill_buckets=(8, 16))
        g = eng.submit(_prompt(42, 6), max_new_tokens=10)
        hot = eng.submit(_prompt(43, 6), max_new_tokens=10,
                         sampling=SamplingConfig(greedy=False, temperature=1.5))
        cold = eng.submit(_prompt(44, 6), max_new_tokens=10,
                          sampling=SamplingConfig(greedy=False, temperature=0.2))
        eng.run()
        assert g.output == plain[0]
        assert len(hot.output) == 10 and len(cold.output) == 10
        assert all(0 <= t < V for t in hot.output + cold.output)

    def test_spec_under_page_pressure(self, target, draft_other):
        model, params = target
        prompts = [_prompt(50 + i, 5) for i in range(4)]
        plain, _ = _run(model, params, prompts, 10)
        spec, eng = _run(model, params, prompts, 10, draft=draft_other, k=3, num_pages=10)
        assert spec == plain
        assert eng.alloc.free_pages == 9

    def test_slot_reuse_after_spec(self, target, draft_same):
        model, params = target
        p = _prompt(60, 6)
        plain, _ = _run(model, params, [p], 8, max_batch=1)
        spec, _ = _run(model, params, [p, _prompt(61, 9), p], 8, draft=draft_same, k=3,
                       max_batch=1)
        assert spec[0] == plain[0]
        assert spec[2] == plain[0]

    def test_greedy_streams_match_jax_engine(self, jax_target, jax_draft_other, target,
                                             draft_other):
        """The JAX engine's speculative path on the same weights and prompts:
        the greedy streams equal the port's token for token (acceptance
        counts may differ: the port's draft also writes d_k's K/V)."""
        k = 3
        prompts = [_prompt(70 + i, 4 + 3 * i) for i in range(3)]
        cfg = dict(max_batch=4, max_len=64, prefill_buckets=(8, 16, 32), decode_chunk=4,
                   page_size=8, speculative_k=k)
        jeng = JInferenceEngine(*jax_target, JEngineConfig(
            **cfg, draft_model=jax_draft_other[0], draft_params=jax_draft_other[1]))
        jreqs = [jeng.submit(p, max_new_tokens=12) for p in prompts]
        jeng.run()
        got, eng = _run(*target, prompts, 12, draft=draft_other, k=k)
        assert jeng.stats["spec_rounds"] > 0 and eng.stats["spec_rounds"] > 0
        assert got == [r.output for r in jreqs]

    def test_sampled_round_distribution(self, jax_target):
        """One round (k 2) at a fixed prefix, drawn 1280 times over 32 rows:
        the first emitted token's counts against the JAX target's softmax at
        the prefix, and the second's, where the first was a and its draft
        was accepted, against the softmax after a (``chi2_stat``). Target
        and draft are bigram tables (``bigram_params``): the target's peak
        after the prefix is a, after a it is b, each with about half its
        mass; the draft's are at the same tokens, sharper, so that many
        drafts are rejected and the replacement draw from norm(relu(p - q))
        makes much of the emitted mass. A q for p swap, a residual without
        q, or the wrong row of q (q after a at the first position, q before
        a at the second) each fail it."""
        jcfg = jl.LlamaConfig.tiny(vocab_size=V).replace(tie_embeddings=False)
        jm = jl.Llama(jcfg)
        jp = bigram_params(jax_target[1], 0.45)
        tcfg = tl.LlamaConfig.tiny(vocab_size=V).replace(tie_embeddings=False)
        model = tl.Llama(tcfg, device="cpu")
        params, dparams = _bridge(jp), _bridge(bigram_params(jax_target[1], 0.7))
        temp, k, B, rounds = 0.3, 2, 32, 40
        prompt, last = _prompt(80, 6), 5
        a, b = last + 1, last + 2

        def softmax_at(seq):
            lg = np.asarray(jm.apply(jp, jnp.asarray(np.asarray(seq, np.int32)[None])))
            lg = lg[0, -1, :V] / temp
            e = np.exp(lg - lg.max())
            return e / e.sum()

        p0, p1 = softmax_at(np.append(prompt, last)), softmax_at(np.append(prompt, [last, a]))
        assert p0.argmax() == a and p1.argmax() == b
        eng = _engine(model, params, (model, dparams), k, max_batch=B, prefill_buckets=(8,))
        for _ in range(B):
            eng.submit(prompt, max_new_tokens=16,
                       sampling=SamplingConfig(greedy=False, temperature=temp))
        eng._admit([])  # the prefill: every row at the same prefix
        T0 = len(prompt)
        for i in range(B):
            eng.alloc.ensure(i, T0 + k + 1)
        eng._last_token[:] = last  # the round verifies `last` at T0: the prefix is fixed
        ops = [torch.from_numpy(x.copy()) for x in (
            eng.alloc.table, eng._last_token, eng._positions, np.zeros(B, bool),
            np.full(B, temp, np.float32))]
        firsts, seconds = [], []
        for _ in range(rounds):
            n, d, t_new = eng._spec_verify(*ops, False)
            firsts.append(torch.where(n >= 1, d[:, 0], t_new))
            seconds.append(torch.where(n >= 2, d[:, 1], t_new).masked_fill(n < 1, -1))
        firsts, seconds = torch.cat(firsts).numpy(), torch.cat(seconds).numpy()
        assert chi2_stat(firsts, p0, a, b) <= CHI2_2DOF
        given = seconds[(firsts == a) & (seconds >= 0)]
        assert len(given) >= 400
        assert chi2_stat(given, p1, a, b) <= CHI2_2DOF

    def test_config_validation(self, target):
        model, params = target
        with pytest.raises(ValueError, match="draft"):
            InferenceEngine(model, params, EngineConfig(max_batch=2, max_len=64,
                                                        speculative_k=2), device="cpu")
        with pytest.raises(ValueError, match="paged"):
            InferenceEngine(model, params, EngineConfig(
                max_batch=2, max_len=64, speculative_k=2, kv_layout="contiguous",
                draft_model=model, draft_params=params), device="cpu")


def _chunk_pair(wdt):
    cfg = jl.LlamaConfig.tiny(vocab_size=V)
    if wdt == "bfloat16":
        cfg = cfg.replace(param_dtype="bfloat16")
    jparams = jl.Llama(cfg).init(jax.random.key(5), (1, 16))
    if wdt == "int8":
        jparams = jl.add_quantized_lm_head(j_qmp(jl.fuse_llama_projections(jparams), "int8"),
                                           "int8")
    tcfg = tl.LlamaConfig.tiny(vocab_size=V).replace(param_dtype=cfg.param_dtype)
    return jl.Llama(cfg), jparams, tl.Llama(tcfg, device="cpu"), _bridge(jparams)


@pytest.mark.parametrize("wdt,t,tol", [("float32", 4, 1e-5), ("bfloat16", 5, 2e-2),
                                       ("int8", 4, 2e-2), ("int8", 9, 2e-2)])
def test_forward_paged_chunk_matches_jax(wdt, t, tol):
    """The verify over prompts already in the pages: logits [B, t, V] and the
    written pools against JAX's. int8 at t 4 (B 3: 12 rows) takes the fused
    decode entries, at t 9 (B 4: 36 rows) ``quant_linear``."""
    jm, jp, tm, tp = _chunk_pair(wdt)
    B = 4 if t == 9 else 3
    ps, W, P = 8, 4, 17
    rng = np.random.default_rng(7)
    table = (1 + rng.permutation(P - 1)[: B * W]).reshape(B, W).astype(np.int32)
    positions = np.array([3, 9, 14, 0][:B], np.int32)
    toks = rng.integers(0, V, (B, t)).astype(np.int32)
    cdt = "float32" if wdt == "float32" else "bfloat16"
    # Earlier rows of each sequence already in the pages.
    hist = rng.standard_normal((2, B, 16, 2, 32)).astype(np.float32)
    jpools = jm.init_paged_cache(P, ps, jnp.dtype(cdt))
    tpools = tm.init_paged_cache(P, ps, getattr(torch, cdt))
    pos16 = np.arange(16)[None].repeat(B, 0)
    pids = np.take_along_axis(table, pos16 // ps, 1)
    for layer in range(2):
        jpools = jkv.paged_scatter(jpools, layer, jnp.asarray(pids), jnp.asarray(pos16 % ps),
                                   jnp.asarray(hist[0]), jnp.asarray(hist[1]))
    tpools = {k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(tpools[k].dtype)
              for k, v in jpools.items()}
    jl_, jpools = jax.jit(jm.forward_paged_chunk)(jp, jnp.asarray(toks), jpools,
                                                  jnp.asarray(table), jnp.asarray(positions))
    tl_, tpools = tm.forward_paged_chunk(tp, torch.from_numpy(toks), tpools,
                                         torch.from_numpy(table), torch.from_numpy(positions))
    want = np.asarray(jl_.astype(jnp.float32))
    got = tl_.float().numpy()
    assert got.shape == (B, t, V)
    assert np.abs(got - want).max() <= tol * np.abs(want).max()
    for key in ("k", "v"):
        wp = np.asarray(jpools[key].astype(jnp.float32))
        gp = tpools[key].float().numpy()
        assert np.abs(gp - wp).max() <= tol * np.abs(wp).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_kv_cache_matches_jax(dtype):
    """Slots, page growth across non-adjacent pages, the gather read and
    freeing, against JAX's ``PagedKVCache`` step by step."""
    cfg = dict(num_layers=2, num_kv_heads=2, head_dim=8, page_size=4, num_pages=12,
               max_seqs=3, dtype=dtype)
    jc = jkv.PagedKVCache(jkv.PagedCacheConfig(**cfg), max_len=16)
    tc = PagedKVCache(PagedCacheConfig(**cfg), max_len=16, device="cpu")
    assert tc.config.hbm_bytes() == jc.config.hbm_bytes()
    rng = np.random.default_rng(3)
    slots = [(jc.allocate_slot(), tc.allocate_slot()) for _ in range(2)]
    assert [a for a, _ in slots] == [b for _, b in slots]
    for (s, _), (start, T) in zip(slots * 2, [(0, 6), (0, 3), (6, 5), (3, 7)]):
        kv = [(rng.standard_normal((T, 2, 8)).astype(np.float32),
               rng.standard_normal((T, 2, 8)).astype(np.float32)) for _ in range(2)]
        jc.write_tokens(s, [(jnp.asarray(k), jnp.asarray(v)) for k, v in kv], start)
        tc.write_tokens(s, [(torch.from_numpy(k), torch.from_numpy(v)) for k, v in kv], start)
    np.testing.assert_array_equal(tc.page_table, jc.page_table)
    np.testing.assert_array_equal(tc.seq_lens, jc.seq_lens)
    for layer in range(2):
        jk, jv = jc.gather_kv(layer, np.array([0, 1]))
        tk, tv = tc.gather_kv(layer, np.array([0, 1]))
        np.testing.assert_array_equal(tk.float().numpy(), np.asarray(jk.astype(jnp.float32)))
        np.testing.assert_array_equal(tv.float().numpy(), np.asarray(jv.astype(jnp.float32)))
    jc.free_slot(0)
    tc.free_slot(0)
    assert tc.free_pages == jc.free_pages
    with pytest.raises(RuntimeError, match="exceeds"):
        tc.ensure_capacity(1, 17)
