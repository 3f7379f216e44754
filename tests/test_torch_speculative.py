"""The port's ``SpeculativeGenerator`` (mirrors
``tests/inference/test_speculative.py``): greedy equivalence with the
target's own greedy stream, full acceptance when draft == target, sampling
validity, the cache rewind across rejections, EOS and the argument checks.

Target and draft are GPT-2s initialised by the JAX package and bridged to
the port (f32 caches); greedy streams are also held to the JAX package's
``SpeculativeGenerator`` on the same weights. Sampled tokens are checked for
validity, and one round at a fixed prefix, drawn many times, for its
distribution against the JAX target's softmax (the port's random draws
differ from ``jax.random``'s).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mila_tpu.inference import SpeculativeGenerator as JSpec
from mila_tpu.models import gpt2 as jg
from mila_tpu.models import llama as jl
from mila_tpu_torch.bridge import params_from_jax
from mila_tpu_torch.inference import Generator, SamplingConfig, SpeculativeGenerator
from mila_tpu_torch.models import gpt2 as tg
from mila_tpu_torch.models import llama as tl
from tests.test_torch_spec_engine import CHI2_2DOF, bigram_params, chi2_stat

V = 61


def _pair(layers, C, seed):
    kw = dict(vocab_size=V, max_seq_len=128, num_layers=layers, num_heads=2, embedding_dim=C)
    jm = jg.GPT2(jg.GPT2Config(**kw))
    jp = jm.init(jax.random.key(seed), (1, 16))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jm, jp, tg.GPT2(tg.GPT2Config(**kw), device="cpu"), tp


@pytest.fixture(scope="module")
def jax_target():
    return _pair(3, 32, 0)


@pytest.fixture(scope="module")
def jax_draft():
    return _pair(1, 16, 7)


@pytest.fixture(scope="module")
def target_model(jax_target):
    return jax_target[2:]


@pytest.fixture(scope="module")
def draft_model(jax_draft):
    return jax_draft[2:]


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


class TestSpeculativeGreedy:
    @pytest.mark.parametrize("k", [1, 3, 4])
    def test_matches_target_greedy(self, target_model, draft_model, k):
        tm, tp = target_model
        dm, dp = draft_model
        prompt = torch.tensor([[5, 9, 13, 2]], dtype=torch.int32)
        expected = Generator(tm, tp, max_len=128, cache_dtype=torch.float32).generate(prompt, 24)
        spec = SpeculativeGenerator(tm, tp, dm, dp, k=k, max_len=128,
                                    cache_dtype=torch.float32)
        got = spec.generate(prompt, 24)
        assert torch.equal(got, expected)
        assert spec.stats["rounds"] >= 1

    def test_matches_jax(self, jax_target, jax_draft):
        """The same weights and prompt through the JAX package's generator."""
        jm, jp, tm, tp = jax_target
        jdm, jdp, dm, dp = jax_draft
        prompt = np.array([[5, 9, 13, 2]], np.int32)
        want = JSpec(jm, jp, jdm, jdp, k=3, max_len=128, cache_dtype=jnp.float32).generate(
            jnp.asarray(prompt), 16)
        got = SpeculativeGenerator(tm, tp, dm, dp, k=3, max_len=128,
                                   cache_dtype=torch.float32).generate(prompt, 16)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_draft_equals_target_accepts_everything(self, target_model):
        tm, tp = target_model
        spec = SpeculativeGenerator(tm, tp, tm, tp, k=4, max_len=128, cache_dtype=torch.float32)
        spec.generate(torch.tensor([[1, 2, 3]], dtype=torch.int32), 20)
        assert spec.acceptance_rate == 1.0

    def test_rejections_recover(self, target_model, draft_model):
        tm, tp = target_model
        dm, dp = draft_model
        prompt = torch.tensor([[11]], dtype=torch.int32)
        expected = Generator(tm, tp, max_len=128, cache_dtype=torch.float32).generate(prompt, 40)
        spec = SpeculativeGenerator(tm, tp, dm, dp, k=4, max_len=128,
                                    cache_dtype=torch.float32)
        assert torch.equal(spec.generate(prompt, 40), expected)
        assert spec.acceptance_rate < 1.0  # a random draft: some rejection happened


class TestSpeculativeSampling:
    def test_draft_equals_target_never_rejects(self, target_model):
        tm, tp = target_model
        spec = SpeculativeGenerator(tm, tp, tm, tp, k=3, max_len=128, cache_dtype=torch.float32)
        out = spec.generate(torch.tensor([[4, 5]], dtype=torch.int32), 15, generator=_gen(3),
                            sampling=SamplingConfig(greedy=False, temperature=1.0))
        assert spec.acceptance_rate == 1.0
        assert out.shape == (1, 2 + 15)
        assert int(out.max()) < V and int(out.min()) >= 0

    def test_sampled_tokens_in_vocab(self, target_model, draft_model):
        tm, tp = target_model
        dm, dp = draft_model
        spec = SpeculativeGenerator(tm, tp, dm, dp, k=4, max_len=128, cache_dtype=torch.float32)
        out = spec.generate(torch.tensor([[7, 8]], dtype=torch.int32), 20, generator=_gen(5),
                            sampling=SamplingConfig(greedy=False, temperature=0.8))
        toks = out[0].numpy()
        assert ((0 <= toks) & (toks < V)).all()


    def test_round_distribution(self):
        """One round (k 2) at a fixed prefix, drawn 600 times: the first
        emitted token's counts against the JAX target's softmax at the
        prefix, and the second's, where the first was a and its draft was
        accepted, against the softmax after a (``chi2_stat``). Target and
        draft are the tiny Llama made bigram tables (``bigram_params``),
        the target's peak after the prefix at a and after a at b, the
        draft's at the same tokens and sharper: many drafts are rejected.
        A q for p swap, a residual without q or with the wrong row of q,
        or q without the temperature each fail it."""
        j0 = jl.Llama(jl.LlamaConfig.tiny(vocab_size=V)).init(jax.random.key(0), (1, 16))
        jm = jl.Llama(jl.LlamaConfig.tiny(vocab_size=V).replace(tie_embeddings=False))
        jp = bigram_params(j0, 0.45)
        model = tl.Llama(tl.LlamaConfig.tiny(vocab_size=V).replace(tie_embeddings=False),
                         device="cpu")
        tp, dp = (params_from_jax(jax.tree_util.tree_map(np.asarray, p), "cpu")
                  for p in (jp, bigram_params(j0, 0.7)))
        temp, k = 0.3, 2
        prompt, last = np.array([3, 17, 40, 8, 22, 9], np.int32), 5
        a, b = last + 1, last + 2

        def softmax_at(seq):
            lg = np.asarray(jm.apply(jp, jnp.asarray(np.asarray(seq, np.int32)[None])))
            lg = lg[0, -1, :V] / temp
            e = np.exp(lg - lg.max())
            return e / e.sum()

        p0, p1 = softmax_at(np.append(prompt, last)), softmax_at(np.append(prompt, [last, a]))
        assert p0.argmax() == a and p1.argmax() == b
        spec = SpeculativeGenerator(model, tp, model, dp, k=k, max_len=32,
                                    cache_dtype=torch.float32)
        tcache = model.init_kv_cache(1, 32, torch.float32)
        dcache = model.init_kv_cache(1, 32, torch.float32)
        _, tcache = model.forward_with_cache(tp, torch.from_numpy(prompt)[None], tcache, 0)
        _, dcache = model.forward_with_cache(dp, torch.from_numpy(prompt)[None], dcache, 0)
        gen, last_t = _gen(11), torch.tensor([[last]], dtype=torch.int32)
        firsts, seconds = [], []
        for _ in range(600):  # each round rewrites the same cache rows
            n, out = spec._round(last_t, tcache, dcache, len(prompt), False, temp, gen)
            firsts.append(out[0] if n >= 1 else out[k])
            seconds.append(out[1] if n >= 2 else out[k] if n == 1 else -1)
        firsts, seconds = np.array(firsts), np.array(seconds)
        assert chi2_stat(firsts, p0, a, b) <= CHI2_2DOF
        given = seconds[(firsts == a) & (seconds >= 0)]
        assert len(given) >= 150
        assert chi2_stat(given, p1, a, b) <= CHI2_2DOF


class TestSpeculativeEdges:
    def test_eos_stops(self, target_model, draft_model):
        tm, tp = target_model
        dm, dp = draft_model
        prompt = torch.tensor([[5]], dtype=torch.int32)
        ref = Generator(tm, tp, max_len=128, cache_dtype=torch.float32).generate(prompt, 10)[0]
        eos = int(ref[3])
        spec = SpeculativeGenerator(tm, tp, dm, dp, k=4, max_len=128, cache_dtype=torch.float32)
        gen = spec.generate(prompt, 10, eos_token=eos)[0, 1:].tolist()
        assert eos in gen
        first = gen.index(eos)
        assert all(t == eos for t in gen[first:])

    def test_batch_gt1_rejected(self, target_model, draft_model):
        tm, tp = target_model
        dm, dp = draft_model
        spec = SpeculativeGenerator(tm, tp, dm, dp, k=2, max_len=128)
        with pytest.raises(ValueError, match="B=1"):
            spec.generate(torch.zeros((2, 4), dtype=torch.int32), 4)

    def test_overflow_rejected(self, target_model, draft_model):
        tm, tp = target_model
        dm, dp = draft_model
        spec = SpeculativeGenerator(tm, tp, dm, dp, k=2, max_len=32)
        with pytest.raises(ValueError, match="exceeds"):
            spec.generate(torch.zeros((1, 20), dtype=torch.int32), 20)
