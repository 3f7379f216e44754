"""The port's llm.c and safetensors I/O (mirrors
``tests/serialization/test_llmc_safetensors.py`` and
``tests/models/test_llama.py::test_safetensors_to_llama_params``), and files
passed between the two packages: each reads what the other writes, and the
two writers lay out the same bytes for the same tensors, BF16 and F8
included.
"""

import struct

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from mila_tpu.models import gpt2 as jg
from mila_tpu.serialization import llmc as jllmc
from mila_tpu.serialization import safetensors_io as jst
from mila_tpu_torch.bridge import params_from_jax, tensor_from_numpy
from mila_tpu_torch.inference.quantize import quantize_model_params
from mila_tpu_torch.models import llama as tl
from mila_tpu_torch.models.gpt2 import GPT2, GPT2Config
from mila_tpu_torch.serialization import (
    GPT2Tokenizer,
    SafetensorsFile,
    hf_gpt2_to_params,
    hf_llama_to_params,
    load_safetensors,
    read_gpt2_checkpoint,
    save_safetensors,
    write_gpt2_checkpoint,
)


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


_CFG = dict(vocab_size=50, padded_vocab_size=64, max_seq_len=16, num_layers=2, num_heads=2,
            embedding_dim=16)


class TestLlmcCheckpoint:
    def test_round_trip_forward_equivalence(self, tmp_path):
        cfg = GPT2Config(**_CFG)
        model = GPT2(cfg, device="cpu")
        params = model.init(_gen(0), (1, 8), device="cpu")
        path = tmp_path / "gpt2.bin"
        write_gpt2_checkpoint(path, cfg, params)
        cfg2, params2 = read_gpt2_checkpoint(path, device="cpu")
        assert cfg2.num_layers == 2 and cfg2.vp == 64 and cfg2.vocab_size == 50
        assert dict(_leaves(params2)).keys() == dict(_leaves(params)).keys()
        for name, leaf in _leaves(params):
            assert torch.equal(dict(_leaves(params2))[name], leaf), name
        toks = torch.tensor([[1, 2, 3, 4]], dtype=torch.int32)
        torch.testing.assert_close(GPT2(cfg2, device="cpu").apply(params2, toks),
                                   model.apply(params, toks), rtol=1e-5, atol=1e-6)

    def test_leaves_are_contiguous(self, tmp_path):
        """The reader transposes llm.c's [out, in] weights; its tensors must
        still be row-major, as the kernels that take them (and their
        quantized forms) require."""
        cfg = GPT2Config(**_CFG)
        path = tmp_path / "gpt2.bin"
        write_gpt2_checkpoint(path, cfg, GPT2(cfg, device="cpu").init(_gen(0), (1, 8),
                                                                       device="cpu"))
        _, params = read_gpt2_checkpoint(path, device="cpu")
        for name, leaf in _leaves(params):
            assert leaf.is_contiguous(), name
        qt = quantize_model_params(params, "int8", min_size=256, device="cpu")
        assert qt["h0"]["qkv"]["weight"].q.is_contiguous()

    def test_bad_magic(self, tmp_path):
        p = tmp_path / "bad.bin"
        p.write_bytes(np.zeros(256, "<i4").tobytes())
        with pytest.raises(ValueError, match="magic"):
            read_gpt2_checkpoint(p, device="cpu")

    def test_tokenizer_reader(self, tmp_path):
        header = np.zeros(256, "<i4")
        header[:4] = [20240328, 2, 3, 2]  # magic, version, vocab, eot
        body = b"".join(struct.pack("<B", len(t)) + t for t in (b"he", b"llo", b"!"))
        p = tmp_path / "tok.bin"
        p.write_bytes(header.tobytes() + body)
        tk = GPT2Tokenizer(p)
        assert tk.vocab_size == 3 and tk.eot_token == 2
        assert tk.decode([0, 1, 2]) == "hello!"

    @pytest.mark.parametrize("writer", ["jax", "port"])
    def test_checkpoints_cross_packages(self, tmp_path, writer):
        """A checkpoint either package writes, the other reads to the same
        tree (the port's tensors equal JAX's arrays), byte for byte."""
        jcfg = jg.GPT2Config(**_CFG)
        jp = jg.GPT2(jcfg).init(jax.random.key(1), (1, 8))
        tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
        a, b = tmp_path / "a.bin", tmp_path / "b.bin"
        jllmc.write_gpt2_checkpoint(a, jcfg, jax.tree_util.tree_map(np.asarray, jp))
        write_gpt2_checkpoint(b, GPT2Config(**_CFG), tp)
        assert a.read_bytes() == b.read_bytes()
        path = a if writer == "jax" else b
        _, got = read_gpt2_checkpoint(path, device="cpu")
        _, want = jllmc.read_gpt2_checkpoint(path)
        for name, leaf in _leaves(want):
            np.testing.assert_array_equal(dict(_leaves(got))[name].numpy(), leaf)
        # The JAX reader's tree through the bridge is the port reader's tree.
        bridged = dict(_leaves(params_from_jax(want, "cpu")))
        assert bridged.keys() == dict(_leaves(got)).keys()
        for name, leaf in _leaves(got):
            assert torch.equal(bridged[name], leaf), name


def _mixed_tensors():
    rng = np.random.default_rng(0)
    return {
        "a": rng.normal(size=(3, 4)).astype(np.float32),
        "b": np.arange(8, dtype=np.int8),
        "c": rng.normal(size=(2, 5)).astype(ml_dtypes.bfloat16),
        "d": rng.normal(size=(4, 3)).astype(ml_dtypes.float8_e4m3fn),
        "e": rng.normal(size=(6,)).astype(ml_dtypes.float8_e5m2),
        "f": rng.normal(size=(2, 2)).astype(np.float16),
        "g": np.array([True, False, True]),
    }


def _bits(x) -> np.ndarray:
    """The raw bytes of a numpy array or a CPU tensor."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().reshape(-1).view(torch.uint8).numpy()
    return np.ascontiguousarray(x).reshape(-1).view(np.uint8)


class TestSafetensors:
    def test_round_trip_dtypes(self, tmp_path):
        tensors = {k: tensor_from_numpy(v, torch.device("cpu"))
                   for k, v in _mixed_tensors().items()}
        p = tmp_path / "t.safetensors"
        save_safetensors(p, tensors)
        back = load_safetensors(p)
        for k, t in tensors.items():
            assert back[k].dtype == t.dtype and back[k].shape == t.shape
            np.testing.assert_array_equal(_bits(back[k]), _bits(t))

    def test_lazy_reader_keys(self, tmp_path):
        p = tmp_path / "x.safetensors"
        save_safetensors(p, {"w": torch.zeros(4)})
        sf = SafetensorsFile(p)
        assert sf.keys() == ["w"]
        assert sf.read("w").shape == (4,)

    def test_missing_file(self, tmp_path):
        with pytest.raises(FileNotFoundError):
            load_safetensors(tmp_path)

    def test_files_cross_packages(self, tmp_path):
        """Both writers give the same bytes; each package reads the other's
        file to the same values and dtypes (BF16, F8_E4M3, F8_E5M2 too)."""
        arrays = _mixed_tensors()
        a, b = tmp_path / "jax.safetensors", tmp_path / "port.safetensors"
        jst.save_safetensors(a, arrays)
        save_safetensors(b, {k: tensor_from_numpy(v, torch.device("cpu"))
                             for k, v in arrays.items()})
        assert a.read_bytes() == b.read_bytes()
        from_jax, from_port = load_safetensors(a), jst.load_safetensors(b)
        for k, v in arrays.items():
            assert from_jax[k].dtype == tensor_from_numpy(v, torch.device("cpu")).dtype
            np.testing.assert_array_equal(_bits(from_jax[k]), _bits(v))
            assert from_port[k].dtype == v.dtype
            np.testing.assert_array_equal(_bits(from_port[k]), _bits(v))


def test_safetensors_to_llama_params(tmp_path):
    """HF-named tensors (weights [out, in]) -> the port's Llama tree -> the
    same forward."""
    cfg = tl.LlamaConfig.tiny(vocab_size=64)
    params = tl.init_llama_params(cfg, _gen(0), device="cpu")
    tensors = {"model.embed_tokens.weight": params["embed"]["wte"],
               "model.norm.weight": params["norm_f"]["gamma"]}
    names = {"wq": "self_attn.q_proj", "wk": "self_attn.k_proj", "wv": "self_attn.v_proj",
             "wo": "self_attn.o_proj", "gate": "mlp.gate_proj", "up": "mlp.up_proj",
             "down": "mlp.down_proj"}
    for i in range(cfg.num_layers):
        b, pre = params[f"h{i}"], f"model.layers.{i}"
        tensors[f"{pre}.input_layernorm.weight"] = b["ln_attn"]["gamma"]
        tensors[f"{pre}.post_attention_layernorm.weight"] = b["ln_mlp"]["gamma"]
        for ours, hf in names.items():
            tensors[f"{pre}.{hf}.weight"] = b[ours]["weight"].T.contiguous()
    path = tmp_path / "model.safetensors"
    save_safetensors(path, tensors)
    loaded = hf_llama_to_params(load_safetensors(path), cfg.num_layers, device="cpu")
    model = tl.Llama(cfg, device="cpu")
    toks = torch.tensor([[1, 2, 3]], dtype=torch.int32)
    torch.testing.assert_close(model.apply(loaded, toks), model.apply(params, toks),
                               rtol=1e-5, atol=1e-6)


def test_hf_gpt2_matches_jax(tmp_path):
    """The GPT-2 HF map (Conv1D weights [in, out], no transpose) gives the
    JAX map's tree from one file."""
    rng = np.random.default_rng(3)
    C, L = 8, 2
    arrays = {"wte.weight": (64, C), "wpe.weight": (16, C), "ln_f.weight": (C,),
              "ln_f.bias": (C,)}
    for i in range(L):
        for n, s in (("ln_1.weight", (C,)), ("ln_1.bias", (C,)), ("ln_2.weight", (C,)),
                     ("ln_2.bias", (C,)), ("attn.c_attn.weight", (C, 3 * C)),
                     ("attn.c_attn.bias", (3 * C,)), ("attn.c_proj.weight", (C, C)),
                     ("attn.c_proj.bias", (C,)), ("mlp.c_fc.weight", (C, 4 * C)),
                     ("mlp.c_fc.bias", (4 * C,)), ("mlp.c_proj.weight", (4 * C, C)),
                     ("mlp.c_proj.bias", (C,))):
            arrays[f"h.{i}.{n}"] = s
    arrays = {k: rng.normal(size=s).astype(np.float32) for k, s in arrays.items()}
    path = tmp_path / "gpt2.safetensors"
    jst.save_safetensors(path, arrays)
    want = jst.hf_gpt2_to_params(jst.load_safetensors(path), L)
    got = hf_gpt2_to_params(load_safetensors(path), L, device="cpu")
    assert dict(_leaves(got)).keys() == dict(_leaves(want)).keys()
    for name, leaf in _leaves(want):
        np.testing.assert_array_equal(dict(_leaves(got))[name].numpy(), leaf)
    toks = jnp.asarray([[1, 2, 3]], jnp.int32)
    kw = dict(vocab_size=64, max_seq_len=16, num_layers=L, num_heads=2, embedding_dim=C)
    ref = np.asarray(jg.GPT2(jg.GPT2Config(**kw)).apply(
        jax.tree_util.tree_map(jnp.asarray, want), toks))
    out = GPT2(GPT2Config(**kw), device="cpu").apply(got, torch.from_numpy(np.array(toks)))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
