"""The port's example programs (``mila_tpu_torch/examples/``), each driven
through its ``main()`` in-process as ``tests/examples/test_examples_smoke.py``
drives JAX's, at the same tiny settings, on the CPU: ``mnist_train`` takes
``--device cpu``; the others run on ``runtime.default_context()``, which a
fixture sets to the CPU. The repository holds no TinyShakespeare corpus
(two of JAX's cases fail here for that), so the charlm and gpt2_train cases
write one, ``data/tinyshakespeare/input.txt`` under a temporary working
directory, and a gpt2_train case also reads llm.c token shards it writes.

The slice-level parity case: JAX's ``write_gpt2_checkpoint`` writes a tiny
GPT-2 (2 layers, dim 64, its weights scaled up from JAX's init so that
greedy decoding does not settle on one token), then JAX's example and the
port's generate from it greedily in float32, plain, with int8 and fp8
weights and speculatively; the printed ``token ids:`` lists must be equal.
"""

import contextlib
import io
import runpy
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from mila_tpu.models.gpt2 import GPT2 as JGPT2
from mila_tpu.models.gpt2 import GPT2Config as JGPT2Config
from mila_tpu.serialization.llmc import write_gpt2_checkpoint as jwrite_gpt2_checkpoint
from mila_tpu_torch.data import write_token_file
from mila_tpu_torch.runtime import ExecutionContext, set_default_context

ROOT = Path(__file__).parent.parent
EXAMPLES = ROOT / "mila_tpu_torch" / "examples"
JAX_EXAMPLES = ROOT / "examples"


@pytest.fixture(autouse=True)
def cpu_context():
    set_default_context(ExecutionContext("cpu"))
    yield
    set_default_context(None)


def _run(script: str, argv: list[str], monkeypatch, where: Path = EXAMPLES) -> int:
    monkeypatch.setattr(sys, "argv", [script, *argv])
    try:
        runpy.run_path(str(where / script), run_name="__main__")
    except SystemExit as e:
        return int(e.code or 0)
    return 0


def _write_corpus(directory: Path, n_words: int = 6000) -> bytes:
    """A word-level stand-in for TinyShakespeare, from a seed."""
    words = [b"ROMEO:", b"JULIET:", b"the", b"love", b"night", b"thou", b"art", b"sweet",
             b"and", b"my", b"lord", b"fair", b"day", b"o", b"speak", b"again"]
    rng = np.random.default_rng(0)
    text = b" ".join(words[i] for i in rng.integers(0, len(words), n_words)) + b"\n"
    (directory / "data" / "tinyshakespeare").mkdir(parents=True)
    (directory / "data" / "tinyshakespeare" / "input.txt").write_bytes(text)
    return text


# --------------------------------------------------------------------------
# tests/examples/test_examples_smoke.py's cases
# --------------------------------------------------------------------------

def test_mnist_example(monkeypatch):
    code = _run("mnist_train.py",
                ["--epochs", "3", "--synthetic-n", "512", "--batch-size", "64",
                 "--device", "cpu"], monkeypatch)
    assert code == 0  # the accuracy gate inside the script


def test_mnist_example_checkpoint(monkeypatch, tmp_path, capsys):
    code = _run("mnist_train.py",
                ["--epochs", "2", "--synthetic-n", "512", "--batch-size", "64",
                 "--device", "cpu", "--checkpoint", str(tmp_path / "mnist.mila")], monkeypatch)
    assert code == 0 and (tmp_path / "mnist.mila").exists()
    out = capsys.readouterr().out
    assert "final test accuracy" in out and "training throughput" in out


def test_mnist_example_auto_is_the_gpu(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("auto resolves to the GPU here")
    with pytest.raises(ValueError, match="no 'gpu' devices"):
        _run("mnist_train.py", ["--epochs", "1", "--synthetic-n", "128"], monkeypatch)


def test_charlm_example(monkeypatch, tmp_path, capsys):
    monkeypatch.chdir(tmp_path)
    _write_corpus(tmp_path)
    code = _run("charlm_train.py",
                ["--steps", "12", "--batch-size", "8", "--seq-len", "32", "--sample", "16"],
                monkeypatch)
    assert code == 0
    out = capsys.readouterr().out
    assert "perplexity" in out and "sample" in out
    assert out.split("--- sample ---\n")[1].startswith("ROMEO:")


def test_charlm_example_quant_eval_and_export(monkeypatch, tmp_path, capsys):
    monkeypatch.chdir(tmp_path)
    _write_corpus(tmp_path)
    code = _run("charlm_train.py",
                ["--steps", "4", "--batch-size", "4", "--seq-len", "32", "--sample", "0",
                 "--layers", "1", "--dim", "64", "--heads", "2", "--quant-eval",
                 "--checkpoint", str(tmp_path / "charlm.mila")], monkeypatch)
    assert code == 0 and (tmp_path / "charlm.mila").exists()
    out = capsys.readouterr().out
    for qdt in ("int8", "fp8_e4m3", "int4"):
        assert f"quantization gate [{qdt}]" in out


def test_charlm_example_without_corpus(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    assert _run("charlm_train.py", ["--steps", "1"], monkeypatch) == 2


def test_gpt2_train_example(monkeypatch, tmp_path, capsys):
    monkeypatch.chdir(tmp_path)
    _write_corpus(tmp_path)
    code = _run("gpt2_train.py",
                ["--steps", "6", "--batch-size", "4", "--seq-len", "32",
                 "--layers", "1", "--dim", "32", "--heads", "2", "--val-every", "3"],
                monkeypatch)
    assert code == 0
    assert "final train loss" in capsys.readouterr().out


def test_gpt2_train_example_on_shards(monkeypatch, tmp_path, capsys):
    """llm.c token shards over a vocabulary whose largest id is 300, then
    the three quantization gates and a checkpoint."""
    rng = np.random.default_rng(1)
    base = rng.integers(0, 300, 64)
    stream = np.concatenate([np.append(base[rng.permutation(64)], 300) for _ in range(80)])
    write_token_file(tmp_path / "train_000.bin", stream)
    write_token_file(tmp_path / "val_000.bin", stream[::-1].copy())
    code = _run("gpt2_train.py",
                ["--shards", str(tmp_path / "train_*.bin"),
                 "--val-shards", str(tmp_path / "val_*.bin"), "--steps", "4",
                 "--batch-size", "4", "--seq-len", "32", "--layers", "1", "--dim", "64",
                 "--heads", "2", "--val-every", "2", "--quant-eval",
                 "--checkpoint", str(tmp_path / "gpt2.mila")], monkeypatch)
    assert code == 0 and (tmp_path / "gpt2.mila").exists()
    out = capsys.readouterr().out
    assert "final train loss" in out
    for qdt in ("int8", "fp8_e4m3", "int4"):
        assert f"quantization gate [{qdt}]" in out


def test_gpt2_generate_example(monkeypatch, capsys):
    code = _run("gpt2_generate.py", ["--random-init", "--tokens", "4", "--quantize", "int8"],
                monkeypatch)
    assert code == 0
    assert "token ids" in capsys.readouterr().out


def test_gpt2_generate_example_speculative(monkeypatch, capsys):
    code = _run("gpt2_generate.py", ["--random-init", "--tokens", "6", "--speculative-k", "2",
                                     "--temperature", "0"], monkeypatch)
    assert code == 0
    out = capsys.readouterr().out
    assert "speculative acceptance" in out and "token ids" in out


def test_gpt2_generate_example_needs_weights(monkeypatch):
    assert _run("gpt2_generate.py", ["--tokens", "2"], monkeypatch) == 2


def test_viz_example(monkeypatch, tmp_path, capsys):
    code = _run("viz_demo.py", ["--epochs", "1", "--ppm-out", str(tmp_path / "w.ppm")],
                monkeypatch)
    assert code == 0
    assert (tmp_path / "w.ppm").read_bytes().startswith(b"P6 512 256 255\n")
    out = capsys.readouterr().out
    assert "train loss" in out and "fc1/weight (784, 64)" in out and "wrote" in out


# --------------------------------------------------------------------------
# the slice: JAX's example and the port's on one llm.c file
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_checkpoint(tmp_path_factory):
    cfg = JGPT2Config(vocab_size=300, max_seq_len=64, num_layers=2, num_heads=4,
                      embedding_dim=64)
    params = JGPT2(cfg).init(jax.random.key(3), (1, 8))
    # JAX's init (std 0.02) makes a near-constant next token; scaled up,
    # greedy streams wander over the vocabulary.
    params = jax.tree_util.tree_map_with_path(
        lambda p, x: x * 8.0 if p[-1].key in ("weight", "wte", "wpe") else x, params)
    path = tmp_path_factory.mktemp("llmc") / "tiny_gpt2.bin"
    jwrite_gpt2_checkpoint(path, cfg, params)
    return path


def _token_ids(where: Path, argv: list[str], monkeypatch) -> list:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert _run("gpt2_generate.py", argv, monkeypatch, where) == 0
    lines = [ln for ln in buf.getvalue().splitlines() if ln.startswith("token ids:")]
    assert len(lines) == 1
    return eval(lines[0].split(":", 1)[1])  # noqa: S307 - a printed list of ints


@pytest.mark.parametrize("extra", [[], ["--quantize", "int8"], ["--quantize", "fp8_e4m3"],
                                   ["--speculative-k", "3"]],
                         ids=["float32", "int8", "fp8_e4m3", "speculative"])
def test_gpt2_generate_token_ids_match_jax(tiny_checkpoint, monkeypatch, extra):
    argv = ["--checkpoint", str(tiny_checkpoint), "--temperature", "0", "--tokens", "8",
            "--dtype", "float32", "--prompt-ids", "17,4,250", *extra]
    got = _token_ids(EXAMPLES, argv, monkeypatch)
    want = _token_ids(JAX_EXAMPLES, argv, monkeypatch)
    assert got == want
    assert len(got) == 11 and got[:3] == [17, 4, 250]
    assert len(set(got[3:])) > 2  # the stream is no constant
