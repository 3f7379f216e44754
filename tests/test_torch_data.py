"""The port's data layer (mirrors ``tests/data/test_loaders.py``,
``test_prefetch.py`` and ``test_bpe.py``), and its batches against the JAX
package's on the same files and seeds: ``synthetic_mnist`` and the
``TokenReader``, ``CharReader`` and ``MnistReader`` batches bit-equal, and
the BPE encoder's ids equal to JAX's on the same vocabulary and merges.

The corpora are written by the tests into ``tmp_path``; the real MNIST
files and Tiny Shakespeare are not needed (the Shakespeare loader's twin
asserts that it finds nothing here, as JAX's does).
"""

import struct
import threading
import time

import numpy as np
import pytest
import torch

from mila_tpu.data import CharReader as JCharReader
from mila_tpu.data import MnistReader as JMnistReader
from mila_tpu.data import TokenReader as JTokenReader
from mila_tpu.data import synthetic_mnist as j_synthetic_mnist
from mila_tpu.data.bpe import BPETokenizer as JBPETokenizer
from mila_tpu_torch import native
from mila_tpu_torch.data import (
    ArrayReader,
    CharReader,
    CharVocabulary,
    MnistReader,
    PrefetchLoader,
    TokenReader,
    load_tiny_shakespeare,
    prefetch_to_device,
    read_token_file,
    synthetic_mnist,
)
from mila_tpu_torch.data.bpe import BPETokenizer, derive_merges
from mila_tpu_torch.data.mnist import read_idx_images, read_idx_labels


# --------------------------------------------------------------------------
# tests/data/test_loaders.py
# --------------------------------------------------------------------------

class TestArrayReader:
    def test_batching_and_shapes(self):
        x = np.arange(100, dtype=np.float32).reshape(100, 1)
        y = np.arange(100, dtype=np.int32)
        r = ArrayReader(x, y, batch_size=32, shuffle=False)
        assert r.num_batches == 3
        batches = list(r)
        assert len(batches) == 3
        assert batches[0][0].shape == (32, 1)

    def test_no_drop_last(self):
        x = np.zeros((10, 2), np.float32)
        y = np.zeros(10, np.int32)
        r = ArrayReader(x, y, batch_size=4, drop_last=False, shuffle=False)
        assert r.num_batches == 3
        assert list(r)[-1][0].shape == (2, 2)

    def test_shuffle_deterministic_per_epoch(self):
        x = np.arange(64, dtype=np.float32).reshape(64, 1)
        y = np.arange(64, dtype=np.int32)
        r1 = ArrayReader(x, y, batch_size=8, shuffle=True, seed=3)
        r2 = ArrayReader(x, y, batch_size=8, shuffle=True, seed=3)
        np.testing.assert_array_equal(r1.next_batch(0)[1], r2.next_batch(0)[1])
        first = r1.next_batch(0)[1].copy()
        r1.reset()
        assert not np.array_equal(first, r1.next_batch(0)[1])

    def test_rank_sharding_disjoint(self):
        x = np.arange(100, dtype=np.float32).reshape(100, 1)
        y = np.arange(100, dtype=np.int32)
        seen = []
        for rank in range(4):
            r = ArrayReader(x, y, batch_size=5, shuffle=False, process_rank=rank,
                            num_processes=4)
            assert len(r) == 25
            seen.append(set(int(t) for _, tb in r for t in tb))
        assert len(set().union(*seen)) == 100
        with pytest.raises(ValueError):
            ArrayReader(x, y, batch_size=5, process_rank=4, num_processes=4)


def _write_idx(tmp_path, n=2, labels=(3, 7)):
    imgs = (np.arange(n * 28 * 28) % 256).astype(np.uint8)
    img_path = tmp_path / "train-images-idx3-ubyte"
    img_path.write_bytes(struct.pack(">IIII", 2051, n, 28, 28) + imgs.tobytes())
    lbl_path = tmp_path / "train-labels-idx1-ubyte"
    lbl_path.write_bytes(struct.pack(">II", 2049, n) + bytes(labels))
    return img_path, lbl_path


class TestMnist:
    def test_idx_round_trip(self, tmp_path):
        img_path, lbl_path = _write_idx(tmp_path)
        x = read_idx_images(img_path)
        y = read_idx_labels(lbl_path)
        assert x.shape == (2, 784) and x.max() <= 1.0
        np.testing.assert_array_equal(y, [3, 7])

    def test_bad_magic_raises(self, tmp_path):
        p = tmp_path / "train-images-idx3-ubyte"
        p.write_bytes(struct.pack(">IIII", 1234, 1, 28, 28) + bytes(784))
        with pytest.raises(ValueError, match="magic"):
            read_idx_images(p)

    def test_synthetic_learnable_structure(self):
        x, y = synthetic_mnist(n=500, seed=0)
        assert x.shape == (500, 784) and x.min() >= 0 and x.max() <= 1
        assert y.min() >= 0 and y.max() <= 9
        cents = np.stack([x[y == c].mean(0) for c in range(10)])
        pred = np.argmin(((x[:, None, :] - cents[None]) ** 2).sum(-1), axis=1)
        assert (pred == y).mean() > 0.9

    def test_reader_synthetic_fallback(self, tmp_path):
        r = MnistReader(batch_size=16, data_dir=str(tmp_path), synthetic_n=64)
        assert r.is_synthetic
        xb, yb = r.next_batch(0)
        assert xb.shape == (16, 784) and yb.dtype == np.int32

    def test_reader_real_required_raises(self, tmp_path):
        with pytest.raises(FileNotFoundError):
            MnistReader(batch_size=4, data_dir=str(tmp_path), source="real")


def _llmc_shard(path, toks):
    header = np.zeros(256, np.int32)
    header[0], header[1], header[2] = 20240520, 1, len(toks)
    path.write_bytes(header.tobytes() + toks.astype(np.uint16).tobytes())
    return path


class TestTokenReader:
    def test_llmc_format(self, tmp_path):
        toks = np.arange(1000, dtype=np.uint16)
        out = read_token_file(_llmc_shard(tmp_path / "shard.bin", toks))
        np.testing.assert_array_equal(out, toks)

    def test_batching_next_token_shift(self, tmp_path):
        p = tmp_path / "raw.bin"
        p.write_bytes(np.arange(1000, dtype=np.uint16).tobytes())
        r = TokenReader([p], batch_size=2, seq_len=8)
        x, y = r.next_batch(0)
        assert x.shape == (2, 8)
        np.testing.assert_array_equal(y, x + 1)

    def test_missing_shards_raise(self, tmp_path):
        with pytest.raises(FileNotFoundError):
            TokenReader(str(tmp_path / "nonexistent" / "*.bin"), batch_size=2, seq_len=8)


class TestCharReader:
    def test_vocab_round_trip(self):
        v = CharVocabulary(b"hello world")
        assert v.decode(v.encode("hello")) == "hello"
        assert v.size == len(set(b"hello world"))

    def test_windows_50pct_overlap(self):
        r = CharReader(bytes(range(65, 91)) * 10, batch_size=4, seq_len=16, shuffle=False)
        assert r.stride == 8
        x, y = r.next_batch(0)
        assert x.shape == (4, 16)
        np.testing.assert_array_equal(x[0, 1:], y[0, :-1])

    def test_tiny_shakespeare_absent_gives_none(self, tmp_path, monkeypatch):
        # The twin of JAX's test_tiny_shakespeare_available: the corpus is not
        # in the repository, so the loader finds nothing, as JAX's does here.
        monkeypatch.chdir(tmp_path)
        assert load_tiny_shakespeare() is None
        (tmp_path / "data" / "tinyshakespeare").mkdir(parents=True)
        (tmp_path / "data" / "tinyshakespeare" / "input.txt").write_bytes(b"To be. " * 20)
        data = load_tiny_shakespeare()
        r = CharReader(data, batch_size=2, seq_len=16)
        assert r.next_batch(0)[0].shape == (2, 16)


# --------------------------------------------------------------------------
# tests/data/test_prefetch.py (device "cpu": tensors, nothing pinned)
# --------------------------------------------------------------------------

class TestPrefetch:
    def test_yields_all_batches_in_order(self):
        x = np.arange(40, dtype=np.float32).reshape(20, 2)
        y = np.arange(20, dtype=np.int32)
        reader = ArrayReader(x, y, batch_size=4, shuffle=False)
        direct = [(np.asarray(a), np.asarray(b)) for a, b in reader]
        pre = list(PrefetchLoader(reader, depth=2, device="cpu"))
        assert len(pre) == len(direct)
        for (dx, dy), (px, py) in zip(direct, pre):
            assert isinstance(px, torch.Tensor) and px.device.type == "cpu"
            assert not px.is_pinned()
            np.testing.assert_array_equal(dx, px.numpy())
            np.testing.assert_array_equal(dy, py.numpy())

    def test_overlaps_producer(self):
        events = []

        def slow_reader():
            for i in range(5):
                events.append(("produced", i, time.monotonic()))
                yield np.full((2,), i, np.float32)

        out = []
        for b in PrefetchLoader(slow_reader(), depth=3, device_put=False):
            time.sleep(0.05)
            out.append(int(b[0]))
        assert out == list(range(5))
        assert events[-1][2] - events[0][2] < 0.2

    def test_error_propagates(self):
        def bad_reader():
            yield np.zeros(2)
            raise RuntimeError("reader exploded")

        it = iter(PrefetchLoader(bad_reader(), depth=2, device_put=False))
        next(it)
        with pytest.raises(RuntimeError, match="exploded"):
            list(it)

    def test_early_stop_joins_worker(self):
        threads_before = threading.active_count()

        def reader():
            for _ in range(1000):
                yield np.zeros(2)

        it = iter(PrefetchLoader(reader(), depth=2, device_put=False))
        next(it)
        it.close()
        time.sleep(0.1)
        assert threading.active_count() <= threads_before

    def test_functional_form_with_device(self):
        batches = list(prefetch_to_device([np.ones((4, 2))] * 3, device="cpu"))
        assert len(batches) == 3
        assert batches[0].device == torch.device("cpu") and batches[0].dtype == torch.float64

    def test_no_device_means_the_gpu(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(RuntimeError, match="CUDA"):
            PrefetchLoader([np.ones(2)])


# --------------------------------------------------------------------------
# tests/data/test_bpe.py
# --------------------------------------------------------------------------

_EXTRA = [b"th", b"he", b"the", b" the", b"ab", b"abab"]


def make_toy():
    return BPETokenizer.byte_fallback(_EXTRA)


class TestPythonBPE:
    def test_roundtrip_ascii(self):
        tok = make_toy()
        for s in ["the theatre', she said", "a b  c\n\ttabs", "1234 5,6!", ""]:
            assert tok.decode(tok.encode(s, use_native=False)) == s

    def test_merges_applied_in_rank_order(self):
        tok = make_toy()
        ids = tok.encode("the", use_native=False)
        assert tok.decode(ids) == "the"
        assert len(ids) == 1 and tok.vocab[int(ids[0])] == b"the"

    def test_leading_space_attaches(self):
        tok = make_toy()
        ids = tok.encode("of the", use_native=False)
        assert b" the" in [tok.vocab[int(i)] for i in ids]

    def test_pretoken_boundaries_stop_merges(self):
        tok = make_toy()
        assert [tok.vocab[int(i)] for i in tok.encode("abab", use_native=False)] == [b"abab"]
        ids2 = tok.encode("ab ab", use_native=False)
        assert b"abab" not in [tok.vocab[int(i)] for i in ids2]

    def test_contractions(self):
        tok = BPETokenizer.byte_fallback()
        assert tok.decode(tok.encode("it's", use_native=False)) == "it's"

    def test_utf8_roundtrip(self):
        tok = BPETokenizer.byte_fallback()
        s = "héllo wörld — ελληνικά 日本語"
        assert tok.decode(tok.encode(s, use_native=False)) == s

    def test_unknown_byte_raises(self):
        tok = BPETokenizer([bytes([b]) for b in range(255)])
        with pytest.raises(ValueError, match="not in vocab"):
            tok._encode_py(bytes([255]))


class TestDeriveMerges:
    def test_derives_creation_order(self):
        vocab = [bytes([b]) for b in range(256)] + [b"ab", b"cd", b"abcd"]
        triples = derive_merges(vocab)
        assert (ord("a"), ord("b"), 256) in triples
        assert (ord("c"), ord("d"), 257) in triples
        assert (256, 257, 258) in triples
        ids = [m for _, _, m in triples]
        assert ids == sorted(ids)

    def test_explicit_pairs_resolve_merged_id(self):
        vocab = [bytes([b]) for b in range(256)] + [b"ab"]
        tok = BPETokenizer(vocab, merges=[(ord("a"), ord("b"))])
        assert tok.merges == [(ord("a"), ord("b"), 256)]


_SAMPLES = [
    "the theatre of the absurd, she'll say: 'we've 123 items!'",
    "  leading and trailing  ",
    "abab ab the\nthe",
    "".join(chr(c) for c in np.random.default_rng(0).integers(32, 127, 500)),
    "mixed üñíçödé and ascii 42",
]


class TestNativeBPE:
    @pytest.fixture(scope="class")
    def tok(self):
        t = make_toy()
        assert native.available(), native.load_error()
        assert t._native_handle is not None
        return t

    def test_native_matches_python(self, tok):
        for s in _SAMPLES:
            np.testing.assert_array_equal(tok.encode(s, use_native=True),
                                          tok.encode(s, use_native=False))

    def test_native_roundtrip(self, tok):
        s = "the quick brown fox's 99 bottles"
        assert tok.decode(tok.encode(s, use_native=True)) == s


# --------------------------------------------------------------------------
# Against the JAX package
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n,seed,noise", [(500, 0, 0.25), (333, 1, 0.25), (64, 7, 0.1)])
def test_synthetic_mnist_bit_equal_to_jax(n, seed, noise):
    x, y = synthetic_mnist(n, seed=seed, noise=noise)
    jx, jy = j_synthetic_mnist(n, seed=seed, noise=noise)
    assert x.dtype == jx.dtype and y.dtype == jy.dtype
    assert x.tobytes() == jx.tobytes() and y.tobytes() == jy.tobytes()


def _epochs(reader, n=2):
    out = []
    for e in range(n):
        reader.reset(e)
        out.extend(reader)
    return out


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for (gx, gy), (wx, wy) in zip(got, want):
        for g, w in ((gx, wx), (gy, wy)):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert g.tobytes() == w.tobytes()


@pytest.mark.parametrize("shuffle", [False, True])
def test_token_reader_batches_equal_jax(tmp_path, shuffle):
    toks = np.random.default_rng(3).integers(0, 50257, 5000)
    files = [_llmc_shard(tmp_path / f"s{i}.bin", toks[i * 2500:(i + 1) * 2500]) for i in range(2)]
    kw = dict(batch_size=4, seq_len=64, shuffle=shuffle, seed=5, process_rank=1, num_processes=2)
    got = TokenReader(str(tmp_path / "s*.bin"), **kw)
    want = JTokenReader(str(tmp_path / "s*.bin"), **kw)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    _assert_batches_equal(_epochs(got), _epochs(want))
    # The native gather equals the numpy windows over read_token_file.
    x, y = got.next_batch(1)
    starts = got._starts[got._perm[4:8] if shuffle else np.arange(4, 8)]
    idx = starts[:, None] + np.arange(65)[None, :]
    np.testing.assert_array_equal(x, got.tokens[idx][:, :-1])
    np.testing.assert_array_equal(y, got.tokens[idx][:, 1:])
    del files


def test_char_reader_batches_equal_jax(tmp_path):
    corpus = tmp_path / "input.txt"
    corpus.write_bytes(b"".join(bytes(np.random.default_rng(i).integers(32, 127, 97).tolist())
                                + b"\n" for i in range(40)))
    for kw in (dict(shuffle=True, seed=2), dict(shuffle=False, stride=5)):
        got = CharReader(corpus, batch_size=3, seq_len=32, **kw)
        want = JCharReader(corpus, batch_size=3, seq_len=32, **kw)
        np.testing.assert_array_equal(got.vocab.id_of, want.vocab.id_of)
        _assert_batches_equal(_epochs(got, 3), _epochs(want, 3))


def test_mnist_reader_batches_equal_jax(tmp_path):
    for split in ("train", "test"):
        kw = dict(batch_size=32, split=split, data_dir=str(tmp_path), synthetic_n=640, seed=4)
        _assert_batches_equal(_epochs(MnistReader(**kw)), _epochs(JMnistReader(**kw)))
    # Real IDX files where they are present: the same pixels and labels.
    img, lbl = _write_idx(tmp_path, n=3, labels=(1, 2, 9))
    got, want = MnistReader(batch_size=3, data_dir=str(tmp_path)), JMnistReader(
        batch_size=3, data_dir=str(tmp_path))
    assert not got.is_synthetic and not want.is_synthetic
    _assert_batches_equal(_epochs(got), _epochs(want))


def test_bpe_ids_equal_jax():
    vocab = [bytes([b]) for b in range(256)] + _EXTRA + [b"in", b"ing", b" a", b"er", b"12"]
    got, want = BPETokenizer(vocab), JBPETokenizer(vocab)
    assert got.merges == want.merges
    for s in _SAMPLES + ["singing in the rain, 1212 players' ering"]:
        ids = got.encode(s)
        np.testing.assert_array_equal(ids, want.encode(s, use_native=False))
        np.testing.assert_array_equal(got.encode(s, use_native=False), ids)


def test_prefetch_stress_under_fast_switching():
    # One producer thread against the consumer with the interpreter
    # switching threads every microsecond: every batch arrives once, in
    # order, at each depth, and an early stop leaves no worker behind.
    import sys

    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for depth in (1, 2, 5):
            batches = [np.full((3,), i, np.int64) for i in range(2000)]
            got = [int(b[0]) for b in PrefetchLoader(batches, depth=depth, device="cpu")]
            assert got == list(range(2000))
            threads = threading.active_count()
            it = iter(PrefetchLoader(batches, depth=depth, device="cpu"))
            next(it)
            it.close()
            deadline = time.monotonic() + 5
            while threading.active_count() > threads and time.monotonic() < deadline:
                time.sleep(0.01)
            assert threading.active_count() <= threads
    finally:
        sys.setswitchinterval(before)
