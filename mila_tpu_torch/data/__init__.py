"""Data layer (port of ``mila_tpu/data``): the in-memory reader, llm.c token
shards, the char corpus, the BPE encoder, MNIST and the device prefetcher."""

from mila_tpu_torch.data.bpe import BPETokenizer, derive_merges
from mila_tpu_torch.data.chars import CharReader, CharVocabulary, load_tiny_shakespeare
from mila_tpu_torch.data.loader import ArrayReader, DatasetReader
from mila_tpu_torch.data.mnist import MnistReader, load_mnist, synthetic_mnist
from mila_tpu_torch.data.prefetch import PrefetchLoader, prefetch_to_device
from mila_tpu_torch.data.tokens import TokenReader, read_token_file

__all__ = [
    "BPETokenizer",
    "PrefetchLoader",
    "prefetch_to_device",
    "derive_merges",
    "ArrayReader",
    "DatasetReader",
    "CharReader",
    "CharVocabulary",
    "load_tiny_shakespeare",
    "MnistReader",
    "load_mnist",
    "synthetic_mnist",
    "TokenReader",
    "read_token_file",
]
