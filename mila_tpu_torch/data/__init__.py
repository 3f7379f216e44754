"""Dataset readers (port of ``mila_tpu/data``: the in-memory reader; the
llm.c and text loaders and the prefetcher are not ported yet)."""

from mila_tpu_torch.data.loader import ArrayReader, DatasetReader

__all__ = ["ArrayReader", "DatasetReader"]
