"""metrovector_tpu — a vector storage and accelerator exact-search framework.

A from-scratch rebuild of the capabilities of thegenem0/metrovector (MVF):

* **MVT format** (:mod:`.format`): a compact binary file format for dense
  vector-embedding collections — multiple named spaces, Float32 / Float16 /
  BFloat16 / Int8 / UInt8 elements, columnar metadata with a string heap,
  CRC32 block checksums, tombstones — stored **tile-aligned** so blocks load
  directly into tile-shaped device arrays.
* **Host access layer** (:mod:`.vectors`): zero-copy mmap views — spaces,
  vectors, strided slices, dimension columns, batch planning, streaming.
* **Query engine** (:mod:`.ops`, :mod:`.engine`): exact brute-force top-k
  similarity search (L2 / cosine / inner product) as blocked matmuls
  with a carried top-k in one jitted scan.
* **Scaling** (:mod:`.parallel`): corpus sharding over a device mesh with
  all-gather top-k merges, and host streaming for corpora larger than device memory.

The lazy imports below keep ``import metrovector_tpu`` jax-free until a
compute-path symbol is touched, so the pure storage layer stays importable
in minimal environments.
"""

from . import errors
from .errors import MvtError
from .format import (
    Builder,
    BuiltFile,
    CompressionAlgorithm,
    DataType,
    DistanceMetric,
    IndexKind,
    Reader,
    TombstoneFormat,
    VectorType,
    Writer,
    builder_from_reader,
    compact,
    rewrite_hints,
)
from .vectors import (
    AccessPattern,
    DimensionSlice,
    Vector,
    VectorChunkIterator,
    VectorSlice,
    VectorSpace,
)

__version__ = "0.4.0"

_LAZY = {
    "Database": ".database",
    "SearchEngine": ".engine",
    "DeviceSpace": ".engine",
    "SearchResult": ".engine",
    "SparseSearchEngine": ".sparse",
    "PreparedFilter": ".engine",
    "RadiusResult": ".engine",
    "PreparedQueries": ".engine",
    "HNSWIndex": ".index",
    "IVFIndex": ".index",
    "IVFPQIndex": ".index",
    "PQIndex": ".index",
    "train_ivfpq": ".index",
    "train_kmeans": ".index",
    "train_pq": ".index",
    "encode_pq": ".index",
    "MicroBatcher": ".serving",
    "BatcherStats": ".serving",
    "StreamingSearcher": ".parallel",
    "ShardedDeviceSpace": ".parallel",
    "DistributedSearcher": ".parallel",
    "make_mesh": ".parallel",
    "sharded_topk": ".parallel",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        mod = importlib.import_module(_LAZY[name], __name__)
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "AccessPattern",
    "Builder",
    "BuiltFile",
    "CompressionAlgorithm",
    "DataType",
    "DeviceSpace",
    "DimensionSlice",
    "DistanceMetric",
    "DistributedSearcher",
    "HNSWIndex",
    "IVFIndex",
    "IVFPQIndex",
    "IndexKind",
    "MicroBatcher",
    "BatcherStats",
    "MvtError",
    "PQIndex",
    "PreparedFilter",
    "RadiusResult",
    "PreparedQueries",
    "Reader",
    "SearchEngine",
    "SearchResult",
    "ShardedDeviceSpace",
    "SparseSearchEngine",
    "StreamingSearcher",
    "TombstoneFormat",
    "Vector",
    "VectorChunkIterator",
    "VectorSlice",
    "VectorSpace",
    "VectorType",
    "Writer",
    "Database",
    "builder_from_reader",
    "compact",
    "encode_pq",
    "errors",
    "make_mesh",
    "sharded_topk",
    "train_ivfpq",
    "train_kmeans",
    "train_pq",
]
