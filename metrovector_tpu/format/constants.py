"""MVT file-format constants: magic, alignment, dtype/tile tables.

The MVT (MetroVector tile) layout keeps the proven O(1)-open envelope of the
reference format (magic at both ends, trailing u32 footer length —
``schema/FORMAT.md:11-24`` in thegenem0/metrovector) but replaces the
FlatBuffers footer with a versioned JSON manifest and, crucially, stores
vector blocks **tile-padded**: rows padded to the dtype's sublane
multiple and dims optionally padded to the 128-lane boundary, so a block maps
byte-for-byte onto a `(padded_rows, padded_dim)` device
array with no host-side reshuffle.
"""

from __future__ import annotations

import enum

import numpy as np

# File envelope -------------------------------------------------------------

MAGIC = b"MVT1"
MAGIC_LEN = len(MAGIC)
FOOTER_LEN_SIZE = 4  # trailing little-endian u32 footer length
# minimum possible file: magic + empty footer + len + magic
MIN_FILE_SIZE = MAGIC_LEN + FOOTER_LEN_SIZE + MAGIC_LEN
# Format evolution (the analog of the reference's ``format_version`` +
# ``compatibility_version`` pair, ``schema/mvf.fbs:13-14``): files carry
# both the writer's version and the *oldest reader version* able to open
# them. A reader accepts any file whose ``compat_version`` ≤ its own
# FORMAT_VERSION, so old files keep opening under new readers and new
# files degrade gracefully (unknown manifest keys are ignored) unless
# they use features the old reader can't interpret.
#   v1: round-1 layout (spaces, norms, indexes, tombstones, columns).
#   v2: adds the optional per-space stable vector-ID block (``ids_block``).
FORMAT_VERSION = 2

# Data blocks are aligned to this boundary inside the file so a block can be
# mapped / DMA'd with natural alignment (also friendly to O_DIRECT reads).
BLOCK_ALIGN = 512

# Block tiling (fixed by the on-disk format) ------------------------------

LANES = 128  # last-dim tile width of MVT vector blocks

# Minimum sublane multiple per element width (f32→8, bf16/f16→16,
# int8/uint8→32). Rows of a vector block are padded to this multiple.
SUBLANES_BY_ITEMSIZE = {4: 8, 2: 16, 1: 32}


class DataType(enum.IntEnum):
    """Element types storable in an MVT vector block or metadata column.

    Mirrors the reference enum ``DataType`` (``schema/types.fbs:3-11``) plus
    BFLOAT16, the 16-bit float with f32's exponent range.
    """

    FLOAT32 = 0
    FLOAT16 = 1
    INT8 = 2
    UINT8 = 3
    UINT32 = 4
    UINT64 = 5
    STRING_REF = 6  # index into the string heap (metadata columns only)
    BFLOAT16 = 7
    INT32 = 8
    INT64 = 9
    FLOAT64 = 10


class VectorType(enum.IntEnum):
    """Reference ``VectorType`` (``schema/types.fbs:14-17``)."""

    DENSE = 0
    SPARSE = 1


class DistanceMetric(enum.IntEnum):
    """Reference ``DistanceMetric`` (``schema/types.fbs:20-25``)."""

    L2 = 0
    INNER_PRODUCT = 1
    COSINE = 2
    CUSTOM = 3


class CompressionAlgorithm(enum.IntEnum):
    """Reference ``CompressionAlgorithm`` (``schema/types.fbs:28-32``).

    ZLIB is implemented natively (stdlib); LZ4/ZSTD are recognised but
    gated on optional codecs being importable.
    """

    NONE = 0
    LZ4 = 1
    ZSTD = 2
    ZLIB = 3


class TombstoneFormat(enum.IntEnum):
    """Reference ``TombstoneFormat`` (``schema/types.fbs:35-39``)."""

    NONE = 0
    BITMAP = 1
    SORTED_LIST = 2


class IndexKind(enum.IntEnum):
    """Reference ``Index`` union members (``schema/index.fbs:6-11``)."""

    NONE = 0
    FLAT = 1
    IVF = 2
    HNSW = 3
    CUSTOM = 4


# numpy dtype mapping -------------------------------------------------------

try:  # bfloat16 numpy dtype ships with jax/ml_dtypes
    import ml_dtypes as _ml_dtypes

    _BFLOAT16 = np.dtype(_ml_dtypes.bfloat16)
except Exception:  # pragma: no cover - ml_dtypes is a jax dependency
    _BFLOAT16 = None

_NP_BY_DTYPE = {
    DataType.FLOAT32: np.dtype("<f4"),
    DataType.FLOAT16: np.dtype("<f2"),
    DataType.INT8: np.dtype("i1"),
    DataType.UINT8: np.dtype("u1"),
    DataType.UINT32: np.dtype("<u4"),
    DataType.UINT64: np.dtype("<u8"),
    DataType.STRING_REF: np.dtype("<u4"),
    DataType.INT32: np.dtype("<i4"),
    DataType.INT64: np.dtype("<i8"),
    DataType.FLOAT64: np.dtype("<f8"),
}
if _BFLOAT16 is not None:
    _NP_BY_DTYPE[DataType.BFLOAT16] = _BFLOAT16

# dtypes allowed for vector blocks (vs metadata columns)
VECTOR_DTYPES = frozenset(
    {
        DataType.FLOAT32,
        DataType.FLOAT16,
        DataType.BFLOAT16,
        DataType.INT8,
        DataType.UINT8,
    }
)


def numpy_dtype(dtype: DataType) -> np.dtype:
    """The little-endian numpy dtype backing an MVT ``DataType``."""
    try:
        return _NP_BY_DTYPE[DataType(dtype)]
    except KeyError as exc:  # BFLOAT16 without ml_dtypes
        raise TypeError(f"no numpy dtype for {dtype!r}") from exc


def element_size(dtype: DataType) -> int:
    """Bytes per element (reference ``element_size`` maps, e.g.
    ``src/vectors/mem.rs:178-186``)."""
    return numpy_dtype(dtype).itemsize


def sublane_multiple(dtype: DataType) -> int:
    """Row-count padding multiple for a vector block of this dtype."""
    return SUBLANES_BY_ITEMSIZE.get(element_size(dtype), 8)


def round_up(x: int, multiple: int) -> int:
    return -(-x // multiple) * multiple


def padded_rows_for(num_rows: int, dtype: DataType) -> int:
    """Physical row count of a tile-padded block (≥1 tile even when empty)."""
    return round_up(max(num_rows, 1), sublane_multiple(dtype))


def padded_dim_for(dim: int, pad_dims: bool) -> int:
    """Physical per-row element count; padded to the 128-lane boundary when
    ``pad_dims`` (the default for spaces intended for device search)."""
    if pad_dims:
        return round_up(max(dim, 1), LANES)
    return dim
