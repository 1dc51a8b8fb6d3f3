"""Tile packing/unpacking and codec helpers for MVT data blocks.

The write-path analog of the reference's per-element LE encode loop
(``src/builder.rs:176-191`` in thegenem0/metrovector), redesigned for the accelerator:
instead of a flat ``[N, D]`` byte stream, a vector block is a zero-padded
``[padded_rows, padded_dim]`` native-dtype array whose bytes equal the
device array layout, so loading is `np.frombuffer(...).reshape(...)` and a single
DMA — no decode loop at all. The native C++ codec accelerates the pad/copy
and CRC for large builds; these numpy implementations are the reference
semantics and the fallback.
"""

from __future__ import annotations

import zlib

import numpy as np

from ..errors import DimensionMismatchError, ExtensionError, InvalidVectorTypeError
from .constants import (
    CompressionAlgorithm,
    DataType,
    VECTOR_DTYPES,
    numpy_dtype,
    padded_dim_for,
    padded_rows_for,
)


def crc32(data) -> int:
    """Block checksum (reference uses crc32fast: ``src/builder.rs:251``)."""
    return zlib.crc32(bytes(data) if isinstance(data, memoryview) else data) & 0xFFFFFFFF


def as_vector_array(data, dim: int, dtype: DataType) -> np.ndarray:
    """Coerce user input (array-like / list of rows) to a contiguous
    ``[N, dim]`` numpy array of the space's dtype, validating the dimension
    the way the reference's ``add_vectors`` does (``src/builder.rs:165-173``:
    auto-infer when dim==0, else strict match)."""
    if dtype not in VECTOR_DTYPES:
        raise InvalidVectorTypeError(
            f"dtype {DataType(dtype).name} is not a vector dtype"
        )
    np_dt = numpy_dtype(dtype)
    arr = np.asarray(data)
    if arr.ndim == 1:
        arr = arr.reshape(1, -1) if arr.size else arr.reshape(0, max(dim, 0))
    if arr.ndim != 2:
        raise DimensionMismatchError(expected=dim, actual=arr.ndim)
    if dim > 0 and arr.shape[1] != dim:
        raise DimensionMismatchError(expected=dim, actual=int(arr.shape[1]))
    return np.ascontiguousarray(arr, dtype=np_dt)


def pack_block(rows: np.ndarray, dtype: DataType, pad_dims: bool = True):
    """Tile-pad ``rows`` ([N, D]) into the physical block array.

    Returns ``(block, padded_rows, padded_dim)`` where ``block`` is a
    C-contiguous ``[padded_rows, padded_dim]`` array of the block dtype with
    zero padding. Zero padding is load-bearing: padded rows produce finite
    scores that the query engine masks by row index, and padded dims
    contribute exactly 0 to every inner product / squared distance.
    """
    n, d = rows.shape
    pr = padded_rows_for(n, dtype)
    pd = padded_dim_for(d, pad_dims)
    block = np.zeros((pr, pd), dtype=numpy_dtype(dtype))
    block[:n, :d] = rows
    return block, pr, pd


def unpack_block(raw, padded_rows: int, padded_dim: int, dtype: DataType) -> np.ndarray:
    """Zero-copy view of a stored block as ``[padded_rows, padded_dim]``.

    ``raw`` is a buffer (mmap slice); the result aliases it. The logical
    vectors are ``view[:num_vectors, :dim]``.
    """
    np_dt = numpy_dtype(dtype)
    expect = padded_rows * padded_dim * np_dt.itemsize
    if len(raw) < expect:
        raise DimensionMismatchError(expected=expect, actual=len(raw))
    return np.frombuffer(raw, dtype=np_dt, count=padded_rows * padded_dim).reshape(
        padded_rows, padded_dim
    )


def squared_norms(block: np.ndarray) -> np.ndarray:
    """Per-row squared L2 norms as f32, computed at build time and stored so
    the L2/cosine epilogues never re-read the vectors (score = 2q·x − ‖x‖²)."""
    x = block.astype(np.float32, copy=False)
    # f64 accumulation, matching the native codec bit-for-bit.
    return np.einsum("ij,ij->i", x, x, dtype=np.float64).astype("<f4")


# String heap ---------------------------------------------------------------


class StringHeap:
    """Deduplicating string heap (reference ``add_string``,
    ``src/builder.rs:316-326``): UTF-8, NUL-terminated entries; metadata
    columns of ``STRING_REF`` store the u32 byte offset of each entry."""

    def __init__(self):
        self._buf = bytearray()
        self._offsets: dict[str, int] = {}

    def add(self, s: str) -> int:
        off = self._offsets.get(s)
        if off is None:
            off = len(self._buf)
            self._offsets[s] = off
            self._buf += s.encode("utf-8") + b"\x00"
        return off

    def to_bytes(self) -> bytes:
        return bytes(self._buf)

    def __len__(self) -> int:
        return len(self._buf)

    @staticmethod
    def read(heap: bytes, offset: int) -> str:
        if offset >= len(heap):
            raise IndexError(f"string offset {offset} out of heap (len {len(heap)})")
        end = heap.index(b"\x00", offset)
        return heap[offset:end].decode("utf-8")


# Compression ---------------------------------------------------------------
#
# LZ4 uses MVT's own block-format codec (native C++ with this pure-Python
# twin — the spec at lz4.github.io/lz4/lz4_Block_format.html; the reference
# declares LZ4 in types.fbs:28-32 but this environment ships no lz4
# package, so the codec is self-contained). Streams are spec-valid: any
# standard LZ4 block decoder reads them and vice versa.

_LZ4_MINMATCH = 4
_LZ4_MFLIMIT = 12
_LZ4_LASTLITERALS = 5


def lz4_block_compress(data: bytes) -> bytes:
    """Pure-Python LZ4 block encoder (greedy single-probe matcher — the
    same strategy as the native codec, byte-compatible output rules)."""
    n = len(data)
    if n == 0:
        return b"\x00"
    out = bytearray()
    table: dict[bytes, int] = {}
    anchor = 0
    pos = 0
    match_limit = n - _LZ4_MFLIMIT if n > _LZ4_MFLIMIT else 0

    def emit(lit_len: int, match_len: int, offset: int) -> None:
        ml = match_len - _LZ4_MINMATCH if match_len else 0
        token = (min(lit_len, 15) << 4) | (min(ml, 15) if match_len else 0)
        out.append(token)
        if lit_len >= 15:
            rest = lit_len - 15
            while rest >= 255:
                out.append(255)
                rest -= 255
            out.append(rest)
        out.extend(data[anchor : anchor + lit_len])
        if match_len:
            out.append(offset & 0xFF)
            out.append(offset >> 8)
            if ml >= 15:
                rest = ml - 15
                while rest >= 255:
                    out.append(255)
                    rest -= 255
                out.append(rest)

    while pos < match_limit:
        key = data[pos : pos + 4]
        cand = table.get(key)
        table[key] = pos
        if cand is not None and pos - cand <= 65535:
            mlen = _LZ4_MINMATCH
            max_ml = n - _LZ4_LASTLITERALS - pos
            while (
                mlen < max_ml and data[cand + mlen] == data[pos + mlen]
            ):
                mlen += 1
            emit(pos - anchor, mlen, pos - cand)
            pos += mlen
            anchor = pos
        else:
            pos += 1
    emit(n - anchor, 0, 0)
    return bytes(out)


def lz4_block_decompress(data: bytes, uncompressed_size: int) -> bytes:
    """Pure-Python LZ4 block decoder with full bounds validation."""
    ip, n = 0, len(data)
    out = bytearray()
    while ip < n:
        token = data[ip]
        ip += 1
        lit = token >> 4
        if lit == 15:
            while True:
                if ip >= n:
                    raise ExtensionError("malformed LZ4 block (literal len)")
                b = data[ip]
                ip += 1
                lit += b
                if b != 255:
                    break
        if ip + lit > n or len(out) + lit > uncompressed_size:
            raise ExtensionError("malformed LZ4 block (literal overrun)")
        out += data[ip : ip + lit]
        ip += lit
        if ip >= n:
            break  # last sequence: literals only
        if ip + 2 > n:
            raise ExtensionError("malformed LZ4 block (truncated offset)")
        offset = data[ip] | (data[ip + 1] << 8)
        ip += 2
        if offset == 0 or offset > len(out):
            raise ExtensionError("malformed LZ4 block (bad offset)")
        mlen = token & 0x0F
        if mlen == 15:
            while True:
                if ip >= n:
                    raise ExtensionError("malformed LZ4 block (match len)")
                b = data[ip]
                ip += 1
                mlen += b
                if b != 255:
                    break
        mlen += _LZ4_MINMATCH
        if len(out) + mlen > uncompressed_size:
            raise ExtensionError("malformed LZ4 block (match overrun)")
        start = len(out) - offset
        for i in range(mlen):  # may self-overlap (RLE): byte order matters
            out.append(out[start + i])
    if len(out) != uncompressed_size:
        raise ExtensionError(
            f"malformed LZ4 block: decoded {len(out)} of "
            f"{uncompressed_size} bytes"
        )
    return bytes(out)


def compress(data: bytes, algo: CompressionAlgorithm, level: int = 3) -> bytes:
    algo = CompressionAlgorithm(algo)
    if algo == CompressionAlgorithm.NONE:
        return data
    if algo == CompressionAlgorithm.ZLIB:
        return zlib.compress(data, level)
    if algo == CompressionAlgorithm.LZ4:
        from ..native import lz4_compress

        data = bytes(data)
        native = lz4_compress(data)
        return native if native is not None else lz4_block_compress(data)
    if algo == CompressionAlgorithm.ZSTD:
        try:
            import zstandard  # type: ignore
        except ImportError as exc:
            raise ExtensionError("Zstd codec not available in this environment") from exc
        return zstandard.ZstdCompressor(level=level).compress(data)
    raise ExtensionError(f"unknown compression algorithm {algo}")


def decompress(data: bytes, algo: CompressionAlgorithm, uncompressed_size: int) -> bytes:
    algo = CompressionAlgorithm(algo)
    if algo == CompressionAlgorithm.NONE:
        return data
    if algo == CompressionAlgorithm.ZLIB:
        return zlib.decompress(data)
    if algo == CompressionAlgorithm.LZ4:
        from ..native import lz4_decompress

        data = bytes(data)
        try:
            native = lz4_decompress(data, uncompressed_size)
        except ValueError as exc:
            raise ExtensionError(str(exc)) from exc
        if native is not None:
            return native
        return lz4_block_decompress(data, uncompressed_size)
    if algo == CompressionAlgorithm.ZSTD:
        try:
            import zstandard  # type: ignore
        except ImportError as exc:
            raise ExtensionError("Zstd codec not available in this environment") from exc
        return zstandard.ZstdDecompressor().decompress(
            data, max_output_size=uncompressed_size
        )
    raise ExtensionError(f"unknown compression algorithm {algo}")
