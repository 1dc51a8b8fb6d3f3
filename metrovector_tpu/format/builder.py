"""MVT write path: Builder → BuiltFile → Writer.

Capability parity with the reference write path (``src/builder.rs`` in
thegenem0/metrovector): named vector spaces (``add_vector_space``,
``src/builder.rs:113-135``), incremental vector appends with dimension
validation/auto-inference (``add_vectors``, ``src/builder.rs:151-196``),
columnar metadata with a deduplicating string heap (``add_metadata_column``,
``src/builder.rs:211-236``), fluent index configuration
(``VectorSpaceBuilderRef``, ``src/builder.rs:332-390``) and block layout with
per-block CRC32 (``build``, ``src/builder.rs:241-308``).

Differences by design:

* Blocks are **tile-padded** (see :mod:`.packing`) and 512-byte aligned so a
  space loads straight into a tile-shaped device array.
* ``save()`` streams blocks to the file instead of materializing the whole
  image twice in RAM (the reference duplicates the dataset in memory,
  ``README.md:131``).
* Squared L2 norms are precomputed per space into a sidecar block.
* Int8/UInt8 spaces accept float input and scalar-quantize it, recording
  scale/zero-point in the manifest (the reference can only encode
  Float32/Float16, ``src/builder.rs:175-192``).
* Tombstones are actually writable (``delete_vector``) — the reference
  declares the schema but always writes ``tombstones: None``
  (``src/builder.rs:485``).
"""

from __future__ import annotations

import io
import os
from typing import Any, BinaryIO, Iterable

import numpy as np

from ..errors import (
    BuildError,
    DimensionMismatchError,
    IndexOutOfBoundsError,
    InvalidFormatError,
    InvalidVectorTypeError,
    VectorSpaceNotFoundError,
)
from .constants import (
    BLOCK_ALIGN,
    FOOTER_LEN_SIZE,
    FORMAT_VERSION,
    MAGIC,
    CompressionAlgorithm,
    DataType,
    DistanceMetric,
    IndexKind,
    TombstoneFormat,
    VECTOR_DTYPES,
    VectorType,
    numpy_dtype,
)
from .manifest import (
    BlockInfo,
    ColumnInfo,
    IndexInfo,
    Manifest,
    QuantizationInfo,
    SpaceInfo,
    TombstoneInfo,
)
from .packing import (
    StringHeap,
    as_vector_array,
    compress,
    crc32,
    pack_block,
    squared_norms,
)


class _PendingColumn:
    def __init__(self, name: str, dtype: DataType):
        self.name = name
        self.dtype = dtype
        self.values: list[Any] = []


class _PendingSpace:
    def __init__(
        self,
        name: str,
        dim: int,
        vector_type: VectorType,
        metric: DistanceMetric,
        dtype: DataType,
        pad_dims: bool,
    ):
        self.name = name
        self.dim = dim
        self.vector_type = vector_type
        self.metric = metric
        self.dtype = dtype
        self.pad_dims = pad_dims
        self.chunks: list[np.ndarray] = []
        self.num_vectors = 0
        self.columns: dict[str, _PendingColumn] = {}
        self.heap = StringHeap()
        self.index = IndexInfo()
        self.quantization: QuantizationInfo | None = None
        self.deleted: set[int] = set()
        # Optional trained IVF structure: (centroids f32 [C,D], assignments
        # i32 [N]) persisted as data blocks at build.
        self.ivf_data: tuple[np.ndarray, np.ndarray] | None = None
        # Optional PQ sidecar: (codebooks f32 [m,ksub,dsub], codes u8
        # [N,m] (or [N,ceil(m/2)] nibble-packed), reconstruction squared
        # norms f32 [N], residual flag, packed4 flag).
        self.pq_data: (
            tuple[np.ndarray, np.ndarray, np.ndarray, bool, bool] | None
        ) = None
        # Optional HNSW graph: (layers [(ids i32, adj i32)], entry, m, efc).
        self.hnsw_data: tuple[list, int, int, int] | None = None
        # SPARSE accumulation (CSR pieces per appended row)
        self.sp_vals: list[np.ndarray] = []
        self.sp_cols: list[np.ndarray] = []
        self.sp_lens: list[int] = []
        # Optional stable external IDs (u64, one per row; reference
        # ``vector_ids_block_index``, ``schema/core.fbs:54``). Either
        # accumulated alongside add_vectors(ids=...) chunks or set
        # wholesale via set_vector_ids; validated complete+unique at build.
        self.id_chunks: list[np.ndarray] = []


class VectorSpaceHandle:
    """Fluent configuration handle returned by ``add_vector_space``
    (reference ``VectorSpaceBuilderRef``, ``src/builder.rs:332-390``)."""

    def __init__(self, builder: "Builder", name: str):
        self._builder = builder
        self.name = name

    def with_flat_index(self) -> "VectorSpaceHandle":
        self._space().index = IndexInfo(kind=IndexKind.FLAT)
        return self

    def with_ivf_index(self, num_clusters: int, nprobe: int = 8) -> "VectorSpaceHandle":
        self._space().index = IndexInfo(
            kind=IndexKind.IVF,
            params={"num_clusters": int(num_clusters), "nprobe": int(nprobe)},
        )
        return self

    def with_hnsw_index(self, m: int = 16, ef_construction: int = 200) -> "VectorSpaceHandle":
        self._space().index = IndexInfo(
            kind=IndexKind.HNSW,
            params={"m": int(m), "ef_construction": int(ef_construction)},
        )
        return self

    def with_quantization(self, scale: float, zero_point: float = 0.0) -> "VectorSpaceHandle":
        self._space().quantization = QuantizationInfo(
            scale=float(scale), zero_point=float(zero_point)
        )
        return self

    def add_vectors(self, data) -> "VectorSpaceHandle":
        self._builder.add_vectors(self.name, data)
        return self

    def _space(self) -> _PendingSpace:
        return self._builder._get_space(self.name)


class Builder:
    """Accumulates vector spaces and metadata in memory, then lays out the
    MVT file (reference ``MvfBuilder``, ``src/builder.rs:44-51,93-308``).

    Example (executed as a doctest — the analog of the reference's
    ``no_run`` examples on public items, ``src/builder.rs`` docs):

    >>> import numpy as np, tempfile, os
    >>> from metrovector_tpu import Builder, Reader
    >>> b = Builder()
    >>> _ = b.add_vector_space("embeddings", dim=4)
    >>> b.add_vectors("embeddings", np.arange(12, dtype=np.float32).reshape(3, 4))
    >>> path = os.path.join(tempfile.mkdtemp(), "demo.mvt")
    >>> b.build().save(path)
    >>> r = Reader.open(path)
    >>> r.vector_space("embeddings").num_vectors
    3
    """

    def __init__(self):
        self._spaces: dict[str, _PendingSpace] = {}
        self._hints: dict = {}
        self._extensions: dict[str, bytes] = {}
        self._security: dict = {}

    def set_hint(self, key: str, value) -> None:
        """Record a performance hint in the manifest. Unlike the reference's
        ``PerformanceHints`` table — declared but never read or written
        (``schema/extensions.fbs:80-84``, SURVEY.md §5) — MVT hints are
        consumed: ``stream_chunk_rows`` seeds
        :class:`~metrovector_tpu.parallel.streaming.StreamingSearcher`'s
        chunk size; unknown keys round-trip untouched."""
        self._hints[str(key)] = value

    def add_extension(self, name: str, data: bytes) -> None:
        """Attach an opaque named extension block (reference
        ``CustomExtension``, ``schema/extensions.fbs`` — declared there,
        never written by any code path; MVT stores the payload as a real
        CRC-checked block readable via ``Reader.extension``)."""
        if name in self._extensions:
            raise BuildError(f"extension {name!r} already exists")
        self._extensions[str(name)] = bytes(data)

    def set_security(self, **fields) -> None:
        """Record a declarative security descriptor in the manifest
        (reference security/encryption tables, ``schema/extensions.fbs``).
        Purely declarative in the reference and here: the descriptor
        round-trips verbatim; MVT does not encrypt blocks."""
        self._security.update(fields)

    # -- registration -------------------------------------------------------

    def add_vector_space(
        self,
        name: str,
        dim: int = 0,
        vector_type: VectorType = VectorType.DENSE,
        metric: DistanceMetric = DistanceMetric.L2,
        dtype: DataType = DataType.FLOAT32,
        pad_dims: bool = True,
    ) -> VectorSpaceHandle:
        """Register a named space. ``dim == 0`` auto-infers from the first
        ``add_vectors`` call (reference semantics, ``src/builder.rs:165-173``)."""
        if name in self._spaces:
            raise BuildError(f"vector space {name!r} already exists")
        dtype = DataType(dtype)
        if dtype not in VECTOR_DTYPES:
            raise InvalidVectorTypeError(
                f"{dtype.name} cannot be a vector space element type"
            )
        self._spaces[name] = _PendingSpace(
            name, int(dim), VectorType(vector_type), DistanceMetric(metric), dtype, pad_dims
        )
        return VectorSpaceHandle(self, name)

    def _get_space(self, name: str) -> _PendingSpace:
        try:
            return self._spaces[name]
        except KeyError:
            raise VectorSpaceNotFoundError(name) from None

    # -- data ---------------------------------------------------------------

    def add_vectors(self, name: str, data, ids=None) -> None:
        """Append rows to a space. Accepts any array-like of shape ``[N, D]``
        (or a list of row sequences). Float input into an int8/uint8 space is
        scalar-quantized: with explicit ``with_quantization`` params if set,
        else auto-calibrated symmetric (int8) / affine (uint8) on this chunk.

        ``ids``: optional stable external IDs (u64, one per appended row).
        If any chunk carries IDs, every chunk must — checked at build. IDs
        survive compaction, unlike row positions."""
        sp = self._get_space(name)
        if sp.vector_type == VectorType.SPARSE:
            raise InvalidVectorTypeError(
                f"space {name!r} is sparse; use add_sparse_vectors"
            )
        arr = np.asarray(data)
        if arr.ndim == 1 and arr.size:
            arr = arr.reshape(1, -1)
        if arr.ndim != 2:
            raise DimensionMismatchError(expected=max(sp.dim, 1), actual=arr.ndim)
        if sp.dim == 0:
            if arr.shape[1] == 0:
                raise BuildError("cannot infer dimension from empty vectors")
            sp.dim = int(arr.shape[1])
        if arr.shape[1] != sp.dim:
            raise DimensionMismatchError(expected=sp.dim, actual=int(arr.shape[1]))

        if sp.dtype in (DataType.INT8, DataType.UINT8) and np.issubdtype(
            arr.dtype, np.floating
        ):
            arr = self._quantize(sp, arr.astype(np.float32))
        rows = as_vector_array(arr, sp.dim, sp.dtype)
        if ids is not None:
            id_arr = np.ascontiguousarray(np.asarray(ids), dtype="<u8").reshape(-1)
            if id_arr.shape[0] != rows.shape[0]:
                raise BuildError(
                    f"ids length {id_arr.shape[0]} != rows appended "
                    f"{rows.shape[0]} for space {name!r}"
                )
            sp.id_chunks.append(id_arr)
        sp.chunks.append(rows)
        sp.num_vectors += int(rows.shape[0])

    def set_vector_ids(self, name: str, ids) -> None:
        """Replace a space's stable external IDs wholesale (u64, one per
        row already appended — call after the data). Equivalent to passing
        ``ids=`` on every ``add_vectors`` call."""
        sp = self._get_space(name)
        id_arr = np.ascontiguousarray(np.asarray(ids), dtype="<u8").reshape(-1)
        if id_arr.shape[0] != sp.num_vectors:
            raise BuildError(
                f"ids length {id_arr.shape[0]} != space {name!r} row count "
                f"{sp.num_vectors}"
            )
        sp.id_chunks = [id_arr]

    @staticmethod
    def _quantize(sp: _PendingSpace, arr: np.ndarray) -> np.ndarray:
        if sp.quantization is None:
            if sp.dtype == DataType.INT8:
                scale = float(np.max(np.abs(arr))) / 127.0 or 1.0
                zp = 0.0
            else:  # UINT8 affine
                lo, hi = float(arr.min(initial=0.0)), float(arr.max(initial=0.0))
                scale = (hi - lo) / 255.0 or 1.0
                zp = -lo / scale
            sp.quantization = QuantizationInfo(scale=scale, zero_point=zp)
        q = sp.quantization
        scaled = np.rint(arr / q.scale + q.zero_point)
        if sp.dtype == DataType.INT8:
            return np.clip(scaled, -128, 127).astype(np.int8)
        return np.clip(scaled, 0, 255).astype(np.uint8)

    def add_sparse_vectors(self, name: str, rows) -> None:
        """Append sparse rows to a SPARSE space. ``rows`` is an iterable of
        ``(cols, vals)`` pairs (integer column ids, element values); columns
        must be < the space's dim (auto-inferred as max col + 1 when dim is
        0 at build). The reference declares ``VectorType::Sparse`` but can
        neither encode nor read it (``src/builder.rs:175-192``); MVT stores
        CSR blocks and searches them by densifying tiles into matmuls."""
        sp = self._get_space(name)
        if sp.vector_type != VectorType.SPARSE:
            raise InvalidVectorTypeError(
                f"space {name!r} is dense; use add_vectors"
            )
        np_dt = numpy_dtype(sp.dtype)
        for cols, vals in rows:
            cols = np.ascontiguousarray(cols, dtype="<u4")
            vals = np.ascontiguousarray(vals, dtype=np_dt)
            if cols.shape != vals.shape or cols.ndim != 1:
                raise DimensionMismatchError(
                    expected=int(cols.size), actual=int(vals.size)
                )
            if sp.dim and cols.size and int(cols.max()) >= sp.dim:
                raise IndexOutOfBoundsError(int(cols.max()), sp.dim)
            order = np.argsort(cols, kind="stable")
            sp.sp_cols.append(cols[order])
            sp.sp_vals.append(vals[order])
            sp.sp_lens.append(int(cols.size))
            sp.num_vectors += 1

    def add_metadata_column(
        self,
        space_name: str,
        column_name: str,
        values: Iterable[Any],
        dtype: DataType | None = None,
    ) -> None:
        """Attach a columnar metadata column (reference
        ``add_metadata_column``, ``src/builder.rs:211-236``). Strings go to
        the space's dedup'ing heap as ``STRING_REF``; numeric values are
        stored as raw little-endian arrays."""
        sp = self._get_space(space_name)
        vals = list(values)
        if dtype is None:
            dtype = _infer_column_dtype(vals)
        dtype = DataType(dtype)
        if column_name in sp.columns:
            raise BuildError(
                f"metadata column {column_name!r} already exists in {space_name!r}"
            )
        col = _PendingColumn(column_name, dtype)
        col.values = vals
        sp.columns[column_name] = col

    def extend_metadata_column(
        self,
        space_name: str,
        column_name: str,
        values: Iterable[Any],
    ) -> None:
        """Append values to an existing metadata column — the column-side
        half of the append workflow (:func:`..format.compact.builder_from_reader`);
        dtype stays as declared."""
        sp = self._get_space(space_name)
        if column_name not in sp.columns:
            raise BuildError(
                f"metadata column {column_name!r} does not exist in "
                f"{space_name!r}; use add_metadata_column first"
            )
        sp.columns[column_name].values.extend(list(values))

    def set_ivf_index(
        self,
        space_name: str,
        centroids: np.ndarray,
        assignments: np.ndarray,
        nprobe: int = 8,
    ) -> None:
        """Attach a trained IVF structure (e.g. from
        :func:`metrovector_tpu.index.train_kmeans`) so readers can probe
        without retraining. Persists centroids and per-row assignments as
        real data blocks — the capability the reference's writer stubs out
        with a bogus block index (``src/builder.rs:438-447``)."""
        sp = self._get_space(space_name)
        centroids = np.ascontiguousarray(centroids, dtype="<f4")
        assignments = np.ascontiguousarray(assignments, dtype="<i4")
        if sp.dim and centroids.shape[1] != sp.dim:
            raise DimensionMismatchError(expected=sp.dim, actual=centroids.shape[1])
        if assignments.shape[0] != sp.num_vectors:
            raise BuildError(
                f"assignments cover {assignments.shape[0]} rows, space has "
                f"{sp.num_vectors}"
            )
        sp.ivf_data = (centroids, assignments)
        sp.index = IndexInfo(
            kind=IndexKind.IVF,
            params={
                "num_clusters": int(centroids.shape[0]),
                "nprobe": int(nprobe),
            },
        )

    def set_pq_index(
        self,
        space_name: str,
        codebooks: np.ndarray,
        codes: np.ndarray,
        recon_norms: np.ndarray | None = None,
        residual: bool = False,
        packed4: bool = False,
    ) -> None:
        """Attach a trained product-quantization sidecar (e.g. from
        :func:`metrovector_tpu.index.train_pq` / ``encode_pq``) so readers
        can ADC-search without retraining or re-encoding. The reference
        declares PQ codebook tables in its extensions schema
        (``schema/extensions.fbs``) but never writes them; MVT persists
        codebooks, codes and reconstruction norms as real blocks.
        ``packed4``: the codes are nibble-packed 4-bit PQ
        (``[N, ⌈m/2⌉]`` u8, ``ksub ≤ 16`` — half the bytes per row; see
        :func:`metrovector_tpu.index.pq.pack_codes4`)."""
        sp = self._get_space(space_name)
        codebooks = np.ascontiguousarray(codebooks, dtype="<f4")
        if codebooks.ndim != 3:
            raise BuildError("codebooks must have shape [m, ksub, dsub]")
        m, ksub, dsub = codebooks.shape
        if ksub > 256:
            raise BuildError("ksub > 256 does not fit uint8 codes")
        if packed4 and ksub > 16:
            raise BuildError("packed4 requires ksub <= 16")
        if sp.dim and m * dsub != sp.dim:
            raise DimensionMismatchError(expected=sp.dim, actual=m * dsub)
        codes = np.ascontiguousarray(codes, dtype=np.uint8)
        code_cols = (m + 1) // 2 if packed4 else m
        if codes.shape != (sp.num_vectors, code_cols):
            raise BuildError(
                f"codes shape {codes.shape} != ({sp.num_vectors}, {code_cols})"
            )
        if recon_norms is None:
            dec = codes
            if packed4:
                dec = np.empty((codes.shape[0], 2 * codes.shape[1]), np.uint8)
                dec[:, 0::2] = codes & 15
                dec[:, 1::2] = codes >> 4
                dec = dec[:, :m]
            recon = np.empty((codes.shape[0], m * dsub), np.float64)
            for j in range(m):
                recon[:, j * dsub : (j + 1) * dsub] = codebooks[j, dec[:, j]]
            if residual:
                # Full reconstruction x̂ = centroid + decoded residual: needs
                # the coarse quantizer persisted via set_ivf_index first.
                if sp.ivf_data is None:
                    raise BuildError(
                        "residual PQ norms require set_ivf_index first "
                        "(or pass recon_norms explicitly)"
                    )
                cent, assign = sp.ivf_data
                recon += cent.astype(np.float64)[assign]
            recon_norms = np.einsum("ij,ij->i", recon, recon).astype("<f4")
        recon_norms = np.ascontiguousarray(recon_norms, dtype="<f4")
        if recon_norms.shape != (sp.num_vectors,):
            raise BuildError(
                f"recon_norms shape {recon_norms.shape} != ({sp.num_vectors},)"
            )
        sp.pq_data = (codebooks, codes, recon_norms, bool(residual),
                      bool(packed4))

    def set_hnsw_index(
        self,
        space_name: str,
        layers: list,
        entry: int,
        m: int = 16,
        ef_construction: int = 200,
    ) -> None:
        """Attach a built HNSW graph (e.g. from
        :meth:`metrovector_tpu.index.HNSWIndex.build`: pass
        ``index.layers``, ``index.entry``, …) so readers can search without
        rebuilding. ``layers``: bottom-up list of ``(ids [N_L] i32,
        adj [N_L, width] i32)``. The reference's writer stores
        ``graph_block_index: 0`` with a TODO and never builds a graph
        (``src/builder.rs:459``); MVT persists real per-layer blocks."""
        sp = self._get_space(space_name)
        norm_layers = []
        for ids, adj in layers:
            ids = np.ascontiguousarray(ids, "<i4")
            adj = np.ascontiguousarray(adj, "<i4")
            if adj.shape[0] != ids.shape[0]:
                raise BuildError(
                    f"layer ids/adj row mismatch: {ids.shape[0]} vs {adj.shape[0]}"
                )
            if ids.size and int(ids.max()) >= sp.num_vectors:
                raise IndexOutOfBoundsError(int(ids.max()), sp.num_vectors)
            norm_layers.append((ids, adj))
        sp.hnsw_data = (norm_layers, int(entry), int(m), int(ef_construction))
        sp.index = IndexInfo(
            kind=IndexKind.HNSW,
            params={"m": int(m), "ef_construction": int(ef_construction)},
        )

    def delete_vector(self, space_name: str, index: int) -> None:
        """Mark a row deleted; emitted as a BITMAP tombstone block at build.
        The reference declares tombstones but never writes them
        (``src/builder.rs:485``)."""
        sp = self._get_space(space_name)
        if index < 0 or index >= sp.num_vectors:
            raise IndexOutOfBoundsError(index, sp.num_vectors)
        sp.deleted.add(int(index))

    # -- layout -------------------------------------------------------------

    def build(
        self,
        compression: CompressionAlgorithm = CompressionAlgorithm.NONE,
        compression_level: int = 3,
    ) -> "BuiltFile":
        """Lay out all blocks, compute offsets and CRCs, produce the footer
        (reference ``build``, ``src/builder.rs:241-308``)."""
        if not self._spaces:
            raise BuildError("cannot build an MVT file with no vector spaces")
        manifest = Manifest(version=FORMAT_VERSION)
        payloads: list[bytes | np.ndarray] = []
        offset = len(MAGIC)
        compression = CompressionAlgorithm(compression)

        def push_block(data, compressible: bool = True,
                       precomputed_crc: int | None = None) -> int:
            nonlocal offset
            if compression == CompressionAlgorithm.NONE and isinstance(
                data, np.ndarray
            ):
                # Zero-copy fast path: ndarray payloads are written directly
                # (BuiltFile.write_to streams buffers); CRC may come fused
                # from the native codec's packing pass.
                stored = data
                raw_len = data.nbytes
                algo = CompressionAlgorithm.NONE
                crc = precomputed_crc if precomputed_crc is not None else crc32(
                    data.reshape(-1).view(np.uint8)
                )
            else:
                raw = data.tobytes() if isinstance(data, np.ndarray) else bytes(data)
                raw_len = len(raw)
                algo = compression if compressible else CompressionAlgorithm.NONE
                stored = compress(raw, algo, compression_level)
                if len(stored) >= len(raw):
                    algo, stored = CompressionAlgorithm.NONE, raw
                crc = crc32(stored)
            stored_len = stored.nbytes if isinstance(stored, np.ndarray) else len(stored)
            pad = (-offset) % BLOCK_ALIGN
            if pad:
                payloads.append(b"\x00" * pad)
                offset += pad
            info = BlockInfo(
                offset=offset,
                size=stored_len,
                crc32=crc,
                compression=algo,
                uncompressed_size=raw_len,
            )
            manifest.blocks.append(info)
            payloads.append(stored)
            offset += stored_len
            return len(manifest.blocks) - 1

        total_logical = 0
        for sp in self._spaces.values():
            if sp.vector_type == VectorType.SPARSE:
                info = self._build_sparse_space(sp, push_block)
                self._finish_space(sp, info, push_block)
                manifest.spaces.append(info)
                total_logical += sp.num_vectors
                continue
            rows = (
                np.concatenate(sp.chunks, axis=0)
                if sp.chunks
                else np.zeros((0, max(sp.dim, 1)), dtype=numpy_dtype(sp.dtype))
            )
            q = sp.quantization
            scale = q.scale if q else 1.0
            zp = q.zero_point if q else 0.0
            # Fused native pack+norms+CRC (single memory pass); numpy
            # fallback does the same work in three passes. Norms are stored
            # in *dequantized* value space so L2/cosine epilogues can use
            # them directly for any element type.
            from ..native import pack_block_fused

            fused = None
            if compression == CompressionAlgorithm.NONE and rows.size:
                from .constants import padded_dim_for, padded_rows_for

                fused = pack_block_fused(
                    rows,
                    padded_rows_for(rows.shape[0], sp.dtype),
                    padded_dim_for(sp.dim, sp.pad_dims),
                    int(sp.dtype),
                    scale,
                    zp,
                )
            if fused is not None:
                block, norms, crc = fused
                pr, pd = block.shape
                vec_block = push_block(block, precomputed_crc=crc)
            else:
                block, pr, pd = pack_block(rows, sp.dtype, sp.pad_dims)
                vec_block = push_block(block)
                norms = np.zeros(pr, dtype="<f4")
                if rows.size:
                    if q is not None:
                        deq = (rows.astype(np.float32) - zp) * scale
                        norms[: rows.shape[0]] = squared_norms(deq)
                    else:
                        norms[: rows.shape[0]] = squared_norms(rows)
            norms_block = push_block(norms)

            info = SpaceInfo(
                name=sp.name,
                dim=sp.dim,
                num_vectors=sp.num_vectors,
                dtype=sp.dtype,
                vector_type=sp.vector_type,
                metric=sp.metric,
                padded_dim=pd,
                padded_rows=pr,
                vectors_block=vec_block,
                norms_block=norms_block,
                index=sp.index,
                quantization=sp.quantization,
            )

            self._finish_space(sp, info, push_block)
            manifest.spaces.append(info)
            total_logical += sp.num_vectors

        for name, data in self._extensions.items():
            manifest.extensions[name] = push_block(data)

        # File statistics (reference ``FileStatistics``,
        # ``schema/extensions.fbs`` — declared, never populated; MVT fills
        # them in at every build).
        manifest.stats = {
            "num_spaces": len(manifest.spaces),
            "num_blocks": len(manifest.blocks),
            "total_vectors": total_logical,
            "deleted_vectors": sum(len(s.deleted) for s in self._spaces.values()),
            "data_bytes": offset - len(MAGIC),
            "per_space": {
                s.name: {
                    "vectors": s.num_vectors,
                    "dim": s.dim,
                    "dtype": int(s.dtype),
                }
                for s in self._spaces.values()
            },
        }
        manifest.hints = dict(self._hints)
        manifest.security = dict(self._security)
        # Declare the oldest reader able to open this file: v2 is only
        # required when a v2 feature (stable vector IDs) is present.
        manifest.compat_version = (
            2 if any(s.ids_block >= 0 for s in manifest.spaces) else 1
        )
        return BuiltFile(manifest, payloads)

    @staticmethod
    def _build_sparse_space(sp: _PendingSpace, push_block) -> SpaceInfo:
        """Lay out one SPARSE space: CSR values/cols/indptr blocks plus the
        per-row squared-norms sidecar (computed from the values)."""
        from .manifest import SparseInfo

        np_dt = numpy_dtype(sp.dtype)
        vals = (
            np.concatenate(sp.sp_vals) if sp.sp_vals else np.zeros(0, np_dt)
        )
        cols = (
            np.concatenate(sp.sp_cols) if sp.sp_cols else np.zeros(0, "<u4")
        )
        indptr = np.zeros(sp.num_vectors + 1, dtype="<u8")
        if sp.sp_lens:
            indptr[1:] = np.cumsum(sp.sp_lens, dtype=np.uint64)
        if sp.dim == 0:
            sp.dim = int(cols.max()) + 1 if cols.size else 1
        # per-row dequantized squared norms via reduceat over the CSR runs
        sq = np.square(vals.astype(np.float64))
        norms = np.zeros(max(sp.num_vectors, 1), dtype="<f4")
        if vals.size and sp.num_vectors:
            # sentinel keeps reduceat in-bounds when TRAILING rows are
            # empty (their start index == nnz); empty-row slots are
            # zeroed below either way (fuzzer finding, seed 2009)
            sq = np.append(sq, 0.0)
            sums = np.add.reduceat(sq, indptr[:-1].astype(np.int64))
            sums[np.diff(indptr.astype(np.int64)) == 0] = 0.0
            norms[: sp.num_vectors] = sums.astype(np.float32)

        vb = push_block(vals)
        cb = push_block(cols)
        ib = push_block(indptr)
        nb = push_block(norms)
        return SpaceInfo(
            name=sp.name,
            dim=sp.dim,
            num_vectors=sp.num_vectors,
            dtype=sp.dtype,
            vector_type=sp.vector_type,
            metric=sp.metric,
            padded_dim=0,
            padded_rows=max(sp.num_vectors, 1),
            vectors_block=-1,
            norms_block=nb,
            index=sp.index,
            quantization=sp.quantization,
            sparse=SparseInfo(
                values_block=vb, cols_block=cb, indptr_block=ib,
                nnz=int(vals.size),
            ),
        )

    @staticmethod
    def _finish_space(sp: _PendingSpace, info: SpaceInfo, push_block) -> None:
        """Shared space tail: IVF blocks, metadata columns, string heap,
        tombstones."""
        if sp.ivf_data is not None:
            cb = push_block(sp.ivf_data[0])
            ab = push_block(sp.ivf_data[1])
            info.index.params["centroids_block"] = cb
            info.index.params["assignments_block"] = ab

        if sp.hnsw_data is not None:
            layers, entry, m, efc = sp.hnsw_data
            layer_meta = []
            for ids, adj in layers:
                layer_meta.append(
                    {
                        "ids_block": push_block(ids),
                        "adj_block": push_block(adj),
                        "count": int(ids.shape[0]),
                        "width": int(adj.shape[1]),
                    }
                )
            info.index.params.update(
                {"entry": entry, "m": m, "ef_construction": efc,
                 "layers": layer_meta}
            )

        if sp.pq_data is not None:
            from .manifest import PQInfo

            books, codes, rnorms, residual, packed4 = sp.pq_data
            info.pq = PQInfo(
                m=int(books.shape[0]),
                ksub=int(books.shape[1]),
                dsub=int(books.shape[2]),
                codebooks_block=push_block(books),
                codes_block=push_block(codes),
                recon_norms_block=push_block(rnorms),
                residual=residual,
                packed4=packed4,
            )

        for col in sp.columns.values():
            if len(col.values) != sp.num_vectors:
                # A short column silently corrupts later rebuilds (vals[keep]
                # index errors in compaction; string columns truncate) — the
                # append workflow makes this mistake easy, so fail at build.
                raise BuildError(
                    f"metadata column {col.name!r} in space {sp.name!r} has "
                    f"{len(col.values)} values for {sp.num_vectors} rows; "
                    "append with extend_metadata_column to keep them aligned"
                )
            data = _encode_column(col, sp.heap)
            cb = push_block(data)
            info.columns.append(
                ColumnInfo(
                    name=col.name, dtype=col.dtype, block=cb, count=len(col.values)
                )
            )
        if len(sp.heap):
            info.string_heap_block = push_block(sp.heap.to_bytes())
        if sp.id_chunks:
            ids = np.concatenate(sp.id_chunks).astype("<u8", copy=False)
            if ids.shape[0] != sp.num_vectors:
                raise BuildError(
                    f"space {sp.name!r} has ids for {ids.shape[0]} of "
                    f"{sp.num_vectors} rows; pass ids= on every add_vectors "
                    "call or use set_vector_ids"
                )
            if np.unique(ids).shape[0] != ids.shape[0]:
                raise BuildError(f"space {sp.name!r} vector ids are not unique")
            info.ids_block = push_block(ids)
        if sp.deleted:
            # Two persisted tombstone encodings, like the reference schema
            # (``schema/types.fbs:35-39``): a sorted u32 id list when
            # deletions are sparse enough that it is smaller than the
            # bitmap (4·count < rows/8), else one bit per row.
            idx = np.sort(np.fromiter(sp.deleted, dtype=np.int64))
            if 4 * len(sp.deleted) < (sp.num_vectors + 7) // 8:
                tb = push_block(idx.astype("<u4"))
                fmt = TombstoneFormat.SORTED_LIST
            else:
                bitmap = np.zeros((sp.num_vectors + 7) // 8, dtype=np.uint8)
                np.bitwise_or.at(
                    bitmap, idx // 8, (1 << (idx % 8)).astype(np.uint8)
                )
                tb = push_block(bitmap)
                fmt = TombstoneFormat.BITMAP
            info.tombstones = TombstoneInfo(
                format=fmt, block=tb, count=len(sp.deleted)
            )


def _infer_column_dtype(vals: list[Any]) -> DataType:
    if any(isinstance(v, (str, bytes)) for v in vals):
        return DataType.STRING_REF
    if any(isinstance(v, float) for v in vals):
        return DataType.FLOAT32
    arr = np.asarray(vals)
    if arr.dtype == np.int64 and (arr.size == 0 or (arr >= -(2**31)).all() and (arr < 2**31).all()):
        return DataType.INT32
    return {
        np.dtype(np.int32): DataType.INT32,
        np.dtype(np.int64): DataType.INT64,
        np.dtype(np.uint32): DataType.UINT32,
        np.dtype(np.uint64): DataType.UINT64,
        np.dtype(np.float32): DataType.FLOAT32,
        np.dtype(np.float64): DataType.FLOAT64,
    }.get(arr.dtype, DataType.FLOAT32)


def _encode_column(col: _PendingColumn, heap: StringHeap) -> np.ndarray:
    if col.dtype == DataType.STRING_REF:
        offs = np.empty(len(col.values), dtype="<u4")
        for i, v in enumerate(col.values):
            if isinstance(v, bytes):
                v = v.decode("utf-8")
            offs[i] = heap.add(str(v))
        return offs
    return np.ascontiguousarray(col.values, dtype=numpy_dtype(col.dtype))


class BuiltFile:
    """A laid-out MVT image ready to serialize (reference ``BuiltMvf``,
    ``src/builder.rs:395-417``)."""

    def __init__(self, manifest: Manifest, payloads: list):
        self.manifest = manifest
        self._payloads = payloads

    def write_to(self, f: BinaryIO) -> int:
        """Stream the file image: magic ‖ blocks ‖ footer ‖ u32 len ‖ magic
        (envelope per reference ``to_bytes``, ``src/builder.rs:417-558``)."""
        written = f.write(MAGIC)
        for p in self._payloads:
            if isinstance(p, np.ndarray):
                # C-contiguous arrays stream via the buffer protocol, no copy.
                written += f.write(p.reshape(-1).view(np.uint8).data)
            else:
                written += f.write(p)
        footer = self.manifest.to_bytes()
        written += f.write(footer)
        written += f.write(len(footer).to_bytes(FOOTER_LEN_SIZE, "little"))
        written += f.write(MAGIC)
        return written

    def to_bytes(self) -> bytes:
        buf = io.BytesIO()
        self.write_to(buf)
        return buf.getvalue()

    def save(self, path: str | os.PathLike) -> None:
        with open(path, "wb") as f:
            self.write_to(f)
            f.flush()
            os.fsync(f.fileno())


class Writer:
    """Trivial file sink (reference ``MvfWriter``, ``src/io.rs:20-47``)."""

    def __init__(self, path: str | os.PathLike):
        self.path = os.fspath(path)

    @classmethod
    def create(cls, path: str | os.PathLike) -> "Writer":
        return cls(path)

    def write(self, built: BuiltFile) -> None:
        built.save(self.path)


def _merge_hints(dst: dict, src: dict) -> None:
    for key, value in src.items():
        if isinstance(value, dict) and isinstance(dst.get(key), dict):
            _merge_hints(dst[key], value)
        else:
            dst[key] = value


def rewrite_hints(path: str | os.PathLike, updates: dict[str, Any]) -> None:
    """Merge ``updates`` into an existing file's ``PerformanceHints``
    manifest table by rewriting only the footer, in place — data blocks
    (and their per-block CRCs) are untouched, so
    ``Reader.validate_with_checksum`` still passes afterwards.

    The persistence half of autotuning: tuned kernel tilings
    (``SearchEngine.autotune(persist=True)``, ``PQIndex.autotune``,
    ``SparseSearchEngine.autotune``) land under ``hints["tuned"][space]``
    and engines reattached from the file adopt them by default — the same
    consume-from-hints pattern as ``stream_chunk_rows``
    (``parallel/streaming.py``). Merge is recursive: dict values merge
    key-wise at every depth (so tuning one space keeps other spaces'
    entries, and one kernel family's tilings keep its siblings' —
    ``test_rewrite_hints_merges_recursively``), everything else
    replaces.

    Reference anchor: the ``PerformanceHints`` table exists in the schema
    (``schema/core.fbs``) but the reference never reads or writes it.

    Not safe concurrently with a writer of the same file; readers holding
    the old mmap keep serving the old footer (their data views are
    unaffected — blocks don't move)."""
    from .constants import MAGIC_LEN, MIN_FILE_SIZE

    path = os.fspath(path)
    with open(path, "r+b") as f:
        size = os.fstat(f.fileno()).st_size
        if size < MIN_FILE_SIZE:
            raise InvalidFormatError(
                f"file too small to be MVT ({size} bytes)"
            )
        f.seek(size - MAGIC_LEN)
        if f.read(MAGIC_LEN) != MAGIC:
            raise InvalidFormatError("bad end magic (truncated or corrupt file)")
        flen_off = size - MAGIC_LEN - FOOTER_LEN_SIZE
        f.seek(flen_off)
        footer_len = int.from_bytes(f.read(FOOTER_LEN_SIZE), "little")
        footer_start = flen_off - footer_len
        if footer_len <= 0 or footer_start < MAGIC_LEN:
            raise InvalidFormatError(
                f"footer length {footer_len} out of bounds for file of "
                f"{size} bytes"
            )
        f.seek(footer_start)
        manifest = Manifest.from_bytes(f.read(footer_len))
        _merge_hints(manifest.hints, updates)
        footer = manifest.to_bytes()
        f.seek(footer_start)
        f.write(footer)
        f.write(len(footer).to_bytes(FOOTER_LEN_SIZE, "little"))
        f.write(MAGIC)
        f.truncate()
        f.flush()
        os.fsync(f.fileno())
