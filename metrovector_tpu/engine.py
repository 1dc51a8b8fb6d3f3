"""High-level query engine: load a space into device memory and search it.

The accelerator replacement for the reference's application layer
(`examples/simple.rs:74-103`, `examples/similarity_search.rs:111-176` in
thegenem0/metrovector): instead of a per-query scalar scan, a
:class:`DeviceSpace` holds the tile-padded corpus resident on the device and
every search is one jitted blocked matmul + top-k scan
(:func:`~.ops.distances.exact_topk`).

Load path: the on-disk block layout equals the device tiling, so upload is
``device_put(space.padded_array())`` — no host-side transpose or decode
(SURVEY.md §7 "zero-copy load path").
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from .errors import (
    DimensionMismatchError,
    IndexOutOfBoundsError,
    InvalidVectorTypeError,
    VectorIdNotFoundError,
)
from .format.constants import DataType, DistanceMetric, numpy_dtype
from .format.reader import Reader
from .ops.distances import (
    DEFAULT_BLOCK_ROWS,
    distances_np,
    exact_topk,
    rescore_topk,
)
from .utils.transfer import put_chunked
from .utils.tune import block_rows_around, measure_candidates
from .vectors.space import VectorSpace


@dataclasses.dataclass
class SearchResult:
    """Top-k results for a query batch.

    ``indices``: ``[Q, k]`` int32 row ids (−1 only if k > corpus size).
    ``scores``: ``[Q, k]`` f32 internal greater-is-better scores.
    ``distances``: the user-facing quantity per metric — Euclidean distance
    for L2 (ascending), cosine similarity / dot product (descending) —
    matching the reference's ``find_top_k_similar`` output convention
    (`examples/similarity_search.rs:140-176`).
    """

    indices: np.ndarray
    scores: np.ndarray
    distances: np.ndarray
    metric: DistanceMetric
    # Stable external IDs ``[Q, k]`` u64 — the space's ID column gathered at
    # the result rows (the row positions themselves when the space has no
    # ID column). Unfilled slots hold the u64 sentinel 2**64−1. Unlike
    # ``indices``, these stay valid across compaction.
    ids: np.ndarray | None = None

    ID_SENTINEL = np.uint64(2**64 - 1)

    def __len__(self) -> int:
        return self.indices.shape[0]

    def top(self, query: int = 0) -> list[tuple[int, float]]:
        """(index, distance) pairs for one query, best first."""
        return [
            (int(i), float(d))
            for i, d in zip(self.indices[query], self.distances[query])
            if i >= 0
        ]


@dataclasses.dataclass
class RadiusResult:
    """Variable-length range-query results (``search_radius``): per query,
    every row within the threshold, best-first. ``truncated[q]`` is True
    when the capped candidate list filled up with rows that ALL met the
    threshold — more matches may exist; retry with a larger
    ``max_results``."""

    indices: list[np.ndarray]
    distances: list[np.ndarray]
    ids: list[np.ndarray] | None
    metric: DistanceMetric
    truncated: np.ndarray  # [Q] bool

    def __len__(self) -> int:
        return len(self.indices)


def radius_from_topk(res: SearchResult, radius: float,
                     max_results: int, num_valid: int | None = None) -> RadiusResult:
    """Cut a best-first top-``max_results`` result down to the rows within
    ``radius``. Thresholds follow each metric's user-facing distance
    convention: L2 keeps ``distance <= radius`` (ascending), cosine/IP
    keep ``similarity >= radius`` (descending). Shared by the dense and
    sparse engines.

    ``num_valid`` is the searchable (non-tombstoned) row count: when the
    capped candidate list already covered the whole corpus
    (``max_results >= num_valid``), no further matches can exist and
    ``truncated`` stays False even if every row met the threshold."""
    ascending = res.metric == DistanceMetric.L2
    idx, dist, ids = [], [], ([] if res.ids is not None else None)
    nq = res.indices.shape[0]
    truncated = np.zeros(nq, bool)
    capped = num_valid is None or max_results < num_valid
    for q in range(nq):
        live = res.indices[q] >= 0
        ok = live & (
            (res.distances[q] <= radius) if ascending
            else (res.distances[q] >= radius)
        )
        idx.append(res.indices[q][ok])
        dist.append(res.distances[q][ok])
        if ids is not None:
            ids.append(res.ids[q][ok])
        truncated[q] = capped and bool(ok.all()) and int(ok.sum()) == max_results
    return RadiusResult(indices=idx, distances=dist, ids=ids,
                        metric=res.metric, truncated=truncated)



def merged_append_ids(host_ids, ids, n_new: int, num_valid: int):
    """Validate and merge the ID column for an append of ``n_new`` rows.

    Shared contract across every mutable surface (``DeviceSpace`` and the
    ANN indexes): appends must carry ``ids`` iff the structure has an ID
    column (mixing positional and stable identities would silently corrupt
    external references); merged ids must stay unique. Returns the new
    host ID column (or None for position-identified structures)."""
    if ids is not None:
        ids = np.ascontiguousarray(ids, dtype=np.uint64).reshape(-1)
        if ids.shape[0] != n_new:
            raise DimensionMismatchError(expected=n_new, actual=int(ids.shape[0]))
        if host_ids is None and num_valid > 0:
            raise InvalidVectorTypeError(
                "space has no ID column; appended rows cannot carry ids"
            )
    elif host_ids is not None:
        raise InvalidVectorTypeError(
            "space has an ID column; appended rows must carry ids"
        )
    else:
        return None
    old = host_ids if host_ids is not None else np.zeros(0, np.uint64)
    merged = np.concatenate([old[:num_valid], ids])
    if np.unique(merged).shape[0] != merged.shape[0]:
        raise InvalidVectorTypeError("appended ids collide")
    return merged


def ids_for_rows(host_ids, idx):
    """Translate result row positions to stable external IDs (positions
    themselves when the space has no ID column; the u64-max sentinel for
    unfilled slots). Shared by the single-chip engine and every parallel
    searcher."""
    if host_ids is not None:
        ids = host_ids[np.clip(idx, 0, None)].astype(np.uint64)
    else:
        ids = idx.astype(np.int64).astype(np.uint64)
    ids[idx < 0] = SearchResult.ID_SENTINEL
    return ids


@dataclasses.dataclass
class PreparedFilter:
    """A row-predicate mask pre-uploaded to the device, reusable across
    searches (see :meth:`SearchEngine.prepare_filter`). ``mask`` is the
    padded ``[data_rows]`` f32 validity plane (1.0 = searchable); it is
    composed with the space's live tombstone mask at launch time, so
    deletions made after preparation are still honored."""

    mask: jax.Array
    num_valid: int  # logical row count the mask was prepared against


@dataclasses.dataclass
class PreparedQueries:
    """Device-ready query batch plus the scalars needed to interpret raw
    scan dots (see :meth:`DeviceSpace.prepare_queries`)."""

    qdev: jax.Array
    sq_norms: np.ndarray  # ‖q‖² of the original float queries
    dot_scale: float = 1.0  # static multiplier on raw (integer) dots
    bias_scale: float = 0.0  # dynamic multiplier on the per-row code sums
    const: np.ndarray | None = None  # per-query additive dot constant C(q)


class DeviceSpace:
    """One vector space resident on device(s): the corpus block, its
    dequantized squared norms, and an optional validity mask, all as jax
    arrays ready for the scan."""

    def __init__(
        self,
        data: jax.Array,
        norms: jax.Array,
        num_valid: int,
        dim: int,
        metric: DistanceMetric,
        valid_mask: jax.Array | None = None,
        scale: float = 1.0,
        zero_point: float = 0.0,
        dtype: DataType = DataType.FLOAT32,
        name: str = "",
        rowsums: jax.Array | None = None,
        precision: str = "highest",
        host_ids: np.ndarray | None = None,
    ):
        self.data = data
        self.norms = norms
        self.num_valid = num_valid
        self.dim = dim
        self.metric = DistanceMetric(metric)
        self.valid_mask = valid_mask
        self.scale = float(scale)
        self.zero_point = float(zero_point)
        self.dtype = DataType(dtype)
        self.name = name
        # uint8 offset path: per-row sums of the shifted int8 codes
        # (Σ(c−128) over logical dims), consumed as the scan's bias_row.
        self.rowsums = rowsums
        self.precision = precision
        # Host-side stable ID column (u64), used only to translate result
        # row positions back to external IDs — never shipped to the device.
        self.host_ids = host_ids
        self._id_lut: dict | None = None  # lazy id→row map (delete_rows)
        self._norm_bounds: tuple[float, float] | None = None

    # -- construction ---------------------------------------------------------

    @classmethod
    def from_space(
        cls,
        space: VectorSpace,
        device: Any | None = None,
        include_tombstones: bool = True,
        precision: str = "highest",
    ) -> "DeviceSpace":
        """Upload a host :class:`VectorSpace` view to one device. The padded
        block goes up verbatim; tombstones become a validity mask applied in
        the scan epilogue (deleted rows can never enter the top-k).

        uint8 spaces are re-centered at upload (``c' = c − 128`` over the
        logical region, padding stays 0) so the integer dot path applies;
        the per-row code sums needed for the affine correction are computed
        once here (see :meth:`prepare_queries` for the algebra)."""
        if precision not in ("highest", "high", "high_verified", "default"):
            raise ValueError(
                f"unknown precision {precision!r}; one of 'highest', "
                "'high', 'high_verified', 'default'"
            )
        block = space.padded_array()
        norms = np.asarray(space.norms(), dtype=np.float32)
        put = (lambda x: jax.device_put(x, device)) if device else jax.device_put
        mask = None
        if include_tombstones:
            host_mask = space.tombstone_mask()
            if host_mask is not None:
                full = np.ones(space.padded_rows, dtype=np.float32)
                full[: space.num_vectors] = (~host_mask).astype(np.float32)
                mask = put(full)
        q = space.quantization
        if space.dtype == DataType.FLOAT16:
            # f16 corpora are upcast once at upload. f16 ⊂ f32, so values
            # and rankings are bit-identical to the file. (Memory-sensitive
            # deployments should store bf16 instead.)
            block = block.astype(np.float32)
        if block.dtype == np.float32 and precision == "default":
            # 'default': bf16 storage — half the device bytes and one bf16
            # dot; near-ties reorder at bf16 resolution. ('high' keeps the
            # f32 block and splits it into three bf16 dots per block.)
            import ml_dtypes

            block = block.astype(ml_dtypes.bfloat16)
        rowsums = None
        if space.dtype == DataType.UINT8:
            shifted = block.astype(np.int16) - 128
            shifted[:, space.dim :] = 0
            shifted[space.num_vectors :, :] = 0
            rowsums = put(
                shifted[:, : space.dim].sum(axis=1, dtype=np.int32).astype(np.float32)
            )
            block = shifted.astype(np.int8)
        return cls(
            # bounded-size upload: keeps pinned host memory bounded
            data=put_chunked(block, device),
            norms=put(norms),
            num_valid=space.num_vectors,
            dim=space.dim,
            metric=space.metric,
            valid_mask=mask,
            scale=q.scale if q else 1.0,
            zero_point=q.zero_point if q else 0.0,
            dtype=space.dtype,
            name=space.name,
            rowsums=rowsums,
            precision=precision,
            host_ids=space.ids(),
        )

    # -- online mutation ------------------------------------------------------

    def add_rows(self, rows, ids=None, reserve: float = 1.5) -> None:
        """Append rows to the live device corpus without touching disk.

        Static-shape discipline: jitted scans cache per corpus shape, so
        the block grows in **capacity steps** — when the tile-padded rows
        no longer fit, capacity is multiplied by ``reserve`` (amortized
        O(1) recompiles; the padding rows are masked by ``num_valid`` until
        used, so appends that fit existing capacity trigger NO recompile).
        Float input to a quantized space is quantized with the stored
        calibration. Persist via the file-side append workflow
        (``builder_from_reader``) when durability is needed.
        """
        from .format.constants import (
            padded_rows_for,
            sublane_multiple,
        )

        rows = np.asarray(rows)
        if rows.ndim == 1:
            rows = rows[None, :]
        if rows.shape[1] != self.dim:
            raise DimensionMismatchError(
                expected=self.dim, actual=int(rows.shape[1])
            )
        n_new = rows.shape[0]
        merged_ids = merged_append_ids(
            self.host_ids, ids, n_new, self.num_valid
        )

        rows_f = rows.astype(np.float32)
        new_norms = np.einsum(
            "ij,ij->i", rows_f, rows_f, dtype=np.float64
        ).astype(np.float32)
        pad_d = self.padded_dim - self.dim
        if self.dtype == DataType.UINT8:
            if np.issubdtype(rows.dtype, np.floating):
                codes = np.clip(
                    np.rint(rows_f / self.scale + self.zero_point), 0, 255
                )
            else:
                codes = rows_f
            deq = (codes - self.zero_point) * self.scale
            new_norms = np.einsum(
                "ij,ij->i", deq, deq, dtype=np.float64
            ).astype(np.float32)
            shifted = codes.astype(np.int16) - 128
            new_bias = shifted.sum(axis=1, dtype=np.int32).astype(np.float32)
            block_new = np.pad(
                shifted.astype(np.int8), ((0, 0), (0, pad_d))
            )
        elif self.dtype == DataType.INT8:
            if np.issubdtype(rows.dtype, np.floating):
                codes = np.clip(np.rint(rows_f / self.scale), -128, 127)
            else:
                codes = rows_f
            deq = codes * self.scale
            new_norms = np.einsum(
                "ij,ij->i", deq, deq, dtype=np.float64
            ).astype(np.float32)
            block_new = np.pad(
                codes.astype(np.int8), ((0, 0), (0, pad_d))
            )
            new_bias = None
        else:
            block_f32 = np.pad(rows_f, ((0, 0), (0, pad_d)))
            block_new = block_f32.astype(np.asarray(self.data).dtype)
            new_bias = None

        total = self.num_valid + n_new
        cap = self.padded_rows
        sub = sublane_multiple(self.dtype)
        if total > cap:
            cap = max(
                padded_rows_for(total, self.dtype),
                -(-int(cap * reserve) // sub) * sub,
            )

        def grown(old_dev, new_host, fill=0.0, dtype=None):
            old = np.asarray(old_dev)
            dtype = dtype or old.dtype
            shape = (cap,) + old.shape[1:]
            out = np.full(shape, fill, dtype=dtype)
            out[: self.num_valid] = old[: self.num_valid]
            out[self.num_valid : total] = new_host
            return jax.device_put(out)

        self.data = grown(self.data, block_new)
        self.norms = grown(self.norms, new_norms)
        if self.rowsums is not None:
            self.rowsums = grown(self.rowsums, new_bias)
        if self.valid_mask is not None:
            self.valid_mask = grown(
                self.valid_mask, np.ones(n_new, np.float32), fill=1.0
            )
        if merged_ids is not None:
            self.host_ids = merged_ids
            self._id_lut = None  # invalidate the lazy id→row map
        self.num_valid = total
        self._norm_bounds = None  # new rows can widen the norm range

    def delete_rows(self, rows=None, ids=None) -> None:
        """Tombstone rows on the live device corpus (by position or by
        stable ID). Deleted rows can never surface in results; physical
        removal happens at the next file compaction."""
        idx = []
        if rows is not None:
            for r in np.atleast_1d(rows):
                r = int(r)
                if r < 0 or r >= self.num_valid:
                    raise IndexOutOfBoundsError(r, self.num_valid)
                idx.append(r)
        if ids is not None:
            if self.host_ids is None:
                idx.extend(int(i) for i in np.atleast_1d(ids))
                for r in idx:
                    if r < 0 or r >= self.num_valid:
                        raise IndexOutOfBoundsError(r, self.num_valid)
            else:
                if self._id_lut is None:
                    # cached: rebuilding a multi-million-entry dict per
                    # delete call would put O(N) host work on the online
                    # mutation path (invalidated by add_rows)
                    self._id_lut = {
                        int(v): i for i, v in enumerate(self.host_ids)
                    }
                for i in np.atleast_1d(ids):
                    try:
                        idx.append(self._id_lut[int(i)])
                    except KeyError:
                        raise VectorIdNotFoundError(int(i)) from None
        if not idx:
            return
        mask = (
            np.asarray(self.valid_mask)
            if self.valid_mask is not None
            else np.ones(self.padded_rows, np.float32)
        )
        mask = mask.copy()
        mask[np.asarray(idx, np.int64)] = 0.0
        self.valid_mask = jax.device_put(mask)

    def norm_bounds(self) -> tuple[float, float]:
        """(max, min) squared L2 norm over the logical rows, cached — the
        scale factor of the ``high_verified`` certification bound. Stays a
        conservative bound under :meth:`delete_rows` (masking can only
        shrink the true range); invalidated by :meth:`add_rows`."""
        if self._norm_bounds is None:
            nrm = self.norms[: self.num_valid]
            self._norm_bounds = (float(jnp.max(nrm)), float(jnp.min(nrm)))
        return self._norm_bounds

    @property
    def padded_rows(self) -> int:
        return int(self.data.shape[0])

    @property
    def padded_dim(self) -> int:
        return int(self.data.shape[1])

    @property
    def nbytes(self) -> int:
        n = self.data.nbytes + self.norms.nbytes
        if self.valid_mask is not None:
            n += self.valid_mask.nbytes
        return n

    # -- query preprocessing --------------------------------------------------

    def prepare_queries(self, queries) -> "PreparedQueries":
        """Validate, pad to ``padded_dim``, pre-normalize (cosine),
        pre-quantize (int8/uint8) and cast to the scan's input dtype.

        uint8 offset algebra: with stored codes ``c`` (dequant ``x =
        (c − zp)·s``), re-centered device codes ``c' = c − 128``, and query
        quantization ``q ≈ o_q + s_q·q'``::

            q·x = s·s_q·(q'·c') + s·o_q·Σc' + C(q)
            C(q) = s·s_q·(128 − zp)·Σq' + s·o_q·(128 − zp)·D

        so the scan computes ``scale·idot + bias_scale·Σc'`` (rank-equal
        to ``q·x``) with one integer dot, and the engine restores
        the per-query constant ``C(q)`` afterwards so reported scores /
        distances are absolute. For integer-valued queries in
        ``[o_q − 127, o_q + 128]`` the quantization is exact and so is the
        ranking."""
        q = np.asarray(queries, dtype=np.float32)
        if q.ndim == 1:
            q = q[None, :]
        if q.ndim != 2 or q.shape[1] != self.dim:
            raise DimensionMismatchError(
                expected=self.dim, actual=int(q.shape[-1])
            )
        qnorms = np.einsum("ij,ij->i", q, q, dtype=np.float64).astype(np.float32)
        if self.metric == DistanceMetric.COSINE:
            q = q / np.maximum(np.sqrt(qnorms)[:, None], 1e-30)

        def pad(arr):
            if self.padded_dim != self.dim:
                return np.pad(arr, ((0, 0), (0, self.padded_dim - self.dim)))
            return arr

        if self.dtype == DataType.INT8:
            qscale = float(np.abs(q).max()) / 127.0 or 1.0
            qq = np.clip(np.rint(q / qscale), -128, 127).astype(np.int8)
            return PreparedQueries(
                qdev=jax.device_put(pad(qq)), sq_norms=qnorms,
                dot_scale=qscale * self.scale,
            )
        if self.dtype == DataType.UINT8 and self.metric != DistanceMetric.COSINE:
            o_q = float(np.round((q.min() + q.max()) / 2.0))
            amax = float(np.abs(q - o_q).max())
            integral = bool(np.all(q == np.rint(q)))
            if integral and amax <= 127.0:
                s_q = 1.0  # exact integer quantization
            else:
                s_q = amax / 127.0 if amax > 0 else 1.0
            qq = np.clip(np.rint((q - o_q) / s_q), -128, 127).astype(np.int8)
            qsum = qq.sum(axis=1, dtype=np.int64).astype(np.float64)
            s, zp, d = self.scale, self.zero_point, self.dim
            const = (
                s * s_q * (128.0 - zp) * qsum + s * o_q * (128.0 - zp) * d
            ).astype(np.float32)
            return PreparedQueries(
                qdev=jax.device_put(pad(qq)), sq_norms=qnorms,
                dot_scale=s_q * s, bias_scale=s * o_q, const=const,
            )
        if self.dtype == DataType.UINT8:
            # cosine over affine codes: the scan dequantizes per block
            return PreparedQueries(
                qdev=jax.device_put(pad(q)), sq_norms=qnorms,
            )
        if self.dtype == DataType.FLOAT16:
            # storage is f16 but the resident block is f32 (upcast at upload)
            compute_dt = np.float32
        else:
            compute_dt = numpy_dtype(self.dtype)
        return PreparedQueries(
            qdev=jax.device_put(pad(q).astype(compute_dt)), sq_norms=qnorms,
        )


class SearchEngine:
    """Exact brute-force top-k search over one :class:`DeviceSpace`, one
    jitted blocked scan per query batch (:func:`~.ops.distances.exact_topk`).

    >>> import numpy as np, tempfile, os
    >>> from metrovector_tpu import Builder
    >>> from metrovector_tpu.engine import SearchEngine
    >>> b = Builder()
    >>> _ = b.add_vector_space("e", dim=3)
    >>> b.add_vectors("e", np.eye(3, dtype=np.float32))
    >>> path = os.path.join(tempfile.mkdtemp(), "q.mvt")
    >>> b.build().save(path)
    >>> eng = SearchEngine.open(path)
    >>> res = eng.search(np.array([[0.9, 0.1, 0.0]], np.float32), k=1)
    >>> res.indices.tolist()
    [[0]]
    >>> int(res.ids[0, 0])  # no ID column: positions are the IDs
    0
    """

    def __init__(self, space: VectorSpace | DeviceSpace,
                 device: Any | None = None, precision: str = "highest",
                 block_rows: int | None = None, verify_margin: int = 8):
        """``precision`` (f32 spaces): ``"highest"`` — exact f32 dots;
        ``"high"`` — three bf16 dots per block (``q_hi·x_hi + q_hi·x_lo +
        q_lo·x_hi``), ~f32-faithful but sub-ulp near-ties may swap;
        ``"high_verified"`` — the 'high' scan fetches ``k + verify_margin``
        candidates and a tiny f32-HIGHEST on-device re-score of just those
        candidates returns the exact top-k, certified per query (the
        repair pass is ``[Q, k+margin]`` — microscopic next to the
        full-corpus scan); ``"default"`` — bf16 storage, half the device
        bytes, ties reorder at bf16 resolution. ``verify_margin`` guards
        the candidate boundary; the 'high' failure mode is a single-rank
        swap at sub-ulp gaps, so the default 8 is already generous.

        ``block_rows``: corpus rows per scan step (None: a tiling persisted
        by :meth:`autotune` in the file's hints, else
        :data:`~.ops.distances.DEFAULT_BLOCK_ROWS`)."""
        self._host_space = None  # file-backed origin (autotune persist)
        if isinstance(space, VectorSpace):
            self._host_space = space
            # Adopt a tiling a previous autotune(persist=True) wrote into
            # the file's PerformanceHints — an explicit argument wins.
            from .utils.tune import tuned_hints

            if block_rows is None:
                block_rows = tuned_hints(space, "dense").get("block_rows")
            space = DeviceSpace.from_space(
                space, device=device, precision=precision
            )
        self.space = space
        self.block_rows = block_rows
        if verify_margin < 1:
            raise ValueError(
                f"verify_margin must be >= 1, got {verify_margin}"
            )
        self.verify_margin = int(verify_margin)
        # high_verified observability: queries whose certificate held vs
        # queries that triggered the HIGHEST rerun (degenerate near-ties)
        self.verify_stats = {"certified": 0, "fallbacks": 0}

    @classmethod
    def open(cls, path, space_name: str | None = None, **kw) -> "SearchEngine":
        """One-call open: mmap the file and upload the named (or only)
        space."""
        r = Reader.open(path)
        name = space_name or r.vector_space_names[0]
        return cls(r.vector_space(name), **kw)

    def search(self, queries, k: int = 10, filter_mask=None) -> SearchResult:
        """Batched exact top-k. ``queries``: ``[Q, dim]`` (or a single
        vector). ``filter_mask``: optional ``[num_vectors]`` boolean/int
        row predicate (e.g. built from a metadata column) — rows with 0 are
        excluded from results exactly, composed with tombstones; when fewer
        than ``k`` rows qualify, the tail holds ``-1`` sentinels. A
        :class:`PreparedFilter` (from :meth:`prepare_filter`) is accepted
        to skip the per-call host→device mask upload when the same
        predicate serves many query batches. Returns best-first results
        for every query."""
        return self._finalize(self._launch(queries, k, filter_mask), k)

    def search_radius(self, queries, radius: float, max_results: int = 128,
                      filter_mask=None) -> RadiusResult:
        """Exact range query: every row within ``radius`` of each query
        (L2: Euclidean distance ≤ radius; cosine/IP: similarity ≥ radius),
        best-first, via a capped top-``max_results`` pass — check
        ``result.truncated`` and widen the cap when a query saturates it.
        Reference analog: none (its only search is the example's top-k)."""
        k = min(max_results, max(self.space.num_valid, 1))
        res = self.search(queries, k=k, filter_mask=filter_mask)
        return radius_from_topk(res, radius, k, self.space.num_valid)

    def prepare_filter(self, filter_mask) -> PreparedFilter:
        """Upload a ``[num_vectors]`` boolean/int row predicate once and
        return a :class:`PreparedFilter` reusable across :meth:`search`
        calls — the serving path for a hot predicate (e.g. a tenant or
        language filter applied to every request). The prepared mask is
        invalidated by corpus growth (``add_rows`` re-pads the corpus);
        re-prepare after mutation that changes the row count."""
        from .utils.filters import padded_filter_plane

        sp = self.space
        full = padded_filter_plane(
            filter_mask, sp.num_valid, sp.data.shape[0]
        )
        return PreparedFilter(
            mask=jax.device_put(full), num_valid=sp.num_valid
        )

    def autotune(self, queries=None, k: int = 10, batch: int = 128,
                 block_rows_candidates=None, iters: int = 3,
                 apply: bool = True, persist: bool = False) -> list[dict]:
        """Measure candidate scan ``block_rows`` with **single-launch
        timings** (one launch, one forced readback per measurement) and
        optionally apply the fastest to this engine. Each candidate pays
        one compile, so tune once per (corpus shape, dtype, k) and reuse
        the engine.

        ``queries``: sample batch (``[batch, dim]`` drawn N(0,1) if
        omitted). Returns all measurements sorted fastest-first as dicts
        with ``block_rows``/``ms`` (``ms`` is the best of ``iters``
        post-warmup timings; failed candidates get ``inf`` and an
        ``error``). ``apply=True`` sets this engine's ``block_rows`` to the
        winner.

        ``persist=True`` (with ``apply``) additionally writes the winning
        tiling into the source file's ``PerformanceHints``
        (``hints["tuned"][space]["dense"]`` — footer-only rewrite, data
        blocks and CRCs untouched), so every future engine built from
        that file adopts it by default; requires an engine constructed
        from a file-backed ``VectorSpace``. CLI: ``tune --save``."""
        sp = self.space
        if queries is None:
            queries = np.random.default_rng(0).standard_normal(
                (batch, sp.dim)
            ).astype(np.float32)
        if block_rows_candidates is None:
            block_rows_candidates = block_rows_around(DEFAULT_BLOCK_ROWS)

        if persist and self._host_space is None:
            raise ValueError(
                "persist requires an engine built from a file-backed "
                "VectorSpace (SearchEngine.open / Reader.open)"
            )
        candidates = [{"block_rows": int(br)} for br in block_rows_candidates]

        def run_with(cfg):
            self.block_rows = cfg["block_rows"]

            def run():
                res = self._finalize(self._launch(queries, k), k)
                np.asarray(res.indices)  # force the readback
            return run

        saved = self.block_rows
        try:
            results = measure_candidates(candidates, run_with, iters)
        finally:
            self.block_rows = saved
        if apply and results and np.isfinite(results[0]["ms"]):
            self.block_rows = results[0]["block_rows"]
            if persist:
                from .utils.tune import persist_tuned

                persist_tuned(
                    self._host_space, "dense", {"block_rows": self.block_rows}
                )
        elif persist:
            raise RuntimeError(
                "nothing persisted: no finite-time winner to apply "
                f"(apply={apply})"
            )
        return results

    def search_pipelined(self, query_batches, k: int = 10):
        """Iterator of :class:`SearchResult`s over an iterable of query
        batches, with **one batch in flight**: batch ``i+1`` is uploaded
        and its scan launched before batch ``i``'s results are read back,
        hiding host↔device transfer latency behind device compute (the
        serving analog of the benchmark methodology in ``bench.py``).
        Order of results matches the input order."""
        pending = None
        for q in query_batches:
            launched = self._launch(q, k)
            if pending is not None:
                yield self._finalize(pending, k)
            pending = launched
        if pending is not None:
            yield self._finalize(pending, k)

    def _launch(self, queries, k: int, filter_mask=None):
        """Upload + launch without forcing a readback. Returns an opaque
        pending tuple for :meth:`_finalize`."""
        sp = self.space
        if sp.metric == DistanceMetric.CUSTOM:
            raise InvalidVectorTypeError(
                "CUSTOM metric spaces need a user-provided score function; "
                "use ops.distances directly"
            )
        prep = sp.prepare_queries(queries)
        if sp.num_valid == 0:  # empty space: all-sentinel results
            return (None, None, prep, 0, None)
        k_eff = min(k, sp.num_valid)
        eff_mask = sp.valid_mask
        if filter_mask is not None:
            from .utils.filters import checked_prepared_mask, padded_filter_plane

            if isinstance(filter_mask, PreparedFilter):
                fdev = checked_prepared_mask(
                    filter_mask, sp.num_valid, sp.data.shape[0]
                )
            else:
                fdev = jax.device_put(
                    padded_filter_plane(
                        filter_mask, sp.num_valid, sp.data.shape[0]
                    )
                )
            eff_mask = fdev if eff_mask is None else eff_mask * fdev

        vcheck = None  # verified-'high' certification info (f32 only)
        if sp.dtype == DataType.UINT8 and sp.metric == DistanceMetric.COSINE:
            # cosine over affine codes: normalized float queries cannot
            # quantize exactly, so the scan dequantizes each block,
            # x = (c' + 128 − zp)·scale (c' the re-centered device codes;
            # padded dims dequantize to a constant but pair with zero
            # query dims)
            scores, idx = exact_topk(
                prep.qdev, sp.data, sp.norms, sp.num_valid, k_eff,
                sp.metric, valid_mask=eff_mask, block_rows=self.block_rows,
                dequant=(128.0 - sp.zero_point, sp.scale),
            )
            return (scores, idx, prep, k_eff, vcheck)
        qdev = prep.qdev
        scan_prec = "highest"
        verified = (
            sp.dtype == DataType.FLOAT32 and sp.precision == "high_verified"
        )
        if sp.dtype == DataType.FLOAT32 and (
            sp.precision == "high" or verified
        ):
            scan_prec = "high"  # three bf16 dots per block
        elif sp.dtype == DataType.FLOAT32 and sp.precision == "default":
            qdev = qdev.astype(sp.data.dtype)  # bf16-only storage
            scan_prec = "default"
        # verified-'high': over-fetch a small margin at 'high' speed, then
        # exact-rescore just those candidates at f32 HIGHEST — the
        # full-scan matmul dominates; the [Q, k+margin] repair is tiny
        k_fetch = (
            min(k_eff + self.verify_margin, sp.num_valid)
            if verified else k_eff
        )
        scores, idx = self._scan(qdev, prep, k_fetch, eff_mask, scan_prec)
        if verified:
            # k_fetch-th best 'high' score: every non-fetched row lost
            # the selection to it, so its TRUE (f32 HIGHEST) score is
            # ≤ boundary + eps where eps bounds |'high' − HIGHEST|.
            boundary = scores[:, -1]
            scores, idx = rescore_topk(
                qdev, sp.data, sp.norms, idx, k_eff, sp.metric,
            )
            if k_fetch < sp.num_valid:
                vcheck = (boundary, self._verify_eps(prep), qdev, eff_mask)
            # else: every valid row was fetched and exactly rescored —
            # certified by construction, no bound needed
        return (scores, idx, prep, k_eff, vcheck)

    def _scan(self, qdev, prep, k: int, eff_mask, precision: str):
        sp = self.space
        return exact_topk(
            qdev, sp.data, sp.norms, sp.num_valid, k, sp.metric,
            valid_mask=eff_mask, scale=prep.dot_scale,
            bias_row=sp.rowsums, bias_scale=prep.bias_scale,
            precision=precision, block_rows=self.block_rows,
        )

    def _verify_eps(self, prep) -> np.ndarray:
        """Per-query sound upper bound on |'high' scan score − exact
        score| in the scan's internal score space — the certification
        slack of ``precision="high_verified"``.

        The 'high' dot is a bf16 split (:func:`~.ops.distances.block_dots`):
        ``q·x ≈ q_hi·x_hi + q_hi·x_lo + q_lo·x_hi``. Error terms, all ≤ the
        stated multiple of ``‖q‖·‖x‖`` (Cauchy–Schwarz):

        - dropped ``q_lo·x_lo``:          ≤ 2⁻¹⁶  (|lo| ≤ 2⁻⁸|x| per side)
        - ``lo`` re-rounded to bf16:      ≤ 2·2⁻¹⁶
        - f32 accumulation, both the 'high' scan and the exact re-score
          side: ≤ 2·D·2⁻²³. This allows one truncation (not rounding) of
          up to 2⁻²³ of the running magnitude per product, which covers
          tensor-core accumulation that aligns each group of products to
          the largest exponent and truncates, as well as one rounding per
          f32 FMA.

        Total raw bound ≈ (3·2⁻¹⁶ + D·2⁻²²)·‖q‖‖x‖; this returns
        ``C(D) = 2⁻¹⁴ + D·2⁻²²``, above it by 2⁻¹⁶.
        Score-space factors: L2 scores are ``2·dot − ‖x‖²`` with the
        *stored* norm on both sides of the comparison (norm term cancels
        exactly) → eps = 2·C·‖q‖·max‖x‖; IP → C·‖q‖·max‖x‖; cosine queries
        are pre-normalized and the ``rsqrt(‖x‖²)`` factor cancels the
        ``‖x‖`` → eps = C (constant). ``max‖x‖`` comes from the cached
        :meth:`DeviceSpace.norm_bounds` (conservative under deletes,
        invalidated by ``add_rows``)."""
        sp = self.space
        c = 2.0 ** -14 + sp.dim * 2.0 ** -22
        if sp.metric == DistanceMetric.COSINE:
            return np.full(prep.sq_norms.shape, c, np.float32)
        qn = np.sqrt(prep.sq_norms.astype(np.float64))
        xmax = float(np.sqrt(max(sp.norm_bounds()[0], 0.0)))
        mult = 2.0 if sp.metric == DistanceMetric.L2 else 1.0
        return (mult * c * qn * xmax).astype(np.float32)

    def _finalize(self, pending, k: int) -> SearchResult:
        """Force the readback and convert to a user-facing result. For a
        ``high_verified`` launch, checks the certification inequality and
        — only if it fails (degenerate sub-ulp near-tie data) — reruns the
        launch at f32 HIGHEST so the exactness guarantee holds
        unconditionally (see :meth:`_verify_eps`)."""
        sp = self.space
        scores, idx, prep, k_eff, vcheck = pending
        if k_eff == 0:  # empty space
            nq = prep.qdev.shape[0]
            return SearchResult(
                indices=np.full((nq, k), -1, np.int32),
                scores=np.full((nq, k), -np.inf, np.float32),
                distances=np.full(
                    (nq, k),
                    np.inf if sp.metric == DistanceMetric.L2 else -np.inf,
                    np.float32,
                ),
                metric=sp.metric,
                ids=np.full((nq, k), SearchResult.ID_SENTINEL, np.uint64),
            )
        scores = np.asarray(scores)
        idx = np.asarray(idx)
        if vcheck is not None:
            # Certification: every non-fetched row's 'high' score lost to
            # the fetch boundary b, so its TRUE score is ≤ b + eps. If the
            # exact k-th candidate score clears b + eps strictly, the
            # returned top-k is provably the exact top-k. Failure means the
            # corpus is degenerate at the boundary (scores within the
            # 'high' error band across > verify_margin rows) — rerun that
            # batch at f32 HIGHEST so the guarantee holds unconditionally.
            boundary, eps, qdev, eff_mask = vcheck
            b = np.asarray(boundary)
            ok = np.isneginf(b) | (scores[:, k_eff - 1] > b + eps)
            self.verify_stats["certified"] += int(ok.sum())
            if not ok.all():
                self.verify_stats["fallbacks"] += int((~ok).sum())
                scores, idx = self._scan(
                    qdev, prep, k_eff, eff_mask, "highest"
                )
                scores = np.asarray(scores)
                idx = np.asarray(idx)
        if prep.const is not None:
            # restore the rank-neutral per-query constant so scores and
            # distances are absolute, not just rank-correct
            mult = 2.0 if sp.metric == DistanceMetric.L2 else 1.0
            scores = scores + mult * prep.const[:, None]
        qnorms = prep.sq_norms
        dist = distances_np(scores, sp.metric, qnorms)
        if k_eff < k:  # pad out to requested k with sentinels
            pad = ((0, 0), (0, k - k_eff))
            idx = np.pad(idx, pad, constant_values=-1)
            scores = np.pad(scores, pad, constant_values=-np.inf)
            dist = np.pad(dist, pad, constant_values=np.inf
                          if sp.metric == DistanceMetric.L2 else -np.inf)
        ids = ids_for_rows(sp.host_ids, idx)
        return SearchResult(indices=idx, scores=scores, distances=dist,
                            metric=sp.metric, ids=ids)
