"""Multi-space serving facade: one open file, one engine per space.

The reference's application layer is "open a reader, walk the spaces"
(`examples/simple.rs:45-66` in thegenem0/metrovector); this wraps the same
flow for serving: engines build lazily per space (first search uploads
that space to the device), metadata columns turn into exact filter masks,
and results carry stable IDs.
"""

from __future__ import annotations

import operator
import os
from typing import Any

import numpy as np

from .engine import SearchEngine, SearchResult
from .errors import MetadataColumnNotFoundError
from .format.reader import Reader
from .utils.log import get_logger

_log = get_logger("database")

_OPS = {
    "==": operator.eq,
    "!=": operator.ne,
    "<": operator.lt,
    "<=": operator.le,
    ">": operator.gt,
    ">=": operator.ge,
    "in": lambda col, vals: np.isin(col, list(vals)),
}


class IndexEngine:
    """Facade adapter serving a reattached ANN/compressed index through the
    engine interface (``search``/``prepare_filter``/``nbytes``/``dim``) so
    persisted sidecars drive the read path — the reference's design intent
    for the footer ``Index`` union (``schema/index.fbs:6-36`` in
    thegenem0/metrovector), which its own code never consumes.

    ``kind``: ``"pq" | "ivfpq" | "ivf" | "hnsw"``. ``search_kwargs`` are
    the per-call defaults the facade chose at reattachment (e.g. ``nprobe``
    from the persisted index params); explicit keyword arguments on
    :meth:`search` override them. PQ-family engines default ``rerank`` to
    ``index.recommended_rerank(k)`` (recall ≈ 1.0 guidance) unless
    overridden — pass ``rerank=0`` for raw ADC speed."""

    def __init__(self, index, kind: str, search_kwargs: dict | None = None):
        self.index = index
        self.kind = kind
        self.search_kwargs = dict(search_kwargs or {})
        self.dim = int(
            getattr(index, "dim", 0) or index.rows.shape[1]  # HNSW
        )
        # row count for callers that validate [num_vectors] filter masks
        # up front (MicroBatcher.submit fails malformed masks at submit
        # time instead of poisoning a drained batch in the worker)
        nv = getattr(index, "num_vectors", None)
        self.num_vectors = int(
            nv if nv is not None else index.rows.shape[0]  # HNSW
        )

    @property
    def nbytes(self) -> int:
        """Summed device footprint of the index's jax arrays (HNSW is
        host-resident: 0)."""
        import jax

        return sum(
            v.nbytes
            for v in vars(self.index).values()
            if isinstance(v, jax.Array)
        )

    def prepare_filter(self, filter_mask):
        prep = getattr(self.index, "prepare_filter", None)
        # HNSW filters are host planes; hand the raw mask back
        return prep(filter_mask) if prep else filter_mask

    def search(self, queries, k: int = 10, filter_mask=None, **kw):
        merged = {**self.search_kwargs, **kw}
        if (
            self.kind in ("pq", "ivfpq")
            and "rerank" not in merged
            and self.index.db is not None
        ):
            merged["rerank"] = self.index.recommended_rerank(k)
        return self.index.search(
            queries, k=k, filter_mask=filter_mask, **merged
        )


class Database:
    """Lazy per-space engines over one MVT file.

    >>> import numpy as np, tempfile, os
    >>> from metrovector_tpu import Builder, Database
    >>> b = Builder()
    >>> _ = b.add_vector_space("docs", dim=4)
    >>> b.add_vectors("docs", np.eye(4, dtype=np.float32))
    >>> b.add_metadata_column("docs", "lang", ["en", "de", "en", "fr"])
    >>> path = os.path.join(tempfile.mkdtemp(), "db.mvt")
    >>> b.build().save(path)
    >>> db = Database.open(path)
    >>> res = db.search("docs", np.eye(4, dtype=np.float32)[:1], k=2,
    ...                 where=("lang", "==", "en"))
    >>> res.indices.tolist()
    [[0, 2]]
    """

    def __init__(self, reader: Reader, hbm_budget: int | None = None,
                 engine_kwargs: dict | None = None):
        self._reader = reader
        self._engine_kwargs = dict(engine_kwargs or {})
        # Insertion order == LRU order (engines re-inserted on access).
        self._engines: dict[str, Any] = {}
        self.hbm_budget = hbm_budget
        # sidecar detection is pure manifest metadata — cache per space
        self._kind_cache: dict[str, str | None] = {}
        self._routed_notice: set[str] = set()

    @classmethod
    def open(cls, path: str | os.PathLike, hbm_budget: int | None = None,
             engine_kwargs: dict | None = None) -> "Database":
        """``hbm_budget``: optional cap (bytes) on the summed device
        footprint of resident per-space engines. When a new space would
        exceed it, least-recently-searched engines are evicted first; a
        single space larger than the whole budget raises
        :class:`~metrovector_tpu.errors.HBMBudgetExceededError` instead of
        OOMing on the Nth search. No budget (default) keeps every searched
        space resident, as before. Budget math is steady-state: while a
        >512 MB space uploads, one in-flight transfer chunk (≤256 MB,
        ``utils.transfer.put_chunked``) transiently rides on top of the
        admitted size — leave that much headroom below physical memory.

        ``engine_kwargs``: extra keyword arguments for every dense
        :class:`~.engine.SearchEngine` the facade builds — e.g. a tuned
        scan tiling (``{"block_rows": 32768}``) or ``precision`` (see
        ``SearchEngine.autotune`` / ``docs/PERFORMANCE.md``). Sparse
        spaces ignore them."""
        return cls(Reader.open(path), hbm_budget=hbm_budget,
                   engine_kwargs=engine_kwargs)

    @property
    def reader(self) -> Reader:
        return self._reader

    @property
    def space_names(self) -> list[str]:
        return self._reader.vector_space_names

    @property
    def resident_bytes(self) -> int:
        """Summed device footprint of the currently resident engines."""
        return sum(
            e.space.nbytes if hasattr(e, "space") else e.nbytes
            for e in self._engines.values()
        )

    def _estimate_nbytes(self, space: str, flavor: str = "exact") -> int:
        """Device footprint of a space BEFORE uploading it (the budget
        decision must precede the allocation). ``flavor='exact'`` mirrors
        ``DeviceSpace.from_space``: f16 upcasts to f32 at upload,
        int8/uint8 stay 1 byte, plus f32 norms and an
        optional f32 validity mask. Index flavors estimate the reattached
        structure: PQ/IVF-PQ add coded planes on top of the resident
        originals (``keep_vectors=True`` re-rank default), IVF holds a
        bucket-grouped f32 copy, HNSW is host-resident (0 device bytes)."""
        sp = self._reader.vector_space(space)
        from .format.constants import DataType, VectorType

        if flavor == "hnsw":
            return 0
        pad_d = -(-sp.dim // 128) * 128  # device rows live lane-padded
        if flavor in ("pq", "ivfpq"):
            n = sp.num_vectors
            pq = sp.info.pq
            code_b = (
                (pq.m + 1) // 2 if pq.packed4 else pq.m
            ) if pq is not None else 16
            dense = n * pad_d * 4 + n * 4  # keep_vectors originals + norms
            coded = n * code_b + n * 4  # codes + recon norms
            if flavor == "ivfpq":
                # bucket copy of codes/ids/norms + row-order scan planes
                coded = 2 * coded + n * 12
            return dense + coded
        if flavor == "ivf":
            # bucket-grouped f32 rows (~1.25x padding) + ids + norms
            n = sp.num_vectors
            return int(n * pad_d * 4 * 1.25) + n * 8

        if sp.info.vector_type == VectorType.SPARSE:
            # Mirror SparseSearchEngine's "auto" pick: ELL (padded rows ×
            # cap × (i32 col + f32 val) + overflow triples + norms) unless
            # padding explodes entries past 3× nnz, in which case the
            # engine falls back to COO (nnz triples of i32 col + i32 row +
            # f32 val + norms) and the ELL figure would over-charge the
            # budget 2×+. Optional validity plane is second-order.
            from .sparse import _ELL_ROW_PAD

            indptr, _, _ = sp.sparse_csr()
            counts = np.diff(indptr.astype(np.int64))
            nnz = int(counts.sum())
            n = max(sp.num_vectors, 1)
            if nnz == 0:
                r_cap = 1
                n_ovf = 0
            else:
                r95 = int(np.percentile(counts, 95))
                r_cap = int(
                    min(counts.max(initial=1), max(8, -(-r95 // 8) * 8))
                )
                n_ovf = int(np.maximum(counts - r_cap, 0).sum())
            if nnz and n * r_cap + n_ovf > 3 * nnz:
                # COO fallback: padded nnz triples (i32 col + i32 row +
                # f32 val) + unpadded f32 norms
                chunk = min(1 << 20, max(256, nnz))
                padded = nnz + ((-nnz) % chunk)
                return padded * 12 + sp.num_vectors * 4
            n_pad = max(_ELL_ROW_PAD, -(-n // _ELL_ROW_PAD) * _ELL_ROW_PAD)
            ovf_chunk = min(1 << 13, max(256, n_ovf)) if n_ovf else 256
            ovf_padded = (n_ovf + ((-n_ovf) % ovf_chunk)) if n_ovf else ovf_chunk
            return n_pad * r_cap * 8 + ovf_padded * 12 + n_pad * 4

        elem = {
            DataType.INT8: 1,
            DataType.UINT8: 1,
        }.get(sp.dtype, 4)
        rows, dim = sp.padded_rows, sp.padded_dim
        n = rows * dim * elem + rows * 4  # data + norms
        if sp.tombstone_mask() is not None:
            n += rows * 4
        if sp.dtype == DataType.UINT8:
            n += rows * 4  # per-row code sums (offset path)
        return n

    def evict(self, space: str) -> bool:
        """Drop one space's engine(s) (and their device arrays) — every
        routing flavor (exact and index-served). Returns True if any was
        resident. Un-persisted online mutations
        (``add_rows``/``delete_rows`` on the live engine) are lost —
        persist via the append workflow first."""
        keys = [
            key for key in self._engines
            if key == space or key.startswith(space + "#")
        ]
        for key in keys:
            del self._engines[key]
        return bool(keys)

    def _admit(self, space: str, flavor: str = "exact") -> None:
        """Evict least-recently-used engines until ``space`` fits the
        budget; error if it can never fit."""
        if self.hbm_budget is None:
            return
        need = self._estimate_nbytes(space, flavor)
        if need > self.hbm_budget:
            from .errors import HBMBudgetExceededError

            raise HBMBudgetExceededError(space, need, self.hbm_budget)
        while self._engines and self.resident_bytes + need > self.hbm_budget:
            # dict order is LRU (oldest first)
            oldest = next(iter(self._engines))
            del self._engines[oldest]

    def index_kind(self, space: str) -> str | None:
        """Which persisted index sidecar (if any) would drive ``auto``
        routing for this space: ``"ivfpq"``, ``"pq"``, ``"hnsw"``,
        ``"ivf"`` or None (brute-force). Mirrors the reference's footer
        ``Index`` union (``schema/index.fbs:6-36``) — there declarative,
        here actually consulted by the read path."""
        if space in self._kind_cache:
            return self._kind_cache[space]
        self._kind_cache[space] = kind = self._detect_index_kind(space)
        return kind

    def _detect_index_kind(self, space: str) -> str | None:
        from .format.constants import IndexKind, VectorType

        sp = self._reader.vector_space(space)
        if sp.info.vector_type == VectorType.SPARSE:
            return None
        pq = sp.info.pq
        kind = sp.info.index.kind
        if pq is not None and pq.codes_block >= 0:
            if pq.residual and kind == IndexKind.IVF:
                return "ivfpq"
            if not pq.residual:
                return "pq"
        if kind == IndexKind.HNSW and sp.hnsw_arrays() is not None:
            return "hnsw"
        if kind == IndexKind.IVF and sp.ivf_arrays() is not None:
            return "ivf"
        return None

    def _build_index_engine(self, space: str, kind: str) -> IndexEngine:
        sp = self._reader.vector_space(space)
        params = sp.info.index.params
        if kind == "pq":
            return IndexEngine(self.pq_index(space), "pq")
        if kind == "ivfpq":
            return IndexEngine(
                self.ivfpq_index(space), "ivfpq",
                {"nprobe": int(params.get("nprobe", 16))},
            )
        if kind == "ivf":
            return IndexEngine(
                self.ivf_index(space), "ivf",
                {"nprobe": int(params.get("nprobe", 16))},
            )
        if kind == "hnsw":
            return IndexEngine(self.hnsw_index(space), "hnsw")
        raise ValueError(f"unknown index kind {kind!r}")

    def engine(self, space: str | None = None, mode: str = "auto"):
        """The (lazily built) engine for one space. With a single-space
        file the name may be omitted. Under an ``hbm_budget``, building a
        new engine may evict least-recently-used ones.

        ``mode``: ``"auto"`` serves through the space's persisted index
        sidecar when one exists (:meth:`index_kind` — IVF-PQ/PQ/HNSW/IVF,
        reattached without retraining, recall-1.0 rerank defaults) and
        brute-force otherwise; ``"exact"`` always brute-force;
        ``"index"`` requires a sidecar and errors without one. Exact and
        index engines for the same space are cached (and budget-accounted)
        independently."""
        if space is None:
            names = self.space_names
            if len(names) != 1:
                raise ValueError(
                    f"file has {len(names)} spaces; name one of {names}"
                )
            space = names[0]
        if mode not in ("auto", "exact", "index"):
            raise ValueError(
                f"unknown mode {mode!r}; expected 'auto', 'exact' or 'index'"
            )
        kind = None
        if mode != "exact":
            kind = self.index_kind(space)
            if kind is not None and mode == "auto" and space not in self._routed_notice:
                # one-time notice: auto routing trades the brute-force
                # oracle-exactness contract for the sidecar's
                # recall/latency profile — visible under MVT_LOG=info,
                # silent otherwise (mode="exact" opts out entirely)
                self._routed_notice.add(space)
                _log.info(
                    "space %r: serving through its persisted %s sidecar "
                    "(mode='auto'); pass mode='exact' for brute-force "
                    "oracle-exact results", space, kind,
                )
            if kind is None and mode == "index":
                raise ValueError(
                    f"space {space!r} persists no index sidecar; build one "
                    "(Builder.set_pq_index/set_ivf_index/set_hnsw_index) or "
                    "use mode='exact'"
                )
        key = space if kind is None else f"{space}#{kind}"
        if key not in self._engines:
            self._admit(space, flavor=kind or "exact")
            if kind is not None:
                self._engines[key] = self._build_index_engine(space, kind)
            else:
                sp = self._reader.vector_space(space)
                from .format.constants import VectorType

                if sp.info.vector_type == VectorType.SPARSE:
                    # sparse spaces route to the sparse engine; the dense
                    # engine's kwargs don't apply there
                    from .sparse import SparseSearchEngine

                    self._engines[key] = SparseSearchEngine(sp)
                else:
                    self._engines[key] = SearchEngine(
                        sp, **self._engine_kwargs
                    )
        else:
            self._engines[key] = self._engines.pop(key)  # LRU touch
        return self._engines[key]

    def batcher(self, space: str | None = None, k: int = 10,
                where: tuple | list[tuple] | None = None,
                mode: str = "auto", **kw):
        """A :class:`~.serving.MicroBatcher` over one space's engine —
        the request-coalescing front-end for concurrent single-query
        callers. ``where`` predicates (same form as :meth:`search`)
        become the batcher's shared prepared filter. ``mode`` routes like
        :meth:`search` (``"auto"`` serves a persisted index sidecar when
        one exists). Remaining keyword arguments pass through to
        :class:`~.serving.MicroBatcher` (``max_batch``, ``max_wait_ms``,
        ...). Caller owns the batcher's lifecycle (use ``with`` or
        ``close()``)."""
        from .serving import MicroBatcher

        eng = self.engine(space, mode=mode)
        name = space if space is not None else self.space_names[0]
        mask = None
        if where is not None:
            preds = [where] if isinstance(where, tuple) else list(where)
            for col, op, value in preds:
                m = self.column_mask(name, col, op, value)
                mask = m if mask is None else (mask & m)
        return MicroBatcher(eng, k=k, filter_mask=mask, **kw)

    def prepare_where(self, space: str | None = None,
                      where: tuple | list[tuple] | None = None,
                      mode: str = "auto"):
        """Build a metadata predicate mask and prepare it on the space's
        serving engine — the per-request predicate shape for
        :meth:`batcher`: prepare each hot predicate once, then
        ``batcher.submit(q, filter_mask=prepared)``; same-predicate
        requests coalesce into the same batch
        (:meth:`~.serving.MicroBatcher.submit`). ``where`` follows
        :meth:`search` (a ``(column, op, value)`` tuple or an
        AND-combined list); ``mode`` must match the batcher's routing so
        the prepared plane fits the engine that will consume it."""
        if where is None:
            raise ValueError("prepare_where needs at least one predicate")
        eng = self.engine(space, mode=mode)
        name = space if space is not None else self.space_names[0]
        preds = [where] if isinstance(where, tuple) else list(where)
        mask = None
        for col, op, value in preds:
            m = self.column_mask(name, col, op, value)
            mask = m if mask is None else (mask & m)
        prep = getattr(eng, "prepare_filter", None)
        return prep(mask) if prep else mask

    def pq_index(self, space: str, **kw):
        """Reattach (or build) the space's PQ index — persisted codebooks
        /codes/norms load without retraining (``PQIndex.from_space``)."""
        from .index import PQIndex

        return PQIndex.from_space(self._reader.vector_space(space), **kw)

    def ivf_index(self, space: str, **kw):
        """Reattach (or build) the space's IVF structure."""
        from .index import IVFIndex

        return IVFIndex.from_space(self._reader.vector_space(space), **kw)

    def ivfpq_index(self, space: str, **kw):
        """Reattach (or build) the space's residual IVF-PQ structure."""
        from .index import IVFPQIndex

        return IVFPQIndex.from_space(self._reader.vector_space(space), **kw)

    def hnsw_index(self, space: str, **kw):
        """Reattach (or build) the space's HNSW graph."""
        from .index import HNSWIndex

        return HNSWIndex.from_space(self._reader.vector_space(space), **kw)

    def column_mask(self, space: str, column: str, op: str,
                    value: Any) -> np.ndarray:
        """A boolean row mask from a metadata predicate, e.g.
        ``column_mask("docs", "lang", "==", "en")`` or
        ``("price", "<", 10.0)`` or ``("tag", "in", {"a", "b"})``."""
        if op not in _OPS:
            raise ValueError(f"unknown operator {op!r}; one of {list(_OPS)}")
        sp = self._reader.vector_space(space)
        if column not in sp.metadata_column_names():
            raise MetadataColumnNotFoundError(column)
        vals = sp.metadata_column(column)
        if isinstance(vals, list):  # string column
            arr = np.asarray(vals, dtype=object)
        else:
            arr = np.asarray(vals)
        return np.asarray(_OPS[op](arr, value), dtype=bool)

    def search(self, space: str | None, queries, k: int = 10,
               where: tuple | list[tuple] | None = None,
               filter_mask=None, mode: str = "auto",
               **search_kwargs) -> SearchResult:
        """Search one space, optionally restricted by metadata predicates.

        ``where``: a ``(column, op, value)`` predicate or a list of them
        (AND-combined), turned into the serving engine's exact filter
        mask. Composable with an explicit ``filter_mask``. Predicates
        compose with EVERY routing target (round-5): brute-force engines
        take them in-kernel, PQ/IVF-PQ/IVF/HNSW indexes through their own
        ``filter_mask`` planes.

        ``mode``: ``"auto"`` (default) serves through the space's
        persisted index sidecar when one exists — the footer index drives
        the read path, reference ``schema/index.fbs:6-36`` — with
        recall-1.0 rerank defaults; ``"exact"`` forces brute-force;
        ``"index"`` requires a sidecar. Extra keyword arguments reach the
        routed engine's ``search`` (e.g. ``nprobe=32``, ``rerank=0``,
        ``ef=256``)."""
        eng = self.engine(space, mode=mode)
        name = space if space is not None else self.space_names[0]
        mask = None
        if where is not None:
            preds = [where] if isinstance(where, tuple) else list(where)
            for col, op, value in preds:
                m = self.column_mask(name, col, op, value)
                mask = m if mask is None else (mask & m)
        if filter_mask is not None:
            fm = np.asarray(filter_mask, dtype=bool)
            mask = fm if mask is None else (mask & fm)
        return eng.search(queries, k=k, filter_mask=mask, **search_kwargs)
