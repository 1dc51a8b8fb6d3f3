"""Exact search over SPARSE (CSR) vector spaces.

The reference declares ``VectorType::Sparse`` in its schema but can neither
encode nor search it (SURVEY.md §2 quirks). MVT stores real CSR blocks
(:class:`~metrovector_tpu.format.manifest.SparseInfo`) and searches them
on device with one of two formulations:

**ELL + overflow (default).** Scatters serialize on colliding rows, so
the serving layout pads each row to a fixed width R (covering ~all entries) and the
per-row reduction becomes a REGULAR sum — no scatter anywhere:

    g[e, q]       = queries[q, cols_ell[n, r]]    (embedding-style row
                                                   gather from queriesᵀ —
                                                   contiguous rows)
    dots[n, q]    = Σ_r g · vals_ell[n, r]        (fixed-width sum)

Rows with more than R entries spill their tail into a small COO overflow
handled by the segment-sum path (exact; typically empty).

**CSR segment-sum scan** (``formulation="coo"``): the O(nnz)-memory
fallback with no padding overhead — right when the nnz/row distribution
is so skewed that ELL padding would dominate memory.

Memory is O(nnz) either way — no densified corpus ever exists. The
``[Q, N]`` score matrix is materialized (fine up to a few million rows at
serving batch sizes — the regime where exact sparse brute force makes
sense at all).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .errors import DimensionMismatchError, InvalidVectorTypeError
from .format.constants import DistanceMetric, VectorType
from .ops.distances import distances_np
from .utils.transfer import put_chunked

# Plain Python float: a module-level jnp scalar would initialize the
# XLA backend at import time, breaking jax.distributed.initialize
# in multi-process programs. Weak-typed, so traced uses are identical.
_NEG_INF = float("-inf")


@functools.partial(
    jax.jit, static_argnames=("k", "metric", "num_rows", "nnz_chunk")
)
def _sparse_topk(
    queries,          # [Q, dim] f32
    cols,             # [nnz_pad] i32 (padded entries point at column 0)
    rows,             # [nnz_pad] i32 (padded entries point at row num_rows)
    values,           # [nnz_pad] f32 (padded entries are 0)
    norms,            # [num_rows] f32 squared norms
    valid_mask,       # [num_rows] f32 or None
    k: int,
    metric: DistanceMetric,
    num_rows: int,
    nnz_chunk: int,
):
    metric = DistanceMetric(metric)
    qn = queries.shape[0]
    nnz_pad = cols.shape[0]
    nchunks = nnz_pad // nnz_chunk

    def body(carry, xs):
        c_cols, c_rows, c_vals = xs
        contrib = queries[:, c_cols] * c_vals[None, :]  # [Q, chunk]
        # scatter-add into this chunk's partial score matrix
        partial = jax.ops.segment_sum(
            contrib.T, c_rows, num_segments=num_rows + 1
        ).T  # [Q, num_rows+1] (last row collects padding)
        return carry + partial[:, :num_rows], None

    xs = (
        cols.reshape(nchunks, nnz_chunk),
        rows.reshape(nchunks, nnz_chunk),
        values.reshape(nchunks, nnz_chunk),
    )
    dots, _ = jax.lax.scan(body, jnp.zeros((qn, num_rows), jnp.float32), xs)

    if metric == DistanceMetric.L2:
        scores = 2.0 * dots - norms[None, :]
    elif metric == DistanceMetric.COSINE:
        scores = dots * jax.lax.rsqrt(jnp.maximum(norms, 1e-30))[None, :]
    else:
        scores = dots
    if valid_mask is not None:
        scores = jnp.where(valid_mask[None, :] != 0, scores, _NEG_INF)
    s, i = jax.lax.top_k(scores, k)
    i = jnp.where(jnp.isneginf(s), -1, i)
    return s, i


def _ell_dots(qt, cols_ell, vals_ell, block_rows):
    """``dots[q, n] = Σ_r qt[cols_ell[n, r], q] · vals_ell[n, r]`` — the
    scatter-free ELL contraction, scanned in ``block_rows`` row blocks to
    bound the gathered ``[B·R, Q]`` tile. Shared by the single-chip and
    sharded kernels."""
    qn = qt.shape[1]
    n_pad, r = cols_ell.shape
    nb = n_pad // block_rows

    def body(_, xs):
        cb, vb = xs  # [B, R] each
        g = jnp.take(qt, cb.reshape(-1), axis=0)        # [B·R, Q]
        contrib = g * vb.reshape(-1)[:, None]
        return None, contrib.reshape(block_rows, r, qn).sum(1)  # [B, Q]

    _, blocks = jax.lax.scan(
        body,
        None,
        (
            cols_ell.reshape(nb, block_rows, r),
            vals_ell.reshape(nb, block_rows, r),
        ),
    )
    return blocks.reshape(n_pad, qn).T  # [Q, n_pad]


def _ovf_add(dots, qt, ovf_cols, ovf_rows, ovf_vals, ovf_chunk):
    """Add the ELL overflow tail (rows wider than the cap) via one small
    segment-sum pass. Padded entries carry row id ``n_pad`` (dropped)."""
    n_pad = dots.shape[1]
    nchunks = ovf_cols.shape[0] // ovf_chunk

    def obody(carry, xs):
        c_cols, c_rows, c_vals = xs
        contrib = jnp.take(qt, c_cols, axis=0) * c_vals[:, None]
        partial = jax.ops.segment_sum(
            contrib, c_rows, num_segments=n_pad + 1
        )  # [n_pad+1, Q] (last row collects padding)
        return carry + partial[:n_pad].T, None

    dots, _ = jax.lax.scan(
        obody,
        dots,
        (
            ovf_cols.reshape(nchunks, ovf_chunk),
            ovf_rows.reshape(nchunks, ovf_chunk),
            ovf_vals.reshape(nchunks, ovf_chunk),
        ),
    )
    return dots


def _ell_scores(dots, norms, metric):
    """Metric epilogue over raw dots (shared single-chip / sharded)."""
    if metric == DistanceMetric.L2:
        return 2.0 * dots - norms[None, :]
    if metric == DistanceMetric.COSINE:
        return dots * jax.lax.rsqrt(jnp.maximum(norms, 1e-30))[None, :]
    return dots


@functools.partial(
    jax.jit,
    static_argnames=(
        "k", "metric", "num_rows", "block_rows", "ovf_chunk", "has_ovf"
    ),
)
def _sparse_topk_ell(
    queries,          # [Q, dim] f32
    cols_ell,         # [n_pad, R] i32 (pad entries: column 0, value 0)
    vals_ell,         # [n_pad, R] f32
    ovf_cols,         # [ovf_pad] i32 (overflow tail entries; may be empty)
    ovf_rows,         # [ovf_pad] i32 (pad entries point at row n_pad)
    ovf_vals,         # [ovf_pad] f32
    norms,            # [n_pad] f32 squared norms (0 on pad rows)
    valid_mask,       # [n_pad] f32 or None
    k: int,
    metric: DistanceMetric,
    num_rows: int,
    block_rows: int,
    ovf_chunk: int,
    has_ovf: bool,
):
    """Scatter-free sparse scoring: fixed-width ELL rows reduce with a
    regular sum; the only gather is an embedding-style row lookup from
    ``queriesᵀ`` (full [Q]-wide rows — the contiguous gather shape).
    Overflow entries (rows wider than R) go through one small
    segment-sum pass. Bit-exact vs :func:`_sparse_topk` up to f32
    addition order."""
    metric = DistanceMetric(metric)
    n_pad = cols_ell.shape[0]
    qt = queries.T  # [dim, Q]
    dots = _ell_dots(qt, cols_ell, vals_ell, block_rows)
    if has_ovf:
        dots = _ovf_add(dots, qt, ovf_cols, ovf_rows, ovf_vals, ovf_chunk)

    scores = _ell_scores(dots, norms, metric)
    row_ok = jnp.arange(n_pad, dtype=jnp.int32) < num_rows
    if valid_mask is not None:
        row_ok = row_ok & (valid_mask != 0)
    scores = jnp.where(row_ok[None, :], scores, _NEG_INF)
    s, i = jax.lax.top_k(scores, k)
    i = jnp.where(jnp.isneginf(s), -1, i)
    return s, i


_ELL_ROW_PAD = 8192  # ELL row count padded to a multiple (block divisor)


class SparseSearchEngine:
    """Exact top-k over one SPARSE space, corpus resident on device —
    ELL + overflow layout by default (scatter-free scoring; see module
    docstring), or CSR/COO with ``formulation="coo"``. Both O(nnz) device memory.

    ``formulation="auto"`` picks ELL unless the nnz/row distribution is
    so skewed that ELL padding would more than triple the entry count
    (then the segment-sum scan's compactness wins)."""

    def __init__(self, space, nnz_chunk: int = 1 << 20, device=None,
                 formulation: str = "auto"):
        if space.info.vector_type != VectorType.SPARSE:
            raise InvalidVectorTypeError(
                f"space {space.name!r} is dense; use SearchEngine"
            )
        if formulation not in ("auto", "ell", "coo"):
            raise ValueError(
                f"formulation must be 'auto', 'ell' or 'coo', got "
                f"{formulation!r}"
            )
        indptr, cols, vals = space.sparse_csr()
        put = (lambda x: jax.device_put(x, device)) if device else jax.device_put
        # Per-call uploads (queries, filter masks) must land on the same
        # device as the resident corpus on multi-device hosts.
        self._put = put
        ip = indptr.astype(np.int64)
        counts = np.diff(ip)
        n = space.num_vectors
        nnz = int(cols.size)
        cols = cols.astype(np.int32)
        vals = vals.astype(np.float32)

        if formulation == "auto":
            # R covering 95% of rows; ELL unless padding explodes entries
            if nnz == 0:
                formulation = "ell"
            else:
                r95 = int(np.percentile(counts, 95))
                r_cap = int(min(counts.max(initial=1), max(8, -(-r95 // 8) * 8)))
                padded_entries = n * r_cap + int(
                    np.maximum(counts - r_cap, 0).sum()
                )
                formulation = "ell" if padded_entries <= 3 * nnz else "coo"
        self.formulation = formulation

        if formulation == "ell":
            if nnz == 0:
                r_cap = 1
            else:
                r95 = int(np.percentile(counts, 95))
                r_cap = int(min(counts.max(initial=1), max(8, -(-r95 // 8) * 8)))
            n_pad = max(_ELL_ROW_PAD, -(-max(n, 1) // _ELL_ROW_PAD) * _ELL_ROW_PAD)
            cols_ell = np.zeros((n_pad, r_cap), np.int32)
            vals_ell = np.zeros((n_pad, r_cap), np.float32)
            if nnz:
                ranks = np.arange(nnz, dtype=np.int64) - np.repeat(
                    ip[:-1], counts
                )
                rows_all = np.repeat(np.arange(n, dtype=np.int64), counts)
                in_ell = ranks < r_cap
                cols_ell[rows_all[in_ell], ranks[in_ell]] = cols[in_ell]
                vals_ell[rows_all[in_ell], ranks[in_ell]] = vals[in_ell]
                ovf = ~in_ell
            else:
                ovf = np.zeros(0, bool)
            n_ovf = int(ovf.sum())
            self._has_ovf = n_ovf > 0
            self.ovf_chunk = min(1 << 13, max(256, n_ovf)) if n_ovf else 256
            opad = (-n_ovf) % self.ovf_chunk if n_ovf else self.ovf_chunk
            self._ovf_cols = put(np.pad(cols[ovf] if nnz else cols, (0, opad)))
            self._ovf_rows = put(
                np.pad(
                    rows_all[ovf].astype(np.int32) if nnz
                    else np.zeros(0, np.int32),
                    (0, opad), constant_values=n_pad,
                )
            )
            self._ovf_vals = put(np.pad(vals[ovf] if nnz else vals, (0, opad)))
            self._cols_ell = put_chunked(cols_ell, device)
            self._vals_ell = put_chunked(vals_ell, device)
            self.r_cap = r_cap
            nrm = np.zeros(n_pad, np.float32)
            nrm[:n] = np.asarray(space.norms()[:n], np.float32)
            self._norms = put(nrm)
            host_mask = space.tombstone_mask()
            if host_mask is not None:
                v = np.zeros(n_pad, np.float32)
                v[:n] = ~host_mask
                self._valid = put(v)
            else:
                self._valid = None
        else:
            rows = np.repeat(np.arange(n, dtype=np.int32), counts)
            self.nnz_chunk = min(nnz_chunk, max(256, nnz)) if nnz else 256
            pad = (-nnz) % self.nnz_chunk if nnz else self.nnz_chunk
            # padded entries: column 0, sentinel row num_vectors, value 0
            self._cols = put(np.pad(cols, (0, pad)))
            self._rows = put(np.pad(rows, (0, pad), constant_values=n))
            self._vals = put(np.pad(vals, (0, pad)))
            self._norms = put(np.asarray(space.norms()[:n], np.float32))
            host_mask = space.tombstone_mask()
            if host_mask is not None:
                self._valid = put((~host_mask).astype(np.float32))
            else:
                self._valid = None
        self.metric = space.metric
        self.dim = space.dim
        self.num_vectors = n
        # Searchable rows (tombstones excluded) — bounds search_radius's
        # "more matches may exist" truncation flag.
        self.num_valid = (
            int(n - np.count_nonzero(host_mask[:n]))
            if host_mask is not None else n
        )
        self.name = space.name
        self.host_ids = space.ids()
        # ELL scan tile override (None = the per-call ~400 MB-bound static
        # pick in :meth:`search`). Set explicitly, by :meth:`autotune`, or
        # adopted from tilings persisted in the file's PerformanceHints.
        from .utils.tune import tuned_hints

        self.block_rows: int | None = None
        h = tuned_hints(space, "sparse")
        if h.get("block_rows"):
            self.block_rows = int(h["block_rows"])
        self._host_space = space

    @property
    def nbytes(self) -> int:
        """Summed device footprint of the resident corpus arrays (used by
        the :class:`~metrovector_tpu.database.Database` memory budget)."""
        arrs = (
            (self._cols_ell, self._vals_ell, self._ovf_cols,
             self._ovf_rows, self._ovf_vals)
            if self.formulation == "ell"
            else (self._cols, self._rows, self._vals)
        )
        total = sum(a.size * a.dtype.itemsize for a in arrs)
        total += self._norms.size * 4
        if self._valid is not None:
            total += self._valid.size * 4
        return total

    def search_radius(self, queries, radius: float, max_results: int = 128,
                      filter_mask=None):
        """Exact range query over the sparse corpus (same semantics as
        :meth:`SearchEngine.search_radius`)."""
        from .engine import radius_from_topk

        k = min(max_results, max(self.num_vectors, 1))
        res = self.search(queries, k=k, filter_mask=filter_mask)
        return radius_from_topk(res, radius, k, self.num_valid)

    def search(self, queries, k: int = 10, filter_mask=None):
        """Batched exact top-k over the sparse corpus. ``queries`` are
        dense ``[Q, dim]`` float vectors (or a single vector).
        ``filter_mask``: optional ``[num_vectors]`` boolean/int row
        predicate (metadata filtering), composed with tombstones —
        excluded rows can never surface; short results pad with ``-1``."""
        from .engine import SearchResult

        q = np.asarray(queries, np.float32)
        if q.ndim == 1:
            q = q[None]
        if q.shape[1] != self.dim:
            raise DimensionMismatchError(expected=self.dim, actual=q.shape[1])
        qnorms = np.einsum("ij,ij->i", q, q, dtype=np.float64).astype(np.float32)
        qk = q
        if self.metric == DistanceMetric.COSINE:
            qk = q / np.maximum(np.sqrt(qnorms)[:, None], 1e-30)
        nq = q.shape[0]
        if self.num_vectors == 0:
            return SearchResult(
                indices=np.full((nq, k), -1, np.int32),
                scores=np.full((nq, k), -np.inf, np.float32),
                distances=np.full(
                    (nq, k),
                    np.inf if self.metric == DistanceMetric.L2 else -np.inf,
                    np.float32,
                ),
                metric=self.metric,
            )
        k_eff = min(k, self.num_vectors)
        eff_valid = self._valid
        if filter_mask is not None:
            from .utils.filters import padded_filter_plane

            mask_len = (
                self._norms.shape[0] if self.formulation == "ell"
                else self.num_vectors
            )
            full = padded_filter_plane(
                filter_mask, self.num_vectors, mask_len
            )
            fdev = self._put(full)
            eff_valid = fdev if eff_valid is None else eff_valid * fdev
        if self.formulation == "ell":
            if self.block_rows is not None:
                b = int(self.block_rows)
                n_pad = int(self._norms.shape[0])
                if b <= 0 or n_pad % b:
                    raise ValueError(
                        f"block_rows {b} must divide the padded row count "
                        f"{n_pad} (powers of two up to {_ELL_ROW_PAD})"
                    )
            else:
                # block size: bound the [B·R, Q] gather tile to ~400 MB
                b = _ELL_ROW_PAD
                while b > 1024 and b * self.r_cap * nq * 4 > 400e6:
                    b //= 2
            s, i = _sparse_topk_ell(
                self._put(qk), self._cols_ell, self._vals_ell,
                self._ovf_cols, self._ovf_rows, self._ovf_vals,
                self._norms, eff_valid, k_eff, self.metric,
                self.num_vectors, b, self.ovf_chunk, self._has_ovf,
            )
        else:
            s, i = _sparse_topk(
                self._put(qk), self._cols, self._rows, self._vals,
                self._norms, eff_valid, k_eff, self.metric,
                self.num_vectors, self.nnz_chunk,
            )
        s, i = np.asarray(s), np.asarray(i)
        dist = distances_np(s, self.metric, qnorms)
        if k_eff < k:
            pad = ((0, 0), (0, k - k_eff))
            i = np.pad(i, pad, constant_values=-1)
            s = np.pad(s, pad, constant_values=-np.inf)
            dist = np.pad(
                dist, pad,
                constant_values=np.inf
                if self.metric == DistanceMetric.L2
                else -np.inf,
            )
        from .engine import ids_for_rows

        return SearchResult(indices=i, scores=s, distances=dist,
                            metric=self.metric,
                            ids=ids_for_rows(self.host_ids, i))

    def autotune(self, queries=None, k: int = 10, batch: int = 128,
                 block_rows_candidates=None, iters: int = 3,
                 apply: bool = True, persist: bool = False) -> list[dict]:
        """Measure candidate ELL scan tiles with single-launch timings and
        optionally apply/persist the fastest (:attr:`block_rows`;
        ``hints["tuned"][space]["sparse"]``). ELL formulation only (the
        COO segment-sum path has no row tile). Candidates must divide the
        padded row count — the defaults (powers of two up to the 8192 row
        pad) always do. The static per-call pick bounds the [B·R, Q]
        gather tile to ~400 MB; measurement replaces that guess with this
        corpus's actual sweet spot."""
        from .utils.tune import measure_candidates

        if self.formulation != "ell":
            raise ValueError(
                "autotune applies to the ELL formulation only"
            )
        if persist and self._host_space is None:
            raise ValueError("persist requires a file-backed space")
        if queries is None:
            rng = np.random.default_rng(0)
            queries = rng.standard_normal((batch, self.dim)).astype(
                np.float32
            )
        if block_rows_candidates is None:
            block_rows_candidates = [1024, 2048, 4096, 8192]
        n_pad = int(self._norms.shape[0])
        candidates = []
        for br in block_rows_candidates:
            cfg: dict = {"block_rows": int(br)}
            if br <= 0 or n_pad % br:
                cfg["skipped"] = (
                    f"block_rows {br} does not divide padded rows {n_pad}"
                )
            candidates.append(cfg)

        def run_with(cfg):
            def run():
                saved = self.block_rows
                self.block_rows = cfg["block_rows"]
                try:
                    self.search(queries, k=k)  # returns host arrays
                finally:
                    self.block_rows = saved
            return run

        results = measure_candidates(candidates, run_with, iters)
        if apply and results and np.isfinite(results[0]["ms"]):
            self.block_rows = results[0]["block_rows"]
            if persist:
                from .utils.tune import persist_tuned

                persist_tuned(
                    self._host_space, "sparse",
                    {"block_rows": self.block_rows},
                )
        elif persist:
            raise RuntimeError(
                "nothing persisted: no finite-time winner to apply "
                f"(apply={apply})"
            )
        return results
