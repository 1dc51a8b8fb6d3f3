"""Multi-chip exact search over SPARSE (CSR) spaces.

The same SPMD recipe as the dense path (``sharded_search.py``): corpus
rows sharded over the mesh's ``shard`` axis, queries replicated, each
chip scores its rows locally and the tiny ``[Q, k]`` candidate lists
merge once across devices. The local scoring is the scatter-free ELL
formulation (``sparse.py`` module docstring — 6.5× the CSR segment-sum
scan on one chip), with each shard carrying its own overflow tail.

Reference analog: none — the reference declares ``VectorType::Sparse``
but cannot encode or search it (``schema/types.fbs:14-17``), let alone
distribute it.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..errors import DimensionMismatchError, InvalidVectorTypeError
from ..format.constants import DistanceMetric, VectorType
from ..sparse import _ELL_ROW_PAD, _ell_dots, _ell_scores, _ovf_add
from .mesh import SHARD_AXIS, replicate

# Plain Python float: a module-level jnp scalar would initialize the
# XLA backend at import time, breaking jax.distributed.initialize
# in multi-process programs. Weak-typed, so traced uses are identical.
_NEG_INF = float("-inf")


@functools.partial(
    jax.jit,
    static_argnames=(
        "k", "metric", "mesh", "axis", "rows_per", "block_rows",
        "ovf_chunk", "has_ovf",
    ),
)
def sharded_sparse_topk(
    queries,        # [Q, dim] f32, replicated
    cols_ell,       # [S·n_pad_l, R] i32, row-sharded
    vals_ell,       # [S·n_pad_l, R] f32, row-sharded
    ovf_cols,       # [S·W] i32, row-sharded (LOCAL overflow per shard)
    ovf_rows,       # [S·W] i32, LOCAL row ids (sentinel n_pad_l = pad)
    ovf_vals,       # [S·W] f32
    norms,          # [S·n_pad_l] f32, row-sharded (0 on pad rows)
    valid_mask,     # [S·n_pad_l] f32 or None, row-sharded
    num_rows,       # scalar i32: GLOBAL logical row count
    k: int,
    metric: DistanceMetric,
    mesh: Mesh,
    rows_per: int,  # logical rows owned per shard (global id = local + sid·rows_per)
    axis: str = SHARD_AXIS,
    block_rows: int = _ELL_ROW_PAD,
    ovf_chunk: int = 256,
    has_ovf: bool = False,
):
    """Exact global top-k over a row-sharded sparse (ELL) corpus.
    Returns replicated ``(scores [Q, k], indices [Q, k])``, best-first,
    with global row indices (−1 sentinels past the valid tail)."""
    metric = DistanceMetric(metric)
    n_shards = mesh.shape[axis]
    n_pad_l = cols_ell.shape[0] // n_shards
    num_rows = jnp.asarray(num_rows, jnp.int32)

    def local(q, ce, ve, oc, orow, ov, nrm, *maybe_mask):
        sid = jax.lax.axis_index(axis)
        qt = q.T
        dots = _ell_dots(qt, ce, ve, block_rows)
        if has_ovf:
            dots = _ovf_add(dots, qt, oc, orow, ov, ovf_chunk)
        scores = _ell_scores(dots, nrm, metric)
        nvalid_local = jnp.clip(maybe_mask[-1][0] - sid * rows_per, 0,
                                rows_per)
        row_ok = jnp.arange(n_pad_l, dtype=jnp.int32) < nvalid_local
        if valid_mask is not None:
            row_ok = row_ok & (maybe_mask[0] != 0)
        scores = jnp.where(row_ok[None, :], scores, _NEG_INF)
        s, i = jax.lax.top_k(scores, k)
        i = jnp.where(jnp.isneginf(s), -1, i + sid * rows_per)
        all_s = jax.lax.all_gather(s, axis)
        all_i = jax.lax.all_gather(i, axis)
        q_n = s.shape[0]
        cand_s = jnp.moveaxis(all_s, 0, 1).reshape(q_n, n_shards * k)
        cand_i = jnp.moveaxis(all_i, 0, 1).reshape(q_n, n_shards * k)
        best_s, pos = jax.lax.top_k(cand_s, k)
        best_i = jnp.take_along_axis(cand_i, pos, axis=1)
        return best_s, best_i

    in_specs = [
        P(),            # queries replicated
        P(axis, None),  # ELL cols
        P(axis, None),  # ELL vals
        P(axis),        # overflow cols
        P(axis),        # overflow rows (local ids)
        P(axis),        # overflow vals
        P(axis),        # norms
    ]
    args = [queries, cols_ell, vals_ell, ovf_cols, ovf_rows, ovf_vals,
            norms]
    if valid_mask is not None:
        in_specs.append(P(axis))
        args.append(valid_mask)
    in_specs.append(P())  # num_rows replicated
    args.append(num_rows.reshape(1))

    fn = jax.shard_map(
        local, mesh=mesh, in_specs=tuple(in_specs), out_specs=(P(), P()),
        check_vma=False,
    )
    return fn(*args)


class ShardedSparseSearchEngine:
    """Exact top-k over one SPARSE space row-sharded across a device
    mesh: each chip holds its slice of the ELL layout (plus its own
    overflow tail) resident on device; results match the single-chip
    :class:`~metrovector_tpu.sparse.SparseSearchEngine` bit-for-rank."""

    def __init__(self, space, mesh: Mesh, axis: str = SHARD_AXIS,
                 device=None):
        if space.info.vector_type != VectorType.SPARSE:
            raise InvalidVectorTypeError(
                f"space {space.name!r} is dense; use ShardedDeviceSpace"
            )
        self.mesh = mesh
        self.axis = axis
        n_shards = mesh.shape[axis]
        indptr, cols, vals = space.sparse_csr()
        ip = indptr.astype(np.int64)
        counts = np.diff(ip)
        n = space.num_vectors
        nnz = int(cols.size)
        cols = cols.astype(np.int32)
        vals = vals.astype(np.float32)

        # Global ELL width (uniform across shards; single-chip rule).
        if nnz == 0:
            r_cap = 1
        else:
            r95 = int(np.percentile(counts, 95))
            r_cap = int(min(counts.max(initial=1), max(8, -(-r95 // 8) * 8)))
        rows_per = -(-max(n, 1) // n_shards)
        n_pad_l = max(_ELL_ROW_PAD,
                      -(-rows_per // _ELL_ROW_PAD) * _ELL_ROW_PAD)

        cols_ell = np.zeros((n_shards * n_pad_l, r_cap), np.int32)
        vals_ell = np.zeros((n_shards * n_pad_l, r_cap), np.float32)
        ovf_per_shard: list[list[tuple[int, int, float]]] = [
            [] for _ in range(n_shards)
        ]
        if nnz:
            ranks = np.arange(nnz, dtype=np.int64) - np.repeat(
                ip[:-1], counts
            )
            rows_all = np.repeat(np.arange(n, dtype=np.int64), counts)
            shard_of = rows_all // rows_per
            local_row = rows_all - shard_of * rows_per
            stored = shard_of * n_pad_l + local_row  # padded global slot
            in_ell = ranks < r_cap
            cols_ell[stored[in_ell], ranks[in_ell]] = cols[in_ell]
            vals_ell[stored[in_ell], ranks[in_ell]] = vals[in_ell]
            ovf = ~in_ell
            for s, lr, c, v in zip(shard_of[ovf], local_row[ovf],
                                   cols[ovf], vals[ovf]):
                ovf_per_shard[int(s)].append((int(lr), int(c), float(v)))
        max_ovf = max((len(o) for o in ovf_per_shard), default=0)
        self._has_ovf = max_ovf > 0
        self.ovf_chunk = min(1 << 13, max(256, max_ovf)) if max_ovf else 256
        w = (-(-max_ovf // self.ovf_chunk) * self.ovf_chunk
             if max_ovf else self.ovf_chunk)
        ovf_cols = np.zeros((n_shards, w), np.int32)
        ovf_rows = np.full((n_shards, w), n_pad_l, np.int32)
        ovf_vals = np.zeros((n_shards, w), np.float32)
        for s, entries in enumerate(ovf_per_shard):
            for j, (lr, c, v) in enumerate(entries):
                ovf_rows[s, j] = lr
                ovf_cols[s, j] = c
                ovf_vals[s, j] = v

        nrm = np.zeros(n_shards * n_pad_l, np.float32)
        sp_norms = np.asarray(space.norms()[:n], np.float32)
        host_mask = space.tombstone_mask()
        vmask = None if host_mask is None else np.zeros(
            n_shards * n_pad_l, np.float32
        )
        for s in range(n_shards):
            lo, hi = s * rows_per, min((s + 1) * rows_per, n)
            if lo >= hi:
                continue
            nrm[s * n_pad_l: s * n_pad_l + (hi - lo)] = sp_norms[lo:hi]
            if vmask is not None:
                vmask[s * n_pad_l: s * n_pad_l + (hi - lo)] = (
                    ~host_mask[lo:hi]
                )

        def put2d(a):
            return jax.device_put(a, NamedSharding(mesh, P(axis, None)))

        def put1d(a):
            return jax.device_put(a, NamedSharding(mesh, P(axis)))

        self._cols_ell = put2d(cols_ell)
        self._vals_ell = put2d(vals_ell)
        self._ovf_cols = put1d(ovf_cols.reshape(-1))
        self._ovf_rows = put1d(ovf_rows.reshape(-1))
        self._ovf_vals = put1d(ovf_vals.reshape(-1))
        self._norms = put1d(nrm)
        self._valid = None if vmask is None else put1d(vmask)
        self.r_cap = r_cap
        self.rows_per = rows_per
        self.n_pad_l = n_pad_l
        self.metric = space.metric
        self.dim = space.dim
        self.num_vectors = n
        self.name = space.name
        self.host_ids = space.ids()

    def search(self, queries, k: int = 10):
        """Batched exact top-k, merged across devices — global row indices
        (and stable IDs), identical to the single-chip sparse engine."""
        from ..engine import SearchResult, ids_for_rows
        from ..ops.distances import distances_np

        q = np.asarray(queries, np.float32)
        if q.ndim == 1:
            q = q[None]
        if q.shape[1] != self.dim:
            raise DimensionMismatchError(expected=self.dim, actual=q.shape[1])
        qnorms = np.einsum("ij,ij->i", q, q, dtype=np.float64).astype(
            np.float32
        )
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
        b = self.n_pad_l
        while b > 1024 and b * self.r_cap * nq * 4 > 400e6:
            b //= 2
        s, i = sharded_sparse_topk(
            replicate(qk, self.mesh), self._cols_ell, self._vals_ell,
            self._ovf_cols, self._ovf_rows, self._ovf_vals, self._norms,
            self._valid, self.num_vectors, k_eff, self.metric, self.mesh,
            self.rows_per, axis=self.axis, block_rows=b,
            ovf_chunk=self.ovf_chunk, has_ovf=self._has_ovf,
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
        return SearchResult(indices=i, scores=s, distances=dist,
                            metric=self.metric,
                            ids=ids_for_rows(self.host_ids, i))
