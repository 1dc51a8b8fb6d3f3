"""Multi-device exact search: per-shard top-k scan + candidate merge.

SPMD layout (SURVEY.md §5/§7 step 4):

* corpus rows ``[S·R, D]`` sharded over the mesh's ``shard`` axis (each
  device holds ``[R, D]`` resident in its memory),
* queries ``[Q, D]`` replicated,
* each device runs the single-device scan
  (:func:`~..ops.distances.exact_topk`) over its rows, producing ``[Q, k]``
  local candidates with **global** row ids (local id + shard offset),
* ``all_gather`` over the interconnect yields ``[S, Q, k]`` everywhere (a
  few KB — bandwidth-irrelevant), and a final ``top_k`` over the ``S·k``
  candidates gives the exact global answer, replicated.

This is the multi-device analog of "multiple threads share one mmap reader"
(`src/reader.rs:281-289` in thegenem0/metrovector) — except it actually
scales compute and memory across chips instead of sharing one copy.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..format.constants import DistanceMetric
from ..ops.distances import exact_topk
from .mesh import SHARD_AXIS


@functools.partial(
    jax.jit,
    static_argnames=("k", "metric", "mesh", "axis", "block_rows", "dequant"),
)
def sharded_topk(
    queries: jax.Array,
    db: jax.Array,
    db_norms: jax.Array,
    num_valid,
    k: int,
    metric: DistanceMetric,
    mesh: Mesh,
    valid_mask: jax.Array | None = None,
    axis: str = SHARD_AXIS,
    scale=1.0,
    block_rows: int | None = None,
    bias_row: jax.Array | None = None,
    bias_scale=0.0,
    dequant: tuple[float, float] | None = None,
) -> tuple[jax.Array, jax.Array]:
    """Exact global top-k over a row-sharded corpus.

    ``db``: ``[total_rows, D]`` sharded ``P(axis, None)``; ``db_norms``
    ``[total_rows]`` sharded ``P(axis)``; ``queries`` ``[Q, D]``
    replicated; ``num_valid``: scalar int32 logical row count (global).
    ``scale`` / ``bias_row`` (sharded ``P(axis)``) / ``bias_scale`` /
    ``dequant`` are :func:`~..ops.distances.exact_topk`'s, applied per
    shard. Returns replicated ``(scores [Q, k], indices [Q, k])``,
    best-first, with global row indices.
    """
    total_rows = db.shape[0]
    n_shards = mesh.shape[axis]
    local_rows = total_rows // n_shards
    metric = DistanceMetric(metric)
    num_valid = jnp.asarray(num_valid, dtype=jnp.int32)

    def local_search(q, db_l, norms_l, nvalid, *extras):
        sid = jax.lax.axis_index(axis)
        offset = sid * local_rows
        # Rows this shard owns that are logically valid.
        nvalid_local = jnp.clip(nvalid[0] - offset, 0, local_rows)
        extras = list(extras)
        bias_l = extras.pop(0) if bias_row is not None else None
        mask_l = extras.pop(0) if valid_mask is not None else None
        s, i = exact_topk(
            q, db_l, norms_l, nvalid_local, k, metric, valid_mask=mask_l,
            scale=scale, bias_row=bias_l, bias_scale=bias_scale,
            block_rows=block_rows, dequant=dequant,
        )
        i = jnp.where(i >= 0, i + offset, i)
        # Candidate exchange: [S, Q, k] everywhere.
        all_s = jax.lax.all_gather(s, axis)
        all_i = jax.lax.all_gather(i, axis)
        q_n = s.shape[0]
        cand_s = jnp.moveaxis(all_s, 0, 1).reshape(q_n, n_shards * k)
        cand_i = jnp.moveaxis(all_i, 0, 1).reshape(q_n, n_shards * k)
        best_s, pos = jax.lax.top_k(cand_s, k)
        best_i = jnp.take_along_axis(cand_i, pos, axis=1)
        return best_s, best_i

    in_specs = [
        P(),              # queries replicated
        P(axis, None),    # db rows sharded
        P(axis),          # norms sharded
        P(),              # num_valid replicated
    ]
    args = [queries, db, db_norms, num_valid.reshape(1)]
    if bias_row is not None:
        in_specs.append(P(axis))
        args.append(bias_row)
    if valid_mask is not None:
        in_specs.append(P(axis))
        args.append(valid_mask)

    fn = jax.shard_map(
        local_search,
        mesh=mesh,
        in_specs=tuple(in_specs),
        out_specs=(P(), P()),
        check_vma=False,
    )
    return fn(*args)


@functools.partial(
    jax.jit,
    static_argnames=(
        "k", "rerank", "metric", "mesh", "axis", "exact_lut", "block_rows",
        "packed4",
    ),
)
def sharded_pq_topk(
    queries: jax.Array,
    codes: jax.Array,
    codebooks: jax.Array,
    recon_norms: jax.Array,
    num_valid,
    k: int,
    metric: DistanceMetric,
    mesh: Mesh,
    db: jax.Array | None = None,
    db_norms: jax.Array | None = None,
    rerank: int = 0,
    valid_mask: jax.Array | None = None,
    axis: str = SHARD_AXIS,
    exact_lut: bool = False,
    block_rows: int | None = None,
    packed4: bool = False,
) -> tuple[jax.Array, jax.Array]:
    """Global PQ search over a row-sharded coded corpus.

    ``codes`` ``[total_rows, m]`` (or ``[total_rows, ⌈m/2⌉]`` nibble-packed
    with ``packed4=True``) and ``recon_norms`` ``[total_rows]`` are
    sharded ``P(axis, None)`` / ``P(axis)``; ``codebooks`` and ``queries``
    replicate. Each shard runs :func:`~..index.pq.adc_topk` over its rows.
    With ``rerank=R`` (requires sharded ``db``/``db_norms``),
    each shard rescores its own top-R ADC candidates exactly — candidate
    rows live where their codes live, so re-ranking needs **no cross-shard
    gather**; only the final ``[Q, k]`` lists cross devices. Queries must
    be pre-normalized for cosine. Returns replicated global results."""
    from ..index.pq import _rerank, adc_topk

    total_rows = codes.shape[0]
    n_shards = mesh.shape[axis]
    local_rows = total_rows // n_shards
    metric = DistanceMetric(metric)
    num_valid = jnp.asarray(num_valid, dtype=jnp.int32)
    fetch = max(k, rerank) if rerank else k
    fetch = min(fetch, local_rows)

    def local(q, codes_l, rnorms_l, nvalid, *extras):
        sid = jax.lax.axis_index(axis)
        offset = sid * local_rows
        nvalid_local = jnp.clip(nvalid[0] - offset, 0, local_rows)
        extras = list(extras)
        db_l = extras.pop(0) if db is not None else None
        dnorms_l = extras.pop(0) if db is not None else None
        mask_l = extras.pop(0) if valid_mask is not None else None
        s, i = adc_topk(
            q, codes_l, codebooks, rnorms_l, nvalid_local, fetch, metric,
            valid_mask=mask_l, exact_lut=exact_lut, block_rows=block_rows,
            packed4=packed4,
        )
        if rerank:
            s, i = _rerank(q, db_l, dnorms_l, i, min(k, fetch), metric)
        else:
            s, i = s[:, :k], i[:, :k]
        i = jnp.where(i >= 0, i + offset, i)
        all_s = jax.lax.all_gather(s, axis)
        all_i = jax.lax.all_gather(i, axis)
        q_n = s.shape[0]
        kk = s.shape[1]
        cand_s = jnp.moveaxis(all_s, 0, 1).reshape(q_n, n_shards * kk)
        cand_i = jnp.moveaxis(all_i, 0, 1).reshape(q_n, n_shards * kk)
        best_s, pos = jax.lax.top_k(cand_s, min(k, n_shards * kk))
        best_i = jnp.take_along_axis(cand_i, pos, axis=1)
        return best_s, best_i

    in_specs = [P(), P(axis, None), P(axis), P()]
    args = [queries, codes, recon_norms, num_valid.reshape(1)]
    if db is not None:
        in_specs += [P(axis, None), P(axis)]
        args += [db, db_norms]
    if valid_mask is not None:
        in_specs.append(P(axis))
        args.append(valid_mask)
    fn = jax.shard_map(
        local, mesh=mesh, in_specs=tuple(in_specs), out_specs=(P(), P()),
        check_vma=False,
    )
    return fn(*args)


@functools.partial(
    jax.jit,
    static_argnames=("k", "metric", "mesh", "axis"),
)
def dim_sharded_topk(
    queries: jax.Array,
    db: jax.Array,
    db_norms: jax.Array,
    num_valid,
    k: int,
    metric: DistanceMetric,
    mesh: Mesh,
    valid_mask: jax.Array | None = None,
    axis: str = SHARD_AXIS,
) -> tuple[jax.Array, jax.Array]:
    """Exact global top-k with the corpus sharded over the **dimension**
    axis — the workload's "tensor parallel" mapping (SURVEY.md §5): each
    chip holds every row but only a slice of the feature dimension,
    computes partial dots, and a ``psum`` across devices completes them before
    the epilogue + top-k (replicated).

    Useful when single rows are wide enough that dimension slicing beats
    row slicing (very wide embeddings, or combining with row sharding on a
    2-D mesh). ``db``: ``[N, D_total]`` sharded ``P(None, axis)``;
    ``queries`` ``[Q, D_total]`` sharded the same way; ``db_norms`` and
    ``valid_mask`` replicated ``[N]``.
    """
    metric = DistanceMetric(metric)
    num_valid = jnp.asarray(num_valid, dtype=jnp.int32)

    def local(q, db_l, norms, nvalid, *maybe_mask):
        dots = jax.lax.dot_general(
            q, db_l,
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        dots = jax.lax.psum(dots, axis)  # complete the contraction
        if metric == DistanceMetric.L2:
            scores = 2.0 * dots - norms[None, :]
        elif metric == DistanceMetric.COSINE:
            # caller pre-normalizes queries over the FULL dimension
            scores = dots * jax.lax.rsqrt(jnp.maximum(norms, 1e-30))[None, :]
        else:
            scores = dots
        n = scores.shape[1]
        rows = jax.lax.broadcasted_iota(jnp.int32, (1, n), 1)
        scores = jnp.where(rows < nvalid[0], scores, -jnp.inf)
        if maybe_mask:
            scores = jnp.where(maybe_mask[0][None, :] != 0, scores, -jnp.inf)
        s, i = jax.lax.top_k(scores, k)
        i = jnp.where(jnp.isneginf(s), -1, i)
        return s, i

    in_specs = [P(None, axis), P(None, axis), P(), P()]
    args = [queries, db, db_norms, num_valid.reshape(1)]
    if valid_mask is not None:
        in_specs.append(P())
        args.append(valid_mask)
    fn = jax.shard_map(
        local, mesh=mesh, in_specs=tuple(in_specs), out_specs=(P(), P()),
        check_vma=False,
    )
    return fn(*args)


@functools.partial(
    jax.jit,
    static_argnames=("k", "metric", "mesh", "axis", "block_rows"),
)
def query_sharded_topk(
    queries: jax.Array,
    db: jax.Array,
    db_norms: jax.Array,
    num_valid,
    k: int,
    metric: DistanceMetric,
    mesh: Mesh,
    valid_mask: jax.Array | None = None,
    axis: str = "query",
    block_rows: int | None = None,
    scale=1.0,
    bias_row: jax.Array | None = None,
    bias_scale=0.0,
) -> tuple[jax.Array, jax.Array]:
    """Exact top-k with the QUERY batch sharded and the corpus replicated —
    the throughput-scaling mapping for huge query streams against a corpus
    that fits one device (SURVEY.md §5 "query-batch sharding"). No
    collective at all: each device answers its own queries independently;
    results come back sharded ``P(axis, None)``.

    ``queries`` ``[Q_total, D]`` sharded ``P(axis, None)`` (``Q_total``
    divisible by the axis size); ``db``/``db_norms``/``valid_mask``
    replicated.
    """
    metric = DistanceMetric(metric)
    num_valid = jnp.asarray(num_valid, dtype=jnp.int32)

    def local(q, db_r, norms_r, nvalid, *extras):
        extras = list(extras)
        bias_r = extras.pop(0) if bias_row is not None else None
        mask = extras.pop(0) if valid_mask is not None else None
        return exact_topk(
            q, db_r, norms_r, nvalid[0], k, metric, valid_mask=mask,
            block_rows=block_rows, scale=scale, bias_row=bias_r,
            bias_scale=bias_scale,
        )

    in_specs = [P(axis, None), P(), P(), P()]
    args = [queries, db, db_norms, num_valid.reshape(1)]
    if bias_row is not None:
        in_specs.append(P())
        args.append(bias_row)
    if valid_mask is not None:
        in_specs.append(P())
        args.append(valid_mask)
    fn = jax.shard_map(
        local, mesh=mesh, in_specs=tuple(in_specs),
        out_specs=(P(axis, None), P(axis, None)), check_vma=False,
    )
    return fn(*args)


@functools.partial(
    jax.jit,
    static_argnames=("k", "metric", "mesh", "query_axis", "shard_axis",
                     "block_rows"),
)
def grid_sharded_topk(
    queries: jax.Array,
    db: jax.Array,
    db_norms: jax.Array,
    num_valid,
    k: int,
    metric: DistanceMetric,
    mesh: Mesh,
    valid_mask: jax.Array | None = None,
    query_axis: str = "query",
    shard_axis: str = SHARD_AXIS,
    block_rows: int | None = None,
    scale=1.0,
    bias_row: jax.Array | None = None,
    bias_scale=0.0,
) -> tuple[jax.Array, jax.Array]:
    """Exact top-k on a 2-D ``(query, shard)`` mesh: the corpus rows shard
    over ``shard_axis`` (replicated across ``query_axis``), the query batch
    shards over ``query_axis`` — the composed DP×corpus-parallel mapping
    (``mesh.make_mesh_2d``). Each query sub-batch merges candidates with an
    ``all_gather`` over its row ring only; nothing crosses the query axis.
    Results return sharded ``P(query_axis, None)`` with global row ids.

    ``queries`` ``[Q_total, D]`` sharded ``P(query_axis, None)``; ``db``
    ``[total_rows, D]`` sharded ``P(shard_axis, None)``; ``db_norms`` /
    ``valid_mask`` sharded ``P(shard_axis)``; ``num_valid`` global scalar.
    """
    total_rows = db.shape[0]
    n_shards = mesh.shape[shard_axis]
    local_rows = total_rows // n_shards
    metric = DistanceMetric(metric)
    num_valid = jnp.asarray(num_valid, dtype=jnp.int32)

    def local(q, db_l, norms_l, nvalid, *extras):
        sid = jax.lax.axis_index(shard_axis)
        offset = sid * local_rows
        nvalid_local = jnp.clip(nvalid[0] - offset, 0, local_rows)
        extras = list(extras)
        bias_l = extras.pop(0) if bias_row is not None else None
        mask = extras.pop(0) if valid_mask is not None else None
        s, i = exact_topk(
            q, db_l, norms_l, nvalid_local, k, metric, valid_mask=mask,
            block_rows=block_rows, scale=scale, bias_row=bias_l,
            bias_scale=bias_scale,
        )
        i = jnp.where(i >= 0, i + offset, i)
        all_s = jax.lax.all_gather(s, shard_axis)
        all_i = jax.lax.all_gather(i, shard_axis)
        q_n = s.shape[0]
        cand_s = jnp.moveaxis(all_s, 0, 1).reshape(q_n, n_shards * k)
        cand_i = jnp.moveaxis(all_i, 0, 1).reshape(q_n, n_shards * k)
        best_s, pos = jax.lax.top_k(cand_s, k)
        best_i = jnp.take_along_axis(cand_i, pos, axis=1)
        return best_s, best_i

    in_specs = [P(query_axis, None), P(shard_axis, None), P(shard_axis), P()]
    args = [queries, db, db_norms, num_valid.reshape(1)]
    if bias_row is not None:
        in_specs.append(P(shard_axis))
        args.append(bias_row)
    if valid_mask is not None:
        in_specs.append(P(shard_axis))
        args.append(valid_mask)
    fn = jax.shard_map(
        local, mesh=mesh, in_specs=tuple(in_specs),
        out_specs=(P(query_axis, None), P(query_axis, None)),
        check_vma=False,
    )
    return fn(*args)


class ShardedDeviceSpace:
    """A vector space sharded row-wise across a device mesh.

    Mirrors :class:`~metrovector_tpu.engine.DeviceSpace` but holds
    mesh-sharded arrays; construction pads rows so every shard gets an
    equal tile-aligned slice.
    """

    def __init__(self, space, mesh: Mesh, axis: str = SHARD_AXIS):
        from ..format.constants import DataType, sublane_multiple
        import numpy as np
        from .mesh import shard_rows

        self.mesh = mesh
        self.axis = axis
        self.dim = space.dim
        self.metric = space.metric
        self.num_valid = space.num_vectors
        self.dtype = DataType(space.dtype)
        q = space.quantization
        self.scale = q.scale if q else 1.0
        self.zero_point = q.zero_point if q else 0.0
        self.name = space.name

        sub = sublane_multiple(space.dtype)
        block = space.padded_array()
        self.rowsums = None
        if self.dtype == DataType.UINT8:
            # uint8 offset path (see DeviceSpace.from_space): re-center to
            # int8 and shard the per-row code sums alongside the data.
            shifted = block.astype(np.int16) - 128
            shifted[:, space.dim :] = 0
            shifted[space.num_vectors :, :] = 0
            rowsums = shifted[:, : space.dim].sum(
                axis=1, dtype=np.int32
            ).astype(np.float32)
            block = shifted.astype(np.int8)
            self.rowsums = shard_rows(rowsums, mesh, axis, sublane=sub)
        self.data = shard_rows(block, mesh, axis, sublane=sub)
        self.host_ids = space.ids()
        self.norms = shard_rows(
            np.asarray(space.norms(), np.float32), mesh, axis, sublane=sub
        )
        host_mask = space.tombstone_mask()
        if host_mask is not None:
            full = np.ones(block.shape[0], np.float32)
            full[: space.num_vectors] = (~host_mask).astype(np.float32)
            self.valid_mask = shard_rows(full, mesh, axis, sublane=sub)
        else:
            self.valid_mask = None
        self.padded_dim = int(block.shape[1])
        self._host_rows = int(block.shape[0])
        self._sublane = sub

    def prepare_filter(self, filter_mask):
        """Shard a ``[num_vectors]`` boolean/int row predicate over the
        mesh once (``P(axis)``, riding the same row partitioning as the
        corpus) for reuse across :meth:`search` calls. Returns a
        :class:`~metrovector_tpu.engine.PreparedFilter`."""
        from ..engine import PreparedFilter
        from ..utils.filters import padded_filter_plane
        from .mesh import shard_rows

        full = padded_filter_plane(
            filter_mask, self.num_valid, self._host_rows
        )
        return PreparedFilter(
            mask=shard_rows(full, self.mesh, self.axis,
                            sublane=self._sublane),
            num_valid=self.num_valid,
        )

    def _effective_mask(self, filter_mask):
        """Compose the user predicate with the tombstone plane (both
        sharded ``P(axis)``; the multiply stays shard-local)."""
        if filter_mask is None:
            return self.valid_mask
        from ..engine import PreparedFilter
        from ..utils.filters import checked_prepared_mask

        if isinstance(filter_mask, PreparedFilter):
            fdev = checked_prepared_mask(filter_mask, self.num_valid)
        else:
            fdev = self.prepare_filter(filter_mask).mask
        if self.valid_mask is None:
            return fdev
        return self.valid_mask * fdev

    def search(self, queries, k: int = 10, filter_mask=None):
        """Replicates the query batch and runs the global sharded top-k.
        ``filter_mask``: optional ``[num_vectors]`` boolean/int row
        predicate (or a mesh-prepared one from :meth:`prepare_filter`) —
        applied inside each shard's scan exactly like tombstones, so the
        merge only ever sees filter-passing candidates. Returns a
        :class:`~metrovector_tpu.engine.SearchResult`."""
        return search_row_sharded(
            self, queries, k, self._effective_mask(filter_mask)
        )


def search_row_sharded(sp, queries, k: int, valid_mask):
    """Shared search path of the row-sharded spaces (this module's
    :class:`ShardedDeviceSpace` and ``distributed.DistributedSpace``):
    single-device query preparation (pad / normalize / quantize), the
    replicated :func:`sharded_topk`, then host finalization."""
    import numpy as np

    from ..engine import DeviceSpace, SearchResult
    from ..format.constants import DataType
    from ..ops.distances import distances_np
    from .mesh import replicate
    from .streaming import _ids_for

    helper = DeviceSpace(
        data=sp.data, norms=sp.norms, num_valid=sp.num_valid,
        dim=sp.dim, metric=sp.metric, scale=sp.scale,
        zero_point=sp.zero_point, dtype=sp.dtype,
    )
    prep = helper.prepare_queries(queries)
    k_eff = min(k, max(sp.num_valid, 1))
    qrep = replicate(np.asarray(prep.qdev), sp.mesh)
    kw = {}
    if sp.dtype == DataType.UINT8 and sp.metric == DistanceMetric.COSINE:
        # cosine over affine codes: each shard dequantizes per block
        # (normalized queries cannot quantize exactly), as the
        # single-device engine does
        kw["dequant"] = (128.0 - sp.zero_point, sp.scale)
    else:
        kw.update(scale=prep.dot_scale, bias_row=sp.rowsums,
                  bias_scale=prep.bias_scale)
    s, i = sharded_topk(
        qrep, sp.data, sp.norms, sp.num_valid, k_eff, sp.metric, sp.mesh,
        valid_mask=valid_mask, axis=sp.axis, **kw,
    )
    s, i = np.asarray(s), np.asarray(i)
    if prep.const is not None:
        mult = 2.0 if sp.metric == DistanceMetric.L2 else 1.0
        s = s + mult * prep.const[:, None]
    dist = distances_np(s, sp.metric, prep.sq_norms)
    if k_eff < k:
        pad = ((0, 0), (0, k - k_eff))
        i = np.pad(i, pad, constant_values=-1)
        s = np.pad(s, pad, constant_values=-np.inf)
        dist = np.pad(dist, pad, constant_values=np.inf
                      if sp.metric == DistanceMetric.L2 else -np.inf)
    return SearchResult(indices=i, scores=s, distances=dist,
                        metric=sp.metric, ids=_ids_for(sp.host_ids, i))
