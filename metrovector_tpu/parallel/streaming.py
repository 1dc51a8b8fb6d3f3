"""Host-memory → device streamed exact search for corpora larger than
device memory.

SURVEY.md §7 step 5: the corpus stays in host memory (mmap-backed numpy
views of the MVT file — nothing is ever decoded), and fixed-size row chunks
are uploaded and searched in a pipeline:

    upload chunk j+1  (async H2D)   ─┐ overlapped: jax dispatch is async,
    scan on chunk j                 ─┘ so the next copy rides under compute

A running candidate list (scores + global indices) is carried on-device
across chunks and merged with each chunk's local top-k — the analog of the
reference's chunked iteration (`src/vectors/iterator.rs:62-81` in
thegenem0/metrovector), except the "iterator" yields device-resident tiles and
the merge is exact top-k, so results are independent of chunk order and
identical to a fully-resident search.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .. import native
from ..format.constants import DataType, DistanceMetric
from ..ops.distances import exact_topk
from ..vectors.space import VectorSpace


@functools.partial(jax.jit, static_argnames=("k",), donate_argnums=(0, 1))
def _merge_topk(best_s, best_i, s, i, k: int):
    """Merge a chunk's candidates into the carried best list (donated —
    updated in place on device)."""
    cand_s = jnp.concatenate([best_s, s], axis=1)
    cand_i = jnp.concatenate([best_i, i], axis=1)
    top_s, pos = jax.lax.top_k(cand_s, k)
    top_i = jnp.take_along_axis(cand_i, pos, axis=1)
    return top_s, top_i



def _ids_for(host_ids, idx):
    """Alias of :func:`..engine.ids_for_rows` (kept for the parallel
    modules' imports)."""
    from ..engine import ids_for_rows

    return ids_for_rows(host_ids, idx)


class StreamingSearcher:
    """Exact top-k over a host-resident (mmap) space, streamed chunk-wise.

    ``chunk_rows`` controls the device working set: two chunks are in flight
    (double buffering), so peak device memory ≈ ``2 · chunk_rows ·
    padded_dim · itemsize``. Results are bit-identical to a resident
    :class:`~metrovector_tpu.engine.SearchEngine` search.
    """

    def __init__(
        self,
        space: VectorSpace,
        chunk_rows: int | None = None,
        device=None,
    ):
        if chunk_rows is None:
            # file-manifest performance hint, else 131072 rows per chunk
            chunk_rows = int(
                space.reader.manifest.hints.get("stream_chunk_rows", 131_072)
            )
        self.space = space
        self.device = device
        self.metric = space.metric
        self.dtype = DataType(space.dtype)
        q = space.quantization
        self.scale = q.scale if q else 1.0
        self.dim = space.dim
        # Chunk boundary must respect sublane tiling so every chunk keeps
        # the block's native layout (pure views, no copies).
        from ..format.constants import sublane_multiple

        sub = sublane_multiple(space.dtype)
        # Clamp to the corpus itself — a chunk larger than the block would
        # only pad the upload for nothing.
        chunk_rows = min(chunk_rows, space.padded_rows)
        self.chunk_rows = max(sub, (chunk_rows // sub) * sub)
        self._block = space.padded_array()
        self._norms = np.asarray(space.norms(), dtype=np.float32)
        host_mask = space.tombstone_mask()
        if host_mask is not None:
            self._mask = np.ones(space.padded_rows, dtype=np.float32)
            self._mask[: space.num_vectors] = (~host_mask).astype(np.float32)
        else:
            self._mask = None
        self._host_ids = space.ids()

    def _effective_mask(self, filter_mask):
        """Compose a host ``[num_vectors]`` predicate with the tombstone
        plane into the padded per-chunk mask (host-side — streamed chunks
        slice it alongside the data, so a per-search filter costs one
        host multiply, no resident device state)."""
        if filter_mask is None:
            return self._mask
        from ..utils.filters import padded_filter_plane

        sp = self.space
        full = padded_filter_plane(
            filter_mask, sp.num_vectors, sp.padded_rows
        )
        return full if self._mask is None else self._mask * full

    def search(self, queries, k: int = 10, filter_mask=None):
        """Stream all chunks and return a
        :class:`~metrovector_tpu.engine.SearchResult`. ``filter_mask``:
        optional ``[num_vectors]`` boolean/int row predicate (host array)
        composed with tombstones and streamed chunk-wise with the data —
        results are bit-identical to a filtered resident search."""
        from ..engine import DeviceSpace, SearchResult
        from ..ops.distances import distances_np

        sp = self.space
        q_meta = sp.quantization
        helper = DeviceSpace(
            data=jnp.zeros((0, sp.padded_dim), dtype=self._block.dtype),
            norms=jnp.zeros((0,), jnp.float32),
            num_valid=sp.num_vectors, dim=sp.dim, metric=self.metric,
            scale=self.scale,
            zero_point=q_meta.zero_point if q_meta else 0.0,
            dtype=self.dtype,
        )
        uint8_offset = (
            self.dtype == DataType.UINT8
            and self.metric != DistanceMetric.COSINE
        )
        # uint8 + cosine: normalized float queries can't quantize exactly,
        # so each chunk is dequantized host-side to f32 ((c − zp)·scale —
        # memory-speed numpy) and served by the exact f32 HIGHEST scan.
        # Costs 4× the upload bytes of the code chunk; correctness first.
        uint8_cosine = self.dtype == DataType.UINT8 and not uint8_offset
        zp = q_meta.zero_point if q_meta else 0.0
        mask_host = self._effective_mask(filter_mask)
        prep = helper.prepare_queries(queries)
        qdev, qnorms = prep.qdev, prep.sq_norms
        nq = qdev.shape[0]
        if sp.num_vectors == 0:
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
        k_eff = min(k, sp.num_vectors)

        cr = self.chunk_rows
        total = sp.padded_rows
        nchunks = -(-total // cr)
        put = (
            (lambda x: jax.device_put(x, self.device))
            if self.device
            else jax.device_put
        )

        best_s = jnp.full((nq, k_eff), -jnp.inf, jnp.float32)
        best_i = jnp.full((nq, k_eff), -1, jnp.int32)

        # Pre-issue the first upload, then pipeline: while the scan chews
        # chunk j, the (async) H2D copy of chunk j+1 is in flight.
        def slice_chunk(j):
            # Per-chunk host prep is the streamed pipeline's critical path
            # on prep-bound hosts, so each transform has a fused native
            # single-pass (OpenMP/F16C, writes the padded output directly)
            # with the original numpy twin as fallback — bit-identical,
            # both covered by test_streaming.py.
            lo = j * cr
            hi = min(lo + cr, total)
            blk = self._block[lo:hi]
            pad = cr - (hi - lo)
            nvalid_here = int(np.clip(sp.num_vectors - lo, 0, hi - lo))
            bias = None
            blk_done = False  # native prep already produced [cr, D]
            if blk.dtype == np.float16:
                # host-side upcast (F16C/numpy, at memory speed): the
                # resident engine scores f16 corpora as f32 too
                out = native.prep_f16_to_f32(blk, cr)
                if out is not None:
                    blk, blk_done = out, True
                else:
                    blk = blk.astype(np.float32)
            if uint8_cosine:
                out = native.prep_u8_dequant(
                    blk, cr, float(self.scale), float(zp)
                )
                if out is not None:
                    blk, blk_done = out, True
                else:
                    blk = (blk.astype(np.float32) - zp) * self.scale
            if uint8_offset:
                # Re-center this chunk's codes (c' = c − 128 over the
                # logical region) and compute the per-row code sums.
                out = native.prep_u8_offset(blk, cr, sp.dim, nvalid_here)
                if out is not None:
                    (blk, bias), blk_done = out, True
                else:
                    shifted = blk.astype(np.int16) - 128
                    shifted[:, sp.dim :] = 0
                    shifted[nvalid_here:, :] = 0
                    bias = shifted[:, : sp.dim].sum(
                        axis=1, dtype=np.int32
                    ).astype(np.float32)
                    blk = shifted.astype(np.int8)
            nrm = self._norms[lo:hi]
            msk = mask_host[lo:hi] if mask_host is not None else None
            if pad:  # keep shapes static for the jitted scan
                if not blk_done:
                    blk = np.pad(blk, ((0, pad), (0, 0)))
                    if bias is not None:
                        bias = np.pad(bias, (0, pad))
                nrm = np.pad(nrm, (0, pad))
                if msk is not None:
                    msk = np.pad(msk, (0, pad))
            return blk, nrm, msk, bias

        def upload(j):
            blk, nrm, msk, bias = slice_chunk(j)
            return (
                put(blk), put(nrm),
                (put(msk) if msk is not None else None),
                (put(bias) if bias is not None else None),
            )

        nxt = upload(0)
        for j in range(nchunks):
            blk_d, nrm_d, msk_d, bias_d = nxt
            if j + 1 < nchunks:
                nxt = upload(j + 1)
            nvalid_local = np.int32(
                np.clip(sp.num_vectors - j * cr, 0, cr)
            )
            s, i = exact_topk(
                qdev, blk_d, nrm_d, nvalid_local, k_eff, self.metric,
                valid_mask=msk_d, scale=prep.dot_scale,
                bias_row=bias_d, bias_scale=prep.bias_scale,
            )
            i = jnp.where(i >= 0, i + j * cr, i)
            best_s, best_i = _merge_topk(best_s, best_i, s, i, k_eff)

        s = np.asarray(best_s)
        i = np.asarray(best_i)
        if prep.const is not None:
            mult = 2.0 if self.metric == DistanceMetric.L2 else 1.0
            s = s + mult * prep.const[:, None]
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
                            ids=_ids_for(self._host_ids, i))


# ----------------------------------------------- multi-device streaming ---


@functools.partial(
    jax.jit,
    static_argnames=(
        "k", "metric", "mesh", "axis", "per", "chunk_rows", "has_bias",
        "has_mask",
    ),
    donate_argnums=(3, 4),
)
def _sharded_stream_step(
    q, chunk, chunk_norms, best_s, best_i, nvalid, j, *extras,
    k: int, metric: DistanceMetric, mesh, axis: str, per: int,
    chunk_rows: int, scale=1.0, bias_scale=0.0, has_bias: bool = False, has_mask: bool = False,
):
    """One streamed step on every shard at once: shard ``d`` searches ITS
    chunk ``j`` (rows ``d·per + j·chunk_rows …``) and merges into its own
    carried candidate slice. No collective — the cross-device merge
    happens once, at the end (:func:`_sharded_stream_merge`). Carried best
    lists are donated (updated in place in each shard's memory)."""
    from jax.sharding import PartitionSpec as P

    metric = DistanceMetric(metric)

    def local(qr, blk, nrm, bs, bi, nv, jj, *ex):
        sid = jax.lax.axis_index(axis)
        lo = sid * per + jj[0] * chunk_rows
        # Valid rows in THIS chunk: the shard's logical row count
        # (global count clipped to its range) minus the chunk offset.
        # Clipping only against the global count would mark a final
        # chunk's zero-padding tail valid — and its global ids alias the
        # NEXT shard's first rows.
        shard_valid = jnp.clip(nv[0] - sid * per, 0, per)
        nvalid_local = jnp.clip(
            shard_valid - jj[0] * chunk_rows, 0, chunk_rows
        )
        ex = list(ex)
        bias_l = ex.pop(0) if has_bias else None
        mask_l = ex.pop(0) if has_mask else None
        # A chunk can hold fewer rows than k; the carried k-wide list
        # absorbs the shortfall at the merge.
        k_loc = min(k, chunk_rows)
        s, i = exact_topk(
            qr, blk, nrm, nvalid_local, k_loc, metric, valid_mask=mask_l,
            scale=scale, bias_row=bias_l, bias_scale=bias_scale,
        )
        i = jnp.where(i >= 0, i + lo, i)
        cand_s = jnp.concatenate([bs[0], s], axis=1)
        cand_i = jnp.concatenate([bi[0], i], axis=1)
        ts, pos = jax.lax.top_k(cand_s, k)
        ti = jnp.take_along_axis(cand_i, pos, axis=1)
        return ts[None], ti[None]

    in_specs = [
        P(),               # queries replicated
        P(axis, None),     # this step's chunk rows, sharded
        P(axis),           # chunk norms
        P(axis, None, None),  # carried best scores [S, Q, k]
        P(axis, None, None),  # carried best indices
        P(),               # num_valid (replicated [1])
        P(),               # chunk ordinal j (replicated [1])
    ]
    args = [q, chunk, chunk_norms, best_s, best_i, nvalid, j]
    for e in extras:
        in_specs.append(P(axis))
        args.append(e)
    fn = jax.shard_map(
        local, mesh=mesh, in_specs=tuple(in_specs),
        out_specs=(P(axis, None, None), P(axis, None, None)),
        check_vma=False,
    )
    return fn(*args)


@functools.partial(jax.jit, static_argnames=("k", "mesh", "axis"))
def _sharded_stream_merge(best_s, best_i, k: int, mesh, axis: str):
    """Final cross-device candidate exchange: ``all_gather`` the per-shard carried
    lists (a few KB) and reduce to the replicated global top-k."""
    from jax.sharding import PartitionSpec as P

    def local(bs, bi):
        all_s = jax.lax.all_gather(bs[0], axis)  # [S, Q, k]
        all_i = jax.lax.all_gather(bi[0], axis)
        s_n, q_n = all_s.shape[0], all_s.shape[1]
        cand_s = jnp.moveaxis(all_s, 0, 1).reshape(q_n, s_n * k)
        cand_i = jnp.moveaxis(all_i, 0, 1).reshape(q_n, s_n * k)
        ts, pos = jax.lax.top_k(cand_s, k)
        ti = jnp.take_along_axis(cand_i, pos, axis=1)
        return ts, ti

    fn = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(axis, None, None), P(axis, None, None)),
        out_specs=(P(), P()),
        check_vma=False,
    )
    return fn(best_s, best_i)


class ShardedStreamingSearcher:
    """Exact top-k over a corpus larger than **aggregate** device memory:
    every shard streams its own row range host→device (double-buffered, as
    in :class:`StreamingSearcher`), carries per-shard candidates across
    chunks, and merges once across devices at the end.

    Row ownership matches
    :func:`..parallel.distributed.load_space_sharded` (shard ``d`` owns
    rows ``[d·per, (d+1)·per)``), so on multi-host clusters each host only
    touches (and pages in) its own devices' byte ranges of the mmap.
    Results are bit-identical to a fully-resident
    :func:`..parallel.sharded_search.sharded_topk` search — chunk order
    never changes the exact top-k merge. Reference analog: single-host
    chunked iteration, ``src/vectors/iterator.rs:62-81``.
    """

    def __init__(
        self,
        space: VectorSpace,
        mesh=None,
        axis: str | None = None,
        chunk_rows: int | None = None,
    ):
        from ..format.constants import sublane_multiple
        from .distributed import global_mesh
        from .mesh import SHARD_AXIS, rows_per_shard

        axis = axis or SHARD_AXIS
        if mesh is None:
            mesh = global_mesh(axis)
        if chunk_rows is None:
            chunk_rows = int(
                space.reader.manifest.hints.get("stream_chunk_rows", 131_072)
            )
        self.space = space
        self.mesh = mesh
        self.axis = axis
        self.metric = space.metric
        self.dtype = DataType(space.dtype)
        q = space.quantization
        self.scale = q.scale if q else 1.0
        self.zero_point = q.zero_point if q else 0.0
        self.dim = space.dim

        n_shards = mesh.shape[axis]
        sub = sublane_multiple(space.dtype)
        self.per = rows_per_shard(space.padded_rows, n_shards, sub)
        per_chunk = min(chunk_rows, self.per)
        self.chunk_rows = max(sub, (per_chunk // sub) * sub)
        self.nchunks = -(-self.per // self.chunk_rows)
        self.n_shards = n_shards

        self._block = space.padded_array()
        self._norms = np.asarray(space.norms(), dtype=np.float32)
        host_mask = space.tombstone_mask()
        if host_mask is not None:
            self._mask = np.ones(space.padded_rows, dtype=np.float32)
            self._mask[: space.num_vectors] = (~host_mask).astype(np.float32)
        else:
            self._mask = None
        self._host_ids = space.ids()
        self._devices = list(mesh.devices.reshape(-1))

    # -- chunk assembly -------------------------------------------------------

    def _prep_piece(self, piece: np.ndarray, lo: int, uint8_offset: bool,
                    uint8_cosine: bool):
        """Per-slice transforms (f16 upcast, uint8 recenter/dequant) —
        the multi-shard mirror of ``StreamingSearcher``'s chunk prep."""
        sp = self.space
        bias = None
        n = piece.shape[0]
        if piece.dtype == np.float16:
            out = native.prep_f16_to_f32(piece, n) if n else None
            piece = out if out is not None else piece.astype(np.float32)
        if uint8_cosine:
            out = (
                native.prep_u8_dequant(
                    piece, n, float(self.scale), float(self.zero_point)
                )
                if n
                else None
            )
            if out is not None:
                piece = out
            else:
                piece = (
                    piece.astype(np.float32) - self.zero_point
                ) * self.scale
        if uint8_offset:
            local_valid = int(np.clip(sp.num_vectors - lo, 0, n))
            out = (
                native.prep_u8_offset(piece, n, sp.dim, local_valid)
                if n
                else None
            )
            if out is not None:
                piece, bias = out
            else:
                shifted = piece.astype(np.int16) - 128
                shifted[:, sp.dim:] = 0
                shifted[local_valid:, :] = 0
                bias = shifted[:, : sp.dim].sum(
                    axis=1, dtype=np.int32
                ).astype(np.float32)
                piece = shifted.astype(np.int8)
        return piece, bias

    def _assemble(self, host_array, spec_cols: int, j: int, transform):
        """Global ``[S·chunk_rows, …]`` array for streamed step ``j``:
        device ``d`` gets (a view of) rows ``d·per + j·cr …`` of its own
        range — remote hosts' rows are never touched locally."""
        from jax.sharding import NamedSharding, PartitionSpec as P

        cr = self.chunk_rows
        shards = []
        tail = None
        for di, dev in enumerate(self._devices):
            if dev.process_index != jax.process_index():
                continue
            lo = di * self.per + j * cr
            hi = min(lo + cr, min((di + 1) * self.per,
                                  host_array.shape[0]))
            piece = np.asarray(host_array[lo:max(lo, hi)])
            piece = transform(piece, lo)
            if tail is None:
                tail = piece.shape[1:]
            if piece.shape[0] < cr:
                pw = ((0, cr - piece.shape[0]),) + ((0, 0),) * (
                    piece.ndim - 1
                )
                piece = np.pad(piece, pw)
            shards.append(jax.device_put(piece, dev))
        spec = P(self.axis, *([None] * spec_cols))
        sharding = NamedSharding(self.mesh, spec)
        shape_global = (self.n_shards * cr,) + tuple(tail)
        return jax.make_array_from_single_device_arrays(
            shape_global, sharding, shards
        )

    def _upload_chunk(self, j: int, uint8_offset: bool, uint8_cosine: bool,
                      mask_host=None):
        biases = {}

        def data_tf(piece, lo):
            out, bias = self._prep_piece(
                piece, lo, uint8_offset, uint8_cosine
            )
            biases[lo] = bias
            return out

        data = self._assemble(self._block, 1, j, data_tf)
        norms = self._assemble(self._norms, 0, j, lambda p, lo: p)
        bias = None
        if uint8_offset:
            bias = self._assemble(
                self._norms, 0, j,
                lambda p, lo: biases[lo][: p.shape[0]]
                if biases.get(lo) is not None
                else np.zeros_like(p),
            )
        mask = None
        if mask_host is not None:
            mask = self._assemble(mask_host, 0, j, lambda p, lo: p)
        return data, norms, bias, mask

    def _effective_mask(self, filter_mask):
        """Compose a host ``[num_vectors]`` predicate with the tombstone
        plane; each shard only slices (and uploads) its own rows of the
        result, like the data chunks themselves."""
        if filter_mask is None:
            return self._mask
        from ..utils.filters import padded_filter_plane

        sp = self.space
        full = padded_filter_plane(
            filter_mask, sp.num_vectors, sp.padded_rows
        )
        return full if self._mask is None else self._mask * full

    # -- search ---------------------------------------------------------------

    def search(self, queries, k: int = 10, filter_mask=None):
        """Stream every shard's chunks and return a replicated
        :class:`~metrovector_tpu.engine.SearchResult` (global row ids +
        stable external IDs). ``filter_mask``: optional ``[num_vectors]``
        boolean/int host row predicate, composed with tombstones and
        streamed alongside each shard's chunks — bit-identical to the
        filtered resident sharded search."""
        from ..engine import DeviceSpace, SearchResult
        from ..ops.distances import distances_np
        from .mesh import replicate

        sp = self.space
        helper = DeviceSpace(
            data=jnp.zeros((0, sp.padded_dim), dtype=self._block.dtype),
            norms=jnp.zeros((0,), jnp.float32),
            num_valid=sp.num_vectors, dim=sp.dim, metric=self.metric,
            scale=self.scale, zero_point=self.zero_point, dtype=self.dtype,
        )
        uint8_offset = (
            self.dtype == DataType.UINT8
            and self.metric != DistanceMetric.COSINE
        )
        uint8_cosine = self.dtype == DataType.UINT8 and not uint8_offset
        mask_host = self._effective_mask(filter_mask)
        prep = helper.prepare_queries(queries)
        nq = prep.qdev.shape[0]
        if sp.num_vectors == 0:
            return SearchResult(
                indices=np.full((nq, k), -1, np.int32),
                scores=np.full((nq, k), -np.inf, np.float32),
                distances=np.full(
                    (nq, k),
                    np.inf if self.metric == DistanceMetric.L2 else -np.inf,
                    np.float32,
                ),
                metric=self.metric,
                ids=np.full((nq, k), SearchResult.ID_SENTINEL, np.uint64),
            )
        k_eff = min(k, sp.num_vectors)
        qrep = replicate(np.asarray(prep.qdev), self.mesh)

        from jax.sharding import NamedSharding, PartitionSpec as P

        carried = NamedSharding(self.mesh, P(self.axis, None, None))
        best_s = jax.device_put(
            np.full((self.n_shards, nq, k_eff), -np.inf, np.float32),
            carried,
        )
        best_i = jax.device_put(
            np.full((self.n_shards, nq, k_eff), -1, np.int32), carried
        )
        nvalid = replicate(
            np.asarray([sp.num_vectors], np.int32), self.mesh
        )

        nxt = self._upload_chunk(0, uint8_offset, uint8_cosine, mask_host)
        for j in range(self.nchunks):
            data, norms, bias, mask = nxt
            if j + 1 < self.nchunks:
                nxt = self._upload_chunk(
                    j + 1, uint8_offset, uint8_cosine, mask_host
                )
            extras = []
            if bias is not None:
                extras.append(bias)
            if mask is not None:
                extras.append(mask)
            jrep = replicate(np.asarray([j], np.int32), self.mesh)
            best_s, best_i = _sharded_stream_step(
                qrep, data, norms, best_s, best_i, nvalid, jrep, *extras,
                k=k_eff, metric=self.metric, mesh=self.mesh,
                axis=self.axis, per=self.per, chunk_rows=self.chunk_rows,
                # uint8-cosine chunks are host-dequantized to f32, so the
                # scan scale is prep's (1.0) — never the space scale.
                scale=prep.dot_scale,
                bias_scale=prep.bias_scale,
                has_bias=bias is not None, has_mask=mask is not None,
            )
        s, i = _sharded_stream_merge(
            best_s, best_i, k_eff, self.mesh, self.axis
        )
        s, i = np.asarray(s), np.asarray(i)
        if prep.const is not None:
            mult = 2.0 if self.metric == DistanceMetric.L2 else 1.0
            s = s + mult * prep.const[:, None]
        dist = distances_np(s, self.metric, prep.sq_norms)
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
                            ids=_ids_for(self._host_ids, i))
