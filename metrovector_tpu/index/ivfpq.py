"""IVF-PQ: coarse inverted-file quantizer + residual product quantization.

The standard billion-scale ANN composition (coarse k-means cells, PQ codes
of the *residual* ``x − centroid``), absent from the reference (which
declares IVF and PQ schemas separately and implements neither). Design
choices:

* **Training**: coarse k-means and per-subspace residual k-means both run
  as blocked matmuls (:func:`.ivf.train_kmeans`).
* **Layout**: cluster-grouped uniform bucket tensors like
  :class:`.ivf.IVFIndex`, but the payload per row is ``m`` uint8 codes +
  one f32 reconstruction norm instead of ``dim`` floats — the probe
  working set shrinks ``≈ 4·dim/m``×.
* **Scoring identity** (one LUT per query, not per probe): with
  ``x̂ = c + r̂``, ``q·x̂ = q·c + q·r̂``. The coarse term ``q·c`` already
  exists from centroid scoring, and ``q·r̂ = Σ_j q_j · R[j, code_j]`` uses
  a *query* LUT over the residual codebooks, so residual encoding costs
  nothing extra at search time. ``‖x̂‖²`` is precomputed per row at encode.
* **Lookup**: probe mode gathers LUT entries over the probed buckets
  (``nprobe · bucket_rows`` rows/query); scan mode runs the full-corpus
  ADC scan of :func:`.pq.adc_topk` with a per-bucket bias.
* **Re-ranking**: optional exact rescoring of survivors against the
  original rows, as in :class:`.pq.PQIndex`.

Persistence: coarse structure rides the IVF blocks
(``Builder.set_ivf_index``), residual codebooks/codes/norms ride the PQ
sidecar with ``residual=True`` (``Builder.set_pq_index``).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..format.constants import DistanceMetric
from ..ops.distances import distances_np
from ..utils.transfer import put_chunked
from .ivf import train_kmeans
from .pq import (
    DEFAULT_ADC_BLOCK_ROWS,
    _rerank,
    adc_topk,
    encode_pq,
    reconstruct_pq,
    train_pq,
)

# Plain Python float: a module-level jnp scalar would initialize the
# XLA backend at import time, breaking jax.distributed.initialize
# in multi-process programs. Weak-typed, so traced uses are identical.
_NEG_INF = float("-inf")


def train_ivfpq(
    data: np.ndarray,
    num_clusters: int,
    m: int = 16,
    ksub: int = 256,
    iters: int = 10,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Train the full IVF-PQ structure on host ``[N, D]`` f32 data.

    Returns ``(centroids [C, D], assignments [N] i32,
    codebooks [m, ksub, dsub], codes [N, m] u8)`` where codes encode the
    residuals ``x − centroids[assignments]``.
    """
    data = np.ascontiguousarray(data, dtype=np.float32)
    centroids, assignments = train_kmeans(
        data, num_clusters, iters=iters, seed=seed
    )
    residuals = data - centroids[assignments]
    codebooks = train_pq(residuals, m=m, ksub=ksub, iters=iters, seed=seed + 1)
    codes = encode_pq(residuals, codebooks)
    return centroids, assignments, codebooks, codes


@functools.partial(
    jax.jit, static_argnames=("k", "nprobe", "metric", "packed4")
)
def _ivfpq_search(
    q,
    centroids,     # [C', D] f32 per-bucket (split cells duplicate theirs)
    buckets,       # [C', B, m] uint8 codes ([C', B, ⌈m/2⌉] when packed4)
    bucket_ids,    # [C', B] i32 (−1 padding)
    bucket_norms,  # [C', B] f32 ‖x̂‖² of full reconstructions
    books,         # [m, ksub, dsub] f32 residual codebooks
    k: int,
    nprobe: int,
    metric: DistanceMetric,
    packed4: bool = False,
    row_filter=None,  # optional [N] plane (0 ⇒ excluded), by row id
):
    """Device-side IVF-PQ probe: coarse scoring → ``lax.scan`` over probe
    ranks, each step gathering one code bucket per query and looking up the
    per-query flat LUT with a 2-D batched gather (``[Q, B·m]`` indices into
    ``[Q, m·ksub]``), then merging into a carried candidate list. Peak
    memory is O(Q·B·m), independent of ``nprobe`` — the one-shot
    formulation this replaces broadcast the LUT to ``[Q, P, B, m, ksub]``
    and OOM'd at production sizes."""
    metric = DistanceMetric(metric)
    nq, d = q.shape
    m, ksub, dsub = books.shape
    bsize = buckets.shape[1]

    c_norms = jnp.einsum(
        "ij,ij->i", centroids, centroids, precision=jax.lax.Precision.HIGHEST
    )
    cdots = jax.lax.dot_general(
        q, centroids, dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )  # [Q, C']
    if metric == DistanceMetric.L2:
        cscores = 2.0 * cdots - c_norms[None, :]
    elif metric == DistanceMetric.COSINE:
        cscores = cdots * jax.lax.rsqrt(jnp.maximum(c_norms, 1e-30))[None, :]
    else:
        cscores = cdots
    _, probes = jax.lax.top_k(cscores, nprobe)  # [Q, P]

    # One flat LUT per query: LUT[q, j·ksub + c] = q_j · R[j, c]
    # (q·x̂ = q·c + q·r̂ — residual encoding is free at query time).
    lut = jnp.einsum(
        "qmd,mkd->qmk",
        q.reshape(nq, m, dsub),
        books,
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    ).reshape(nq, m * ksub)

    qin = None
    if metric == DistanceMetric.COSINE:
        qnorm = jnp.sum(q.astype(jnp.float32) ** 2, axis=-1)
        qin = jax.lax.rsqrt(jnp.maximum(qnorm, 1e-30))

    j_off = ksub * jax.lax.broadcasted_iota(jnp.int32, (1, 1, m), 2)

    def step(carry, p_col):  # p_col: [Q] bucket id at this probe rank
        best_s, best_i = carry
        gc = buckets[p_col].astype(jnp.int32)  # [Q, B, m] (or [Q, B, cc])
        if packed4:
            # nibble-unpack to [Q, B, m]: even subspaces in low nibbles,
            # odd in high (the pack_codes4 layout)
            rep = jnp.repeat(gc, 2, axis=2)[..., :m]
            parity = jax.lax.broadcasted_iota(jnp.int32, (1, 1, m), 2) % 2
            gc = jnp.where(parity == 1, rep // 16, rep % 16)
        gi = bucket_ids[p_col]                 # [Q, B]
        gn = bucket_norms[p_col]               # [Q, B]
        qc = jnp.take_along_axis(cdots, p_col[:, None], axis=1)  # [Q, 1]
        flat_idx = (gc + j_off).reshape(nq, bsize * m)
        vals = jnp.take_along_axis(lut, flat_idx, axis=1)
        rdots = vals.reshape(nq, bsize, m).sum(axis=2)  # [Q, B]
        dots = qc + rdots                               # q·x̂
        if metric == DistanceMetric.L2:
            scores = 2.0 * dots - gn
        elif metric == DistanceMetric.COSINE:
            scores = dots * jax.lax.rsqrt(jnp.maximum(gn, 1e-30)) * qin[:, None]
        else:
            scores = dots
        live = gi >= 0
        if row_filter is not None:
            # same [Q, B] gather pattern as the bucket fetch itself
            live &= jnp.take(row_filter, jnp.clip(gi, 0, None)) != 0
        scores = jnp.where(live, scores, _NEG_INF)
        cand_s = jnp.concatenate([best_s, scores], axis=1)
        cand_i = jnp.concatenate([best_i, gi], axis=1)
        top_s, pos = jax.lax.top_k(cand_s, k)
        top_i = jnp.take_along_axis(cand_i, pos, axis=1)
        return (top_s, top_i), None

    init = (
        jnp.full((nq, k), _NEG_INF, jnp.float32),
        jnp.full((nq, k), -1, jnp.int32),
    )
    (s, idx), _ = jax.lax.scan(step, init, probes.T)
    idx = jnp.where(s > _NEG_INF, idx, -1)
    return s, idx


@dataclasses.dataclass
class IVFPQIndex:
    """Probe-ready IVF-PQ structure for one space.

    ``buckets``: ``[C', B, m]`` uint8 bucket-grouped residual codes
    (``C' ≥ num_clusters`` after split-capping, see
    :func:`.ivf.bucket_layout`); ``bucket_ids``/``bucket_norms``:
    ``[C', B]`` row ids (−1 pad) and full reconstruction norms
    ``‖c + r̂‖²``; ``centroids``: the trained ``[C, D]``;
    ``probe_centroids``: device ``[C', D]`` per-bucket; ``cells``:
    ``[C']`` bucket → cluster map; ``codebooks``: ``[m, ksub, dsub]``
    residual codebooks."""

    centroids: np.ndarray
    probe_centroids: jax.Array
    cells: np.ndarray
    codebooks: np.ndarray
    buckets: jax.Array
    bucket_ids: jax.Array
    bucket_norms: jax.Array
    fill: np.ndarray
    metric: DistanceMetric
    dim: int
    num_vectors: int
    db: jax.Array | None = None
    db_norms: jax.Array | None = None
    # Batch size at which ``mode="auto"`` switches from bucket traversal
    # (the latency option) to the masked full-corpus scan.
    SCAN_CROSSOVER_BATCH = 32
    # Row-order arrays for the gather-free masked scan: residual codes /
    # recon norms in ORIGINAL row order, per-row bucket ids (−1 =
    # tombstoned/unbucketed) and the validity mask. Built at construction;
    # memory is m+9 bytes/row.
    codes_row: jax.Array | None = None
    rnorms_row: jax.Array | None = None
    row_bucket: jax.Array | None = None
    row_valid: jax.Array | None = None
    # Host-side stable u64 ID column (reference ``schema/core.fbs:54``
    # semantics); result positions translate through it so ids survive
    # compaction.
    host_ids: np.ndarray | None = None
    # Host mirrors of each row's (bucket, slot) placement (−1 =
    # tombstoned/unbucketed): let mutation run as O(touched) device
    # scatters instead of O(N) layout rebuilds.
    row_bucket_host: np.ndarray | None = None
    row_slot_host: np.ndarray | None = None
    # Codes stored nibble-packed ([.., ⌈m/2⌉] bytes; requires ksub ≤ 16).
    # Half the code memory of byte codes.
    packed4: bool = False
    # Preferred masked-scan tile (None = ``pq.DEFAULT_ADC_BLOCK_ROWS``).
    # Set by :meth:`autotune` or adopted from persisted hints in
    # :meth:`from_space`.
    scan_block_rows: int | None = None
    _host_space: object | None = dataclasses.field(
        default=None, repr=False, compare=False
    )

    @classmethod
    def build(
        cls,
        vectors: np.ndarray,
        metric: DistanceMetric,
        num_clusters: int,
        m: int = 16,
        ksub: int = 256,
        iters: int = 10,
        seed: int = 0,
        centroids: np.ndarray | None = None,
        assignments: np.ndarray | None = None,
        codebooks: np.ndarray | None = None,
        codes: np.ndarray | None = None,
        recon_norms: np.ndarray | None = None,
        keep_vectors: bool = True,
        valid_mask: np.ndarray | None = None,
        ids: np.ndarray | None = None,
        pack4: bool | None = None,
    ) -> "IVFPQIndex":
        """Train (or accept precomputed) coarse + residual structure and lay
        codes out into uniform buckets. With everything precomputed
        (centroids/assignments/codebooks/codes/recon_norms, as persisted by
        ``Builder.set_ivf_index`` + ``set_pq_index(residual=True)``) no
        training, encoding or reconstruction runs — O(1)-open. Tombstoned
        rows (``valid_mask`` True) are excluded from the buckets
        entirely. ``pack4``: store codes nibble-packed (requires
        ksub ≤ 16) — half the code bytes and the faster 4-bit ADC path
        on both serving modes; default keeps whatever packing the
        provided ``codes`` already have."""
        vectors = np.ascontiguousarray(vectors, dtype=np.float32)
        n, d = vectors.shape
        host_ids = (
            np.ascontiguousarray(ids, np.uint64).reshape(-1)
            if ids is not None
            else None
        )
        if centroids is None or assignments is None:
            centroids, assignments = train_kmeans(
                vectors, num_clusters, iters=iters, seed=seed
            )
        num_clusters = centroids.shape[0]
        if codebooks is None or codes is None:
            residuals = vectors - centroids[assignments]
            if codebooks is None:
                codebooks = train_pq(
                    residuals, m=m, ksub=ksub, iters=iters, seed=seed + 1
                )
            codebooks = np.ascontiguousarray(codebooks, dtype=np.float32)
            if codes is None:
                codes = encode_pq(residuals, codebooks)
        codebooks = np.ascontiguousarray(codebooks, dtype=np.float32)
        m = codebooks.shape[0]
        ksub_eff = codebooks.shape[1]

        from .pq import pack_codes4, unpack_codes4

        codes = np.asarray(codes, np.uint8)
        already_packed = codes.shape[1] == (m + 1) // 2 and codes.shape[1] != m
        if pack4 is None:
            pack4 = already_packed
        if pack4 and ksub_eff > 16:
            raise ValueError(f"pack4 requires ksub <= 16, got {ksub_eff}")

        if recon_norms is None:
            unpacked = unpack_codes4(codes, m) if already_packed else codes
            recon = (
                reconstruct_pq(unpacked, codebooks) + centroids[assignments]
            )
            recon_norms = np.einsum(
                "ij,ij->i", recon.astype(np.float64), recon.astype(np.float64)
            ).astype(np.float32)
        recon_norms = np.ascontiguousarray(recon_norms, dtype=np.float32)
        if pack4 and not already_packed:
            codes = pack_codes4(codes)
        elif already_packed and not pack4:
            codes = unpack_codes4(codes, m)

        keep = (
            np.ones(n, bool)
            if valid_mask is None
            else ~np.asarray(valid_mask, dtype=bool)
        )
        from .ivf import bucket_layout

        cells, row_lists, bucket_rows = bucket_layout(
            assignments, keep, num_clusters
        )
        nb = len(cells)
        bcodes = np.zeros((nb, bucket_rows, codes.shape[1]), np.uint8)
        ids = np.full((nb, bucket_rows), -1, np.int32)
        bnorms = np.zeros((nb, bucket_rows), np.float32)
        b_of_row = np.full(n, -1, np.int32)
        s_of_row = np.full(n, -1, np.int32)
        for b, rows in enumerate(row_lists):
            bcodes[b, : len(rows)] = codes[rows]
            ids[b, : len(rows)] = rows
            bnorms[b, : len(rows)] = recon_norms[rows]
            b_of_row[rows] = b
            s_of_row[rows] = np.arange(len(rows), dtype=np.int32)

        db = db_norms = None
        if keep_vectors:
            db = put_chunked(vectors)
            db_norms = jax.device_put(
                np.einsum(
                    "ij,ij->i",
                    vectors.astype(np.float64),
                    vectors.astype(np.float64),
                ).astype(np.float32)
            )
        return cls(
            centroids=centroids,
            probe_centroids=jax.device_put(centroids[cells]),
            cells=cells,
            codebooks=codebooks,
            buckets=put_chunked(bcodes),
            bucket_ids=jax.device_put(ids),
            bucket_norms=jax.device_put(bnorms),
            fill=np.asarray([len(r) for r in row_lists]),
            metric=DistanceMetric(metric),
            dim=d,
            num_vectors=n,
            db=db,
            db_norms=db_norms,
            codes_row=put_chunked(np.asarray(codes, np.uint8)),
            rnorms_row=jax.device_put(recon_norms),
            row_bucket=jax.device_put(b_of_row),
            row_valid=jax.device_put((b_of_row >= 0).astype(np.float32)),
            host_ids=host_ids,
            row_bucket_host=b_of_row,
            row_slot_host=s_of_row,
            packed4=bool(pack4),
        )

    @classmethod
    def from_space(
        cls,
        space,
        num_clusters: int | None = None,
        m: int = 16,
        ksub: int = 256,
        iters: int = 10,
        seed: int = 0,
        keep_vectors: bool = True,
        pack4: bool | None = None,
    ) -> "IVFPQIndex":
        """Build the probe-ready structure for a host ``VectorSpace``,
        reusing the persisted coarse quantizer (IVF blocks) and residual PQ
        sidecar when both are present — no retraining, no re-encoding.
        ``pack4`` defaults to the persisted sidecar's packing."""
        stored_ivf = space.ivf_arrays()
        centroids = assignments = codebooks = codes = recon_norms = None
        if stored_ivf is not None:
            centroids, assignments = stored_ivf
        stored_pq = space.pq_arrays()
        if (
            stored_pq is not None
            and space.info.pq.residual
            and stored_ivf is not None
        ):
            codebooks, codes, recon_norms = stored_pq
            if pack4 is None:
                pack4 = bool(space.info.pq.packed4)
        if num_clusters is None:
            num_clusters = int(
                space.info.index.params.get(
                    "num_clusters", max(1, int(np.sqrt(space.num_vectors)))
                )
            )
        vectors = np.asarray(space.to_numpy(), dtype=np.float32)
        q = space.quantization
        if q is not None:
            vectors = (vectors - q.zero_point) * q.scale
        idx = cls.build(
            vectors,
            space.metric,
            num_clusters,
            m=m,
            ksub=ksub,
            iters=iters,
            seed=seed,
            centroids=centroids,
            assignments=assignments,
            codebooks=codebooks,
            codes=codes,
            recon_norms=recon_norms,
            keep_vectors=keep_vectors,
            valid_mask=space.tombstone_mask(),
            ids=space.ids(),
            pack4=pack4,
        )
        from ..utils.tune import tuned_hints

        h = tuned_hints(space, "ivfpq")
        if h.get("block_rows"):
            idx.scan_block_rows = int(h["block_rows"])
        idx._host_space = space
        return idx

    @property
    def num_clusters(self) -> int:
        return int(self.centroids.shape[0])

    @property
    def num_buckets(self) -> int:
        return int(self.buckets.shape[0])

    @property
    def bucket_rows(self) -> int:
        return int(self.buckets.shape[1])

    # -- online mutation ------------------------------------------------------

    def _rebuild_layouts(self, codes_all, rnorms_all, cluster_of_row, keep):
        """Re-derive BOTH serving layouts (bucket-traversal tensors and the
        row-order scan arrays) from per-row state. Row ids are positions in
        the row-order arrays and are NEVER renumbered — deleted rows keep
        their slot with ``row_valid = 0`` and simply drop out of buckets."""
        from .ivf import bucket_layout

        n = codes_all.shape[0]
        m = codes_all.shape[1]
        cells, row_lists, bucket_rows = bucket_layout(
            np.where(cluster_of_row >= 0, cluster_of_row, 0),
            keep & (cluster_of_row >= 0),
            self.num_clusters,
        )
        nb = len(cells)
        bcodes = np.zeros((nb, bucket_rows, m), np.uint8)
        ids = np.full((nb, bucket_rows), -1, np.int32)
        bnorms = np.zeros((nb, bucket_rows), np.float32)
        b_of_row = np.full(n, -1, np.int32)
        s_of_row = np.full(n, -1, np.int32)
        for b, rows in enumerate(row_lists):
            bcodes[b, : len(rows)] = codes_all[rows]
            ids[b, : len(rows)] = rows
            bnorms[b, : len(rows)] = rnorms_all[rows]
            b_of_row[rows] = b
            s_of_row[rows] = np.arange(len(rows), dtype=np.int32)
        self.row_bucket_host = b_of_row
        self.row_slot_host = s_of_row
        self.cells = cells
        self.fill = np.asarray([len(r) for r in row_lists])
        self.probe_centroids = jax.device_put(self.centroids[cells])
        self.buckets = jax.device_put(bcodes)
        self.bucket_ids = jax.device_put(ids)
        self.bucket_norms = jax.device_put(bnorms)
        self.codes_row = jax.device_put(codes_all)
        self.rnorms_row = jax.device_put(rnorms_all)
        self.row_bucket = jax.device_put(b_of_row)
        self.row_valid = jax.device_put(
            (b_of_row >= 0).astype(np.float32)
        )
        self.num_vectors = n

    def _host_row_state(self):
        codes_all = np.asarray(self.codes_row)[: self.num_vectors]
        rnorms_all = np.asarray(self.rnorms_row)[: self.num_vectors]
        rb = np.asarray(self.row_bucket)[: self.num_vectors]
        cluster_of_row = np.where(rb >= 0, self.cells[np.maximum(rb, 0)], -1)
        keep = rb >= 0
        return codes_all, rnorms_all, cluster_of_row.astype(np.int32), keep

    def add_rows(
        self, vectors: np.ndarray, ids=None, reserve: float = 1.5
    ) -> None:
        """Append rows to the live index: coarse-assign to the nearest
        trained centroid (L2, as at build), encode the residual with the
        EXISTING codebooks, and scatter into tail slots of that cluster's
        buckets on device (:func:`.ivf._plan_placements` — O(appended +
        touched buckets) host work, not an O(N) layout rebuild). New
        buckets are allocated only on cluster overflow, and the row-order
        scan arrays grow in capacity steps (``reserve``), so steady-state
        appends are pure device scatters with no recompiles. No
        retraining — centroids and codebooks are fixed, so quantization
        error grows with distribution drift; rebuild via ``build`` when it
        matters. Appends must carry ``ids`` iff the index has an ID column
        (the ``DeviceSpace.add_rows`` contract)."""
        from ..engine import merged_append_ids
        from ..errors import DimensionMismatchError
        from .ivf import _plan_placements

        vectors = np.ascontiguousarray(vectors, dtype=np.float32)
        if vectors.ndim == 1:
            vectors = vectors[None]
        if vectors.shape[1] != self.dim:
            raise DimensionMismatchError(
                expected=self.dim, actual=int(vectors.shape[1])
            )
        n_new = vectors.shape[0]
        if n_new == 0:
            return
        merged_ids = merged_append_ids(
            self.host_ids, ids, n_new, self.num_vectors
        )
        cn = np.einsum(
            "ij,ij->i", self.centroids, self.centroids, dtype=np.float64
        )
        d2 = cn[None, :] - 2.0 * (
            vectors.astype(np.float64) @ self.centroids.T.astype(np.float64)
        )
        assign_new = np.argmin(d2, axis=1).astype(np.int32)
        residuals = vectors - self.centroids[assign_new]
        codes_new = encode_pq(residuals, self.codebooks)
        recon = (
            reconstruct_pq(codes_new, self.codebooks)
            + self.centroids[assign_new]
        )
        rn_new = np.einsum(
            "ij,ij->i", recon.astype(np.float64), recon.astype(np.float64)
        ).astype(np.float32)
        if self.packed4:
            from .pq import pack_codes4

            codes_new = pack_codes4(codes_new)

        b_idx, s_idx, new_cells, fill, fills_new = _plan_placements(
            self.cells, self.fill, self.bucket_rows, assign_new
        )
        if new_cells:
            nbn = len(new_cells)
            bsz = self.bucket_rows
            self.buckets = jnp.concatenate(
                [self.buckets,
                 jnp.zeros((nbn, bsz, self.buckets.shape[2]),
                           self.buckets.dtype)]
            )
            self.bucket_ids = jnp.concatenate(
                [self.bucket_ids, jnp.full((nbn, bsz), -1, jnp.int32)]
            )
            self.bucket_norms = jnp.concatenate(
                [self.bucket_norms, jnp.zeros((nbn, bsz), jnp.float32)]
            )
            self.probe_centroids = jnp.concatenate(
                [self.probe_centroids,
                 jnp.asarray(self.centroids[np.asarray(new_cells)])]
            )
            self.cells = np.concatenate(
                [self.cells, np.asarray(new_cells, np.int32)]
            )
        total = self.num_vectors + n_new
        row_ids_new = np.arange(self.num_vectors, total, dtype=np.int32)
        bi, si = jnp.asarray(b_idx), jnp.asarray(s_idx)
        self.buckets = self.buckets.at[bi, si].set(jnp.asarray(codes_new))
        self.bucket_ids = self.bucket_ids.at[bi, si].set(
            jnp.asarray(row_ids_new)
        )
        self.bucket_norms = self.bucket_norms.at[bi, si].set(
            jnp.asarray(rn_new)
        )
        self.fill = np.concatenate([fill, fills_new])

        cap = int(self.codes_row.shape[0])
        if total > cap:
            cap = max(
                -(-total // 128) * 128,
                -(-int(cap * reserve) // 128) * 128,
            )
        rows_dev = jnp.asarray(row_ids_new)

        def grown(old_dev, new_host, fill_v=0, dtype=None):
            # Within capacity: pure device scatter (no host O(N) pass, no
            # re-upload). Over capacity: host-materialize at the new cap.
            if total <= int(old_dev.shape[0]):
                return old_dev.at[rows_dev].set(jnp.asarray(new_host))
            old = np.asarray(old_dev)
            dtype = dtype or old.dtype
            out = np.full((cap,) + old.shape[1:], fill_v, dtype=dtype)
            out[: self.num_vectors] = old[: self.num_vectors]
            out[self.num_vectors : total] = new_host
            return jax.device_put(out)

        self.codes_row = grown(self.codes_row, codes_new)
        self.rnorms_row = grown(self.rnorms_row, rn_new)
        self.row_bucket = grown(self.row_bucket, b_idx, fill_v=-1)
        self.row_valid = grown(
            self.row_valid, np.ones(n_new, np.float32), fill_v=0.0
        )
        self.row_bucket_host = np.concatenate(
            [self.row_bucket_host[: self.num_vectors], b_idx]
        )
        self.row_slot_host = np.concatenate(
            [self.row_slot_host[: self.num_vectors], s_idx]
        )
        if self.db is not None:
            vn = np.einsum(
                "ij,ij->i",
                vectors.astype(np.float64),
                vectors.astype(np.float64),
            ).astype(np.float32)
            self.db = grown(self.db, vectors)
            self.db_norms = grown(self.db_norms, vn)
        if merged_ids is not None:
            self.host_ids = merged_ids
        self.num_vectors = total

    def delete_rows(self, rows) -> None:
        """Tombstone rows by position: their bucket slots get id −1 and
        the scan-path validity drops to 0 — an O(deleted) device scatter;
        row positions are never renumbered. Slots are not reclaimed;
        call :meth:`rebuild` after heavy churn."""
        from ..errors import IndexOutOfBoundsError

        idx = [int(r) for r in np.atleast_1d(rows)]
        for r in idx:
            if r < 0 or r >= self.num_vectors:
                raise IndexOutOfBoundsError(r, self.num_vectors)
        if not idx:
            return
        sel = np.asarray(idx, np.int64)
        placed = sel[self.row_bucket_host[sel] >= 0]
        if placed.size:
            bi = jnp.asarray(self.row_bucket_host[placed])
            si = jnp.asarray(self.row_slot_host[placed])
            self.bucket_ids = self.bucket_ids.at[bi, si].set(-1)
        seld = jnp.asarray(sel)
        self.row_bucket = self.row_bucket.at[seld].set(-1)
        self.row_valid = self.row_valid.at[seld].set(0.0)
        self.row_bucket_host = self.row_bucket_host.copy()
        self.row_slot_host = self.row_slot_host.copy()
        self.row_bucket_host[sel] = -1
        self.row_slot_host[sel] = -1

    def rebuild(self) -> None:
        """Re-derive both serving layouts from per-row state, reclaiming
        deleted slots and re-balancing buckets (O(N) host work — the full
        rebuild that :meth:`add_rows`/:meth:`delete_rows` avoid)."""
        self._rebuild_layouts(*self._host_row_state())

    def prepare_filter(self, filter_mask):
        """Upload a ``[num_vectors]`` boolean/int row predicate once for
        reuse across :meth:`search` calls (both serving modes gather it by
        ORIGINAL row id). Returns a
        :class:`~metrovector_tpu.engine.PreparedFilter`; invalidated by
        :meth:`add_rows` (capacity growth changes the padded length)."""
        from ..engine import PreparedFilter
        from ..utils.filters import padded_filter_plane

        full = padded_filter_plane(
            filter_mask, self.num_vectors, self.codes_row.shape[0]
        )
        return PreparedFilter(
            mask=jax.device_put(full), num_valid=self.num_vectors
        )

    def _filter_device(self, filter_mask):
        """Normalize a raw array / PreparedFilter to the capacity-padded
        ``[cap]`` f32 plane both serving modes consume (scan: multiplied
        into ``row_valid``; probe: gathered at candidate row ids)."""
        if filter_mask is None:
            return None
        from ..engine import PreparedFilter
        from ..utils.filters import checked_prepared_mask

        if isinstance(filter_mask, PreparedFilter):
            return checked_prepared_mask(
                filter_mask, self.num_vectors, self.codes_row.shape[0]
            )
        return self.prepare_filter(filter_mask).mask

    def _masked_scan(self, qdev, fetch: int, nprobe: int,
                     exact_lut: bool = False,
                     block_rows: int | None = None,
                     row_filter=None):
        """Gather-free probing: dense ADC over the corpus in ORIGINAL row
        order (:func:`.pq.adc_topk`) with a per-(query, bucket) f32 bias —
        ``q·centroid`` on the ``nprobe`` best coarse buckets (residual ADC:
        q·x̂ = q·c + q·r̂), −inf elsewhere. Each row's bucket id gathers its
        bias, so the corpus needs no bucket-padded copy. Buckets whose
        coarse score ties the nprobe-th are all probed (rank-boundary ties
        are kept rather than broken arbitrarily). Same candidate semantics
        as the traversal probe."""
        cdots = jax.lax.dot_general(
            qdev, self.probe_centroids,
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        c_norms = jnp.einsum(
            "ij,ij->i", self.probe_centroids, self.probe_centroids,
            precision=jax.lax.Precision.HIGHEST,
        )
        if self.metric == DistanceMetric.L2:
            cscores = 2.0 * cdots - c_norms[None, :]
        elif self.metric == DistanceMetric.COSINE:
            cscores = cdots * jax.lax.rsqrt(
                jnp.maximum(c_norms, 1e-30)
            )[None, :]
        else:
            cscores = cdots
        cth, _ = jax.lax.top_k(cscores, nprobe)
        bias = jnp.where(cscores >= cth[:, -1:], cdots, -jnp.inf)
        eff_valid = self.row_valid
        if row_filter is not None:
            # user predicate rides the same validity plane as tombstones
            eff_valid = eff_valid * row_filter
        return adc_topk(
            qdev, self.codes_row, jnp.asarray(self.codebooks),
            self.rnorms_row, self.num_vectors, fetch,
            self.metric, valid_mask=eff_valid, group_bias=bias,
            group_ids=self.row_bucket, exact_lut=exact_lut,
            packed4=self.packed4, block_rows=block_rows,
        )

    def recommended_rerank(self, k: int = 10, recall_target: float = 1.0) -> int:
        """Rerank depth expected to reach ``recall_target`` at this ``k``.

        4-bit codes (``pack4=True``) trade pre-rerank recall for scan
        speed: at the same bytes/row the raw 4-bit ADC scan recalls ~0.66
        vs ~0.74 for 8-bit (on a 1M×128 clustered corpus at nprobe=16,
        k=10), because each subspace has only 16 centroids. Exact
        reranking recovers it: ``rerank = 40·k`` reached recall 1.000 on
        BOTH code widths.

        Factors are anchored at those recalls and interpolated
        between; they are guidance for corpora of similar difficulty, not
        a guarantee — validate against a held-out oracle for your data.
        Returns 0 when the raw ADC scan alone is expected to meet the
        target (never for ``pack4`` above ~0.6)."""
        if not 0.0 < recall_target <= 1.0:
            raise ValueError(f"recall_target must be in (0, 1], got {recall_target}")
        raw = 0.63 if self.packed4 else 0.70  # conservative scan-only recall
        if recall_target <= raw:
            return 0
        if recall_target >= 0.99:
            factor = 40
        elif recall_target >= 0.9:
            factor = 20
        else:
            factor = 12 if self.packed4 else 10
        return factor * k

    def search(
        self,
        queries: np.ndarray,
        k: int = 10,
        nprobe: int = 8,
        rerank: int = 0,
        mode: str = "auto",
        exact_lut: bool = False,
        block_rows: int | None = None,
        filter_mask=None,
    ):
        """Approximate top-k: ADC over the ``nprobe`` best-scoring buckets'
        residual codes (split cells count one bucket each); ``rerank=R``
        rescores the top-R survivors exactly against the original vectors.

        With 4-bit codes (``pack4=True``) pre-rerank recall dips (~0.66 vs
        ~0.74 for 8-bit at equal bytes/row) — pair pack4 with reranking;
        :meth:`recommended_rerank` maps a recall target to a depth
        (``rerank=40·k`` measured recall 1.000 on both code widths).

        ``mode``: ``"probe"`` walks the probed buckets (scan over probe
        ranks — O(nprobe·B) work, best at tiny batches), ``"scan"`` runs
        the gather-free masked dense scan (full-corpus ADC + per-bucket
        bias — the batch-serving option), ``"auto"`` picks by batch size
        (``SCAN_CROSSOVER_BATCH``). Returns a ``SearchResult``.

        ``filter_mask``: optional ``[num_vectors]`` boolean/int row
        predicate (or a prepared one from :meth:`prepare_filter`),
        composed with tombstones on both serving modes — scan multiplies
        it into the row-validity plane, probe gathers it per candidate.
        Candidates are filtered BEFORE re-ranking, so the ``rerank`` pool
        is all filter-passing. As with any IVF structure, recall within a
        low-selectivity subset is bounded by bucket coverage — raise
        ``nprobe``/``rerank`` for aggressive predicates."""
        from ..engine import SearchResult

        q = np.ascontiguousarray(queries, np.float32)
        if q.ndim == 1:
            q = q[None]
        if q.shape[1] != self.dim:
            from ..errors import DimensionMismatchError

            raise DimensionMismatchError(expected=self.dim, actual=int(q.shape[1]))
        qnorms = np.einsum("ij,ij->i", q, q, dtype=np.float64).astype(np.float32)
        if self.metric == DistanceMetric.COSINE:
            q = q / np.maximum(np.sqrt(qnorms)[:, None], 1e-30)
        nprobe = min(nprobe, self.num_buckets)
        fetch = max(k, rerank) if rerank else k
        fetch = min(fetch, self.bucket_rows * nprobe) or 1
        if mode not in ("auto", "scan", "probe"):
            raise ValueError(
                f"unknown search mode {mode!r}; expected 'auto', 'scan' or "
                "'probe'"
            )
        if mode == "auto":
            mode = (
                "scan" if q.shape[0] >= self.SCAN_CROSSOVER_BATCH else "probe"
            )
        qdev = jax.device_put(q)
        if block_rows is None:
            block_rows = self.scan_block_rows
        row_filter = self._filter_device(filter_mask)
        if mode == "scan":
            s, i = self._masked_scan(
                qdev, fetch, nprobe, exact_lut=exact_lut,
                block_rows=block_rows, row_filter=row_filter,
            )
        else:
            s, i = _ivfpq_search(
                qdev,
                self.probe_centroids,
                self.buckets,
                self.bucket_ids,
                self.bucket_norms,
                jnp.asarray(self.codebooks),
                k=fetch,
                nprobe=nprobe,
                metric=self.metric,
                packed4=self.packed4,
                row_filter=row_filter,
            )
        if rerank:
            if self.db is None:
                raise ValueError(
                    "rerank requires the original vectors "
                    "(build with keep_vectors=True)"
                )
            s, i = _rerank(qdev, self.db, self.db_norms, i, min(k, fetch), self.metric)
        else:
            s, i = s[:, :k], i[:, :k]
        s, i = np.asarray(s), np.asarray(i)
        dist = distances_np(s, self.metric, qnorms)
        bad_fill = np.inf if self.metric == DistanceMetric.L2 else -np.inf
        dist = np.where(i >= 0, dist, bad_fill)
        if s.shape[1] < k:
            pad = ((0, 0), (0, k - s.shape[1]))
            i = np.pad(i, pad, constant_values=-1)
            s = np.pad(s, pad, constant_values=-np.inf)
            dist = np.pad(dist, pad, constant_values=bad_fill)
        from ..engine import ids_for_rows

        return SearchResult(
            indices=i, scores=s, distances=dist, metric=self.metric,
            ids=ids_for_rows(self.host_ids, i),
        )

    def autotune(self, queries=None, k: int = 10, batch: int = 128,
                 nprobe: int = 16, block_rows_candidates=None,
                 iters: int = 3, apply: bool = True, persist: bool = False,
                 **search_kw) -> list[dict]:
        """Measure candidate masked-scan ``block_rows`` with single-launch
        timings and optionally apply/persist the fastest
        (:attr:`scan_block_rows`; ``hints["tuned"][space]["ivfpq"]``).

        ``**search_kw`` reaches :meth:`search` (e.g. ``rerank=``,
        ``exact_lut=``); the scan mode is forced since only it takes the
        tile. Tuning batches below ``SCAN_CROSSOVER_BATCH`` still measure
        the scan — the knob only serves that mode."""
        from ..utils.tune import block_rows_around, measure_candidates

        if persist and self._host_space is None:
            raise ValueError(
                "persist requires an index built from a file-backed "
                "VectorSpace (IVFPQIndex.from_space)"
            )
        if queries is None:
            queries = np.random.default_rng(0).standard_normal(
                (batch, self.dim)
            ).astype(np.float32)
        if block_rows_candidates is None:
            block_rows_candidates = block_rows_around(DEFAULT_ADC_BLOCK_ROWS)
        candidates = [{"block_rows": int(br)} for br in block_rows_candidates]

        def run_with(cfg):
            def run():
                self.search(queries, k=k, nprobe=nprobe, mode="scan",
                            block_rows=cfg["block_rows"], **search_kw)
            return run

        results = measure_candidates(candidates, run_with, iters)
        if apply and results and np.isfinite(results[0]["ms"]):
            self.scan_block_rows = results[0]["block_rows"]
            if persist:
                from ..utils.tune import persist_tuned

                persist_tuned(
                    self._host_space, "ivfpq",
                    {"block_rows": self.scan_block_rows},
                )
        elif persist:
            raise RuntimeError(
                "nothing persisted: no finite-time winner to apply "
                f"(apply={apply})"
            )
        return results
