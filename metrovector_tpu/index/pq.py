"""Product quantization (PQ): matmul training/encoding + LUT ADC search.

The reference *declares* PQ in its extensions schema — ``QuantizationInfo``
with product-quantization codebook blocks (``schema/extensions.fbs:6-30`` in
thegenem0/metrovector) — but no code ever writes or reads them (SURVEY.md
§2). Here PQ is implemented for real:

* **Training** splits the dimension axis into ``m`` subspaces of
  ``dsub = D/m`` dims and runs the same matmul k-means as IVF
  (:func:`..index.ivf.train_kmeans`) per subspace, producing codebooks
  ``[m, ksub, dsub]``.
* **Encoding** is a blocked nearest-centroid assignment per subspace
  (batched ``argmax 2x·c − ‖c‖²`` matmuls), yielding uint8 codes ``[N, m]``
  — a ``4·D/m``× compression of an f32 corpus.
* **Search** is asymmetric distance computation (ADC): the per-query
  lookup table ``LUT[q, j·ksub + c] = q_j · C[j, c]`` is a small
  ``[Q, m·ksub]`` matrix, and each block of codes sums
  ``Σ_j LUT[q, j·ksub + code_j]`` (:func:`adc_topk`). Reconstruction
  norms ``‖x̂‖²`` are precomputed at encode time, so L2/cosine use the
  same epilogue algebra as the exact engine.
* **Re-ranking**: PQ scores are approximate by construction; ``rerank=R``
  rescores the top-R PQ candidates against the original vectors with
  f32-exact matmuls (device gather + batched einsum), recovering
  recall@k ≈ 1.0 at a fraction of exact-search bandwidth.

PQ is a **memory/bandwidth** optimization (device capacity and
host→device streaming shrink by ``4·D/m``×). ``ksub=16`` (4-bit codes,
nibble-packed) halves the code bytes again; ``ksub=256`` is classic
byte-code PQ with better quantization quality.

Persistence round-trips through MVT blocks (codebooks + codes +
reconstruction norms) referenced from ``SpaceInfo.pq`` — completing the
extensions story the reference left declarative-only.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..format.constants import DistanceMetric
from ..ops.distances import distances_np, scan_topk, score_epilogue
from ..utils.transfer import put_chunked
from .ivf import train_kmeans

# Plain Python float: a module-level jnp scalar would initialize the
# XLA backend at import time, breaking jax.distributed.initialize
# in multi-process programs. Weak-typed, so traced uses are identical.
_NEG_INF = float("-inf")


# ------------------------------------------------------------- training ---


def train_pq(
    data: np.ndarray,
    m: int = 16,
    ksub: int = 256,
    iters: int = 10,
    seed: int = 0,
    sample: int | None = 262_144,
) -> np.ndarray:
    """Train PQ codebooks on ``data`` ``[N, D]`` (host f32). ``D`` must be
    divisible by ``m``. Returns codebooks ``[m, ksub, dsub]`` f32. Each
    subspace is an independent k-means problem solved on the accelerator."""
    data = np.ascontiguousarray(data, dtype=np.float32)
    n, d = data.shape
    if d % m:
        raise ValueError(f"dim {d} not divisible by m={m} subspaces")
    dsub = d // m
    ksub = min(ksub, n)
    books = np.empty((m, ksub, dsub), np.float32)
    for j in range(m):
        sub = np.ascontiguousarray(data[:, j * dsub : (j + 1) * dsub])
        books[j], _ = train_kmeans(
            sub, ksub, iters=iters, seed=seed + j, sample=sample
        )
    return books


@functools.partial(jax.jit, static_argnames=("block_rows",))
def _encode_blocked(data, books, block_rows: int = 8192):
    """Nearest-centroid codes per subspace: ``[N, m]`` int32 (callers cast
    to uint8). Blocked over rows; assignment is batched matmuls."""
    n, d = data.shape
    m, ksub, dsub = books.shape
    b_norms = jnp.einsum(
        "mkd,mkd->mk", books, books, precision=jax.lax.Precision.HIGHEST
    )
    nblocks = -(-n // block_rows)
    pad = nblocks * block_rows - n
    if pad:
        data = jnp.pad(data, ((0, pad), (0, 0)))
    blocks = data.reshape(nblocks, block_rows, m, dsub)

    def step(_, blk):
        dots = jnp.einsum(
            "nmd,mkd->nmk", blk, books,
            precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32,
        )
        scores = 2.0 * dots - b_norms[None, :, :]
        return _, jnp.argmax(scores, axis=2).astype(jnp.int32)

    _, codes = jax.lax.scan(step, None, blocks)
    return codes.reshape(-1, m)[:n]


def encode_pq(data: np.ndarray, codebooks: np.ndarray) -> np.ndarray:
    """Encode rows to PQ codes ``[N, m]`` uint8 (``ksub ≤ 256``)."""
    data = np.ascontiguousarray(data, dtype=np.float32)
    books = np.ascontiguousarray(codebooks, dtype=np.float32)
    if books.shape[1] > 256:
        raise ValueError("ksub > 256 does not fit uint8 codes")
    codes = np.asarray(_encode_blocked(jax.device_put(data), jax.device_put(books)))
    return codes.astype(np.uint8)


def pack_codes4(codes: np.ndarray) -> np.ndarray:
    """Nibble-pack 4-bit PQ codes ``[N, m]`` (values < 16) to
    ``[N, ⌈m/2⌉]`` uint8 — even subspaces in low nibbles, odd in high
    (the layout :func:`adc_topk` unpacks with ``packed4=True``). Odd ``m`` pads a zero high nibble."""
    codes = np.asarray(codes, np.uint8)
    if codes.max(initial=0) > 15:
        raise ValueError("pack_codes4 requires 4-bit codes (ksub <= 16)")
    n, m = codes.shape
    if m % 2:
        codes = np.concatenate(
            [codes, np.zeros((n, 1), np.uint8)], axis=1
        )
    return (codes[:, 0::2] | (codes[:, 1::2] << 4)).astype(np.uint8)


def unpack_codes4(packed: np.ndarray, m: int) -> np.ndarray:
    """Inverse of :func:`pack_codes4`: ``[N, ⌈m/2⌉]`` → ``[N, m]``."""
    packed = np.asarray(packed, np.uint8)
    n = packed.shape[0]
    out = np.empty((n, 2 * packed.shape[1]), np.uint8)
    out[:, 0::2] = packed & 15
    out[:, 1::2] = packed >> 4
    return out[:, :m]


def reconstruct_pq(codes: np.ndarray, codebooks: np.ndarray) -> np.ndarray:
    """Decode codes back to approximate vectors ``[N, D]`` f32 (host)."""
    m, ksub, dsub = codebooks.shape
    codes = np.asarray(codes)
    out = np.empty((codes.shape[0], m * dsub), np.float32)
    for j in range(m):
        out[:, j * dsub : (j + 1) * dsub] = codebooks[j, codes[:, j]]
    return out


# ------------------------------------------------------------ ADC search ---


# Code rows scored per scan step. The exact form's per-step intermediate is
# the gathered [Q, block_rows, m] f32 LUT entries.
DEFAULT_ADC_BLOCK_ROWS = 8192


def unpack_codes4_block(codes: jax.Array, m: int) -> jax.Array:
    """Device twin of :func:`unpack_codes4` for one scan block:
    ``[B, ⌈m/2⌉]`` nibble-packed bytes → ``[B, m]`` int32 codes."""
    c = codes.astype(jnp.int32)
    return jnp.stack([c & 15, c >> 4], axis=2).reshape(c.shape[0], -1)[:, :m]


@functools.partial(
    jax.jit,
    static_argnames=("k", "metric", "block_rows", "exact_lut", "packed4"),
)
def adc_topk(
    q,
    codes,  # [N, m] uint8 codes, or [N, ⌈m/2⌉] nibble-packed (packed4)
    codebooks,  # [m, ksub, dsub] f32
    recon_norms,  # [N] f32 ‖x̂‖²
    num_valid,
    k: int,
    metric: DistanceMetric,
    valid_mask=None,
    block_rows: int | None = None,
    exact_lut: bool = True,
    packed4: bool = False,
    group_bias=None,
    group_ids=None,
):
    """ADC top-k over PQ codes — the one scan behind PQ, IVF-PQ's masked
    scan and sharded PQ. Per block: ``Σ_j LUT[q, j·ksub + code_j]`` with
    ``LUT[q, j·ksub + c] = q_j · C[j, c]``, the metric epilogue on the
    reconstruction norms, and the carried top-k of
    :func:`~..ops.distances.scan_topk`.

    ``exact_lut=True`` gathers the f32 LUT entries of each row and sums
    them in f32, so scores equal an f64 ADC over the same codes to f32
    rounding. ``False`` one-hots the codes over the flattened
    ``(subspace, centroid)`` axis and runs one bf16 matmul against the LUT
    with f32 accumulation (~3 decimal digits — fine under re-ranking, and
    faster at 8-bit and 4-bit codes alike). ``q``: ``[Q, D]`` f32,
    pre-normalized for cosine. ``packed4``: codes are nibble-packed 4-bit
    (``ksub ≤ 16``) and are unpacked per block inside the scan, never as
    an ``[N, m]`` copy.

    ``group_bias [Q, G]`` / ``group_ids [N]``: IVF-PQ's probing. Row ``n``
    adds ``group_bias[q, group_ids[n]]`` (f32) to its dot — ``q·centroid``
    on probed buckets, −inf elsewhere — and rows with a negative group id
    never score.

    Returns ``(scores [Q, k] f32, indices [Q, k] int32)`` best-first; −1
    marks an unfilled slot."""
    metric = DistanceMetric(metric)
    n = codes.shape[0]
    m, ksub, dsub = codebooks.shape
    mk = m * ksub
    nq = q.shape[0]
    if packed4 and ksub > 16:
        raise ValueError(f"packed4 requires ksub <= 16, got {ksub}")
    if codes.shape[1] != ((m + 1) // 2 if packed4 else m):
        raise ValueError(
            f"codes [N, {codes.shape[1]}] do not match m={m} "
            f"(packed4={packed4})"
        )

    # LUT [Q, m*ksub]: dot of each query's subvector j with centroid (j, c).
    lut = jnp.einsum(
        "qmd,mkd->qmk",
        q.astype(jnp.float32).reshape(nq, m, dsub),
        codebooks,
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    ).reshape(nq, mk)
    col_base = ksub * jnp.arange(m, dtype=jnp.int32)[None, :]
    lut_t = lut.T.astype(jnp.bfloat16)
    iota_k = jax.lax.broadcasted_iota(jnp.int32, (1, 1, ksub), 2)
    rows = [codes, recon_norms]
    if group_bias is not None:
        rows.append(group_ids)
        gb = group_bias.astype(jnp.float32)

    def block_scores(cols, nrm, *gid):
        cols = (
            unpack_codes4_block(cols, m) if packed4 else cols.astype(jnp.int32)
        )
        if exact_lut:
            # [Q, B, m] gathered LUT entries, summed over subspaces
            dots = jnp.take(lut, cols + col_base, axis=1).sum(axis=-1)
        else:
            # per-subspace one-hot [B, m, ksub] = the flattened multi-hot
            # [B, m·ksub]: position (row, j·ksub + code[row, j]) is 1
            onehot = (cols[:, :, None] == iota_k).astype(jnp.bfloat16)
            dots = jax.lax.dot_general(
                lut_t, onehot.reshape(-1, mk),
                dimension_numbers=(((0,), (1,)), ((), ())),
                preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.DEFAULT,
            )  # [Q, B]
        if gid:
            g = gid[0]
            dots = dots + jnp.take(gb, jnp.maximum(g, 0), axis=1)
            dots = jnp.where(g[None, :] >= 0, dots, _NEG_INF)
        return score_epilogue(dots, nrm, metric)

    return scan_topk(
        block_scores, n, nq, k,
        DEFAULT_ADC_BLOCK_ROWS if block_rows is None else block_rows,
        jnp.asarray(num_valid, jnp.int32), rows, valid_mask,
    )


def _rerank(q, db, db_norms, cand_idx, k: int, metric: DistanceMetric):
    """Exact rescoring of PQ candidates: gather candidate rows and run the
    engine's f32-HIGHEST score algebra over the tiny ``[Q, R]`` candidate
    set. Invalid candidates (idx −1) are masked to −inf."""
    return _rerank_impl(q, db, db_norms, cand_idx, k, DistanceMetric(metric))


@functools.partial(jax.jit, static_argnames=("k", "metric"))
def _rerank_impl(q, db, db_norms, cand_idx, k: int, metric: DistanceMetric):
    safe = jnp.maximum(cand_idx, 0)
    vecs = jnp.take(db, safe.reshape(-1), axis=0).reshape(
        cand_idx.shape[0], cand_idx.shape[1], db.shape[1]
    )
    nrm = jnp.take(db_norms, safe.reshape(-1), axis=0).reshape(cand_idx.shape)
    dots = jnp.einsum(
        "qd,qrd->qr", q, vecs,
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    )
    if metric == DistanceMetric.L2:
        s = 2.0 * dots - nrm
    elif metric == DistanceMetric.COSINE:
        qnorm = jnp.sum(q.astype(jnp.float32) ** 2, axis=-1)
        qin = jax.lax.rsqrt(jnp.maximum(qnorm, 1e-30))
        s = dots * jax.lax.rsqrt(jnp.maximum(nrm, 1e-30)) * qin[:, None]
    else:
        s = dots
    s = jnp.where(cand_idx >= 0, s, _NEG_INF)
    top_s, pos = jax.lax.top_k(s, k)
    top_i = jnp.take_along_axis(cand_idx, pos, axis=1)
    top_i = jnp.where(top_s > _NEG_INF, top_i, -1)
    return top_s, top_i


# -------------------------------------------------------------- the index ---


@dataclasses.dataclass
class PQIndex:
    """Product-quantized view of one space, resident on device as codes
    (``4·D/m``× smaller than the f32 rows it stands in for).

    ``codebooks``: host ``[m, ksub, dsub]`` f32; ``codes``: device
    ``[N, m]`` uint8 — or nibble-packed ``[N, ⌈m/2⌉]`` when ``packed4``
    (4-bit PQ, ``ksub ≤ 16``: half the device bytes of byte codes at the
    same m); ``recon_norms``: device ``[N]`` f32
    squared norms of the *reconstructed* rows; ``db``/``db_norms``:
    optional device originals enabling exact re-ranking."""

    codebooks: np.ndarray
    codes: jax.Array
    recon_norms: jax.Array
    metric: DistanceMetric
    dim: int
    num_vectors: int
    db: jax.Array | None = None
    db_norms: jax.Array | None = None
    valid: jax.Array | None = None  # 1 = live, 0 = tombstoned
    packed4: bool = False
    # Host-side stable u64 ID column (reference ``schema/core.fbs:54``
    # semantics); result positions translate through it so ids stay valid
    # across compaction, like every brute-force surface.
    host_ids: np.ndarray | None = None
    # Preferred ADC scan tile (None = ``DEFAULT_ADC_BLOCK_ROWS``). Set by
    # :meth:`autotune` or adopted from persisted hints by :meth:`from_space`.
    adc_block_rows: int | None = None
    # File-backed origin (enables autotune(persist=True)); not part of the
    # value identity of the index.
    _host_space: object | None = dataclasses.field(
        default=None, repr=False, compare=False
    )

    @classmethod
    def build(
        cls,
        vectors: np.ndarray,
        metric: DistanceMetric,
        m: int = 16,
        ksub: int = 256,
        iters: int = 10,
        seed: int = 0,
        codebooks: np.ndarray | None = None,
        codes: np.ndarray | None = None,
        recon_norms: np.ndarray | None = None,
        keep_vectors: bool = True,
        valid_mask: np.ndarray | None = None,
        ids: np.ndarray | None = None,
        pack4: bool | None = None,
    ) -> "PQIndex":
        """Train (or accept precomputed) codebooks, encode, and upload. With
        ``keep_vectors`` the originals stay on device for re-ranking; without
        it only codes occupy device memory (the capacity-scaling mode). Passing
        everything precomputed (as persisted by ``Builder.set_pq_index``)
        skips training, encoding and reconstruction. ``pack4``: store the
        codes nibble-packed (4-bit PQ, requires ``ksub ≤ 16`` — half the
        code bytes). Opt-in (packing
        changes the public ``codes`` layout); precomputed codes whose
        column count is ``⌈m/2⌉`` are recognized as already packed."""
        vectors = np.ascontiguousarray(vectors, dtype=np.float32)
        n, d = vectors.shape
        if codebooks is None:
            codebooks = train_pq(vectors, m=m, ksub=ksub, iters=iters, seed=seed)
        codebooks = np.ascontiguousarray(codebooks, dtype=np.float32)
        m_eff, ksub_eff, _ = codebooks.shape
        already_packed = False
        if codes is None:
            codes = encode_pq(vectors, codebooks)
        else:
            codes = np.asarray(codes, np.uint8)
            already_packed = (
                codes.shape[1] == (m_eff + 1) // 2 and codes.shape[1] != m_eff
            )
        if pack4 is None:
            pack4 = already_packed
        if pack4 and ksub_eff > 16:
            raise ValueError(f"pack4 requires ksub <= 16, got {ksub_eff}")
        if recon_norms is None:
            recon = reconstruct_pq(
                unpack_codes4(codes, m_eff) if already_packed else codes,
                codebooks,
            )
            recon_norms = np.einsum(
                "ij,ij->i", recon.astype(np.float64), recon.astype(np.float64)
            ).astype(np.float32)
        if pack4 and not already_packed:
            codes = pack_codes4(codes)
        recon_norms = np.ascontiguousarray(recon_norms, dtype=np.float32)
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
        valid = None
        if valid_mask is not None:
            valid = jax.device_put(
                (~np.asarray(valid_mask, dtype=bool)).astype(np.int32)
            )
        if ids is not None:
            ids = np.ascontiguousarray(ids, dtype=np.uint64).reshape(-1)
        return cls(
            codebooks=codebooks,
            codes=put_chunked(np.asarray(codes, np.uint8)),
            recon_norms=jax.device_put(recon_norms),
            metric=DistanceMetric(metric),
            dim=d,
            num_vectors=n,
            db=db,
            db_norms=db_norms,
            valid=valid,
            host_ids=ids,
            packed4=bool(pack4),
        )

    @classmethod
    def from_space(
        cls,
        space,
        m: int = 16,
        ksub: int = 256,
        iters: int = 10,
        seed: int = 0,
        keep_vectors: bool = True,
    ) -> "PQIndex":
        """Build the search-ready index for a host
        :class:`~metrovector_tpu.vectors.space.VectorSpace`, reusing
        codebooks/codes persisted in the file when present (O(1)-open:
        no retraining, no re-encoding). Tombstoned rows are masked."""
        stored = space.pq_arrays()
        codebooks = codes = stored_rnorms = None
        if stored is not None and not space.info.pq.residual:
            # Residual sidecars encode x − centroid and belong to
            # :class:`.ivfpq.IVFPQIndex`; plain PQ retrains on raw rows.
            codebooks, codes, stored_rnorms = stored
        if stored_rnorms is not None and not keep_vectors:
            # Code-only fast path: everything needed lives in the sidecar —
            # never touch (or page in) the dense rows.
            valid = None
            mask = space.tombstone_mask()
            if mask is not None:
                valid = jax.device_put((~mask).astype(np.int32))
            idx = cls(
                codebooks=np.ascontiguousarray(codebooks, np.float32),
                codes=put_chunked(np.ascontiguousarray(codes, np.uint8)),
                recon_norms=jax.device_put(
                    np.ascontiguousarray(stored_rnorms, np.float32)
                ),
                metric=DistanceMetric(space.metric),
                dim=space.dim,
                num_vectors=space.num_vectors,
                valid=valid,
                host_ids=space.ids(),
                packed4=bool(space.info.pq.packed4),
            )
            return cls._adopt_hints(idx, space)
        vectors = np.asarray(space.to_numpy(), dtype=np.float32)
        q = space.quantization
        if q is not None:
            vectors = (vectors - q.zero_point) * q.scale
        idx = cls.build(
            vectors,
            space.metric,
            m=m,
            ksub=ksub,
            iters=iters,
            seed=seed,
            codebooks=codebooks,
            codes=codes,
            recon_norms=stored_rnorms,
            keep_vectors=keep_vectors,
            valid_mask=space.tombstone_mask(),
            ids=space.ids(),
        )
        return cls._adopt_hints(idx, space)

    @staticmethod
    def _adopt_hints(idx, space):
        """Adopt a persisted tuned ADC tiling (``autotune(persist=True)``
        wrote it into the file's PerformanceHints) and remember the
        file-backed origin so :meth:`autotune` can persist back."""
        from ..utils.tune import tuned_hints

        h = tuned_hints(space, "adc")
        if h.get("block_rows"):
            idx.adc_block_rows = int(h["block_rows"])
        idx._host_space = space
        return idx

    @property
    def m(self) -> int:
        return int(self.codebooks.shape[0])

    @property
    def ksub(self) -> int:
        return int(self.codebooks.shape[1])

    @property
    def code_bytes_per_vector(self) -> int:
        return (self.m + 1) // 2 if self.packed4 else self.m

    # -- online mutation ------------------------------------------------------

    def add_rows(
        self, vectors: np.ndarray, ids=None, reserve: float = 1.5
    ) -> None:
        """Encode new rows with the EXISTING codebooks and append to the
        live coded corpus (no retraining — quantization error for data far
        outside the trained distribution grows accordingly; retrain via
        ``build`` when drift matters). Device arrays grow in capacity
        steps (``reserve`` factor) so kernel shapes stay stable and
        recompiles amortize, mirroring ``DeviceSpace.add_rows`` — including
        its ID contract: appends must carry ``ids`` iff the index has an ID
        column."""
        from ..errors import DimensionMismatchError

        vectors = np.ascontiguousarray(vectors, dtype=np.float32)
        if vectors.ndim == 1:
            vectors = vectors[None]
        if vectors.shape[1] != self.dim:
            raise DimensionMismatchError(
                expected=self.dim, actual=int(vectors.shape[1])
            )
        from ..engine import merged_append_ids

        n_new = vectors.shape[0]
        merged_ids = merged_append_ids(
            self.host_ids, ids, n_new, self.num_vectors
        )
        codes_new = encode_pq(vectors, self.codebooks)
        recon = reconstruct_pq(codes_new, self.codebooks)
        rn_new = np.einsum(
            "ij,ij->i", recon.astype(np.float64), recon.astype(np.float64)
        ).astype(np.float32)
        if self.packed4:
            codes_new = pack_codes4(codes_new)

        total = self.num_vectors + n_new
        cap = int(self.codes.shape[0])
        if total > cap:
            cap = max(
                -(-total // 128) * 128,
                -(-int(cap * reserve) // 128) * 128,
            )

        def grown(old_dev, new_host, fill=0.0, dtype=None):
            old = np.asarray(old_dev)
            dtype = dtype or old.dtype
            out = np.full((cap,) + old.shape[1:], fill, dtype=dtype)
            out[: self.num_vectors] = old[: self.num_vectors]
            out[self.num_vectors : total] = new_host
            return jax.device_put(out)

        self.codes = grown(self.codes, codes_new)
        self.recon_norms = grown(self.recon_norms, rn_new)
        if self.db is not None:
            vn = np.einsum(
                "ij,ij->i",
                vectors.astype(np.float64),
                vectors.astype(np.float64),
            ).astype(np.float32)
            self.db = grown(self.db, vectors)
            self.db_norms = grown(self.db_norms, vn)
        if self.valid is not None:
            self.valid = grown(
                self.valid, np.ones(n_new, np.int32), fill=1
            )
        if merged_ids is not None:
            self.host_ids = merged_ids
        self.num_vectors = total

    def delete_rows(self, rows) -> None:
        """Tombstone coded rows by position; they can never surface in
        results afterwards."""
        from ..errors import IndexOutOfBoundsError

        idx = [int(r) for r in np.atleast_1d(rows)]
        for r in idx:
            if r < 0 or r >= self.num_vectors:
                raise IndexOutOfBoundsError(r, self.num_vectors)
        valid = (
            np.asarray(self.valid)
            if self.valid is not None
            else np.ones(int(self.codes.shape[0]), np.int32)
        ).copy()
        valid[np.asarray(idx, np.int64)] = 0
        self.valid = jax.device_put(valid.astype(np.int32))

    def recommended_rerank(self, k: int = 10, recall_target: float = 1.0) -> int:
        """Rerank depth expected to reach ``recall_target`` at this ``k``
        (the plain-PQ mirror of ``IVFPQIndex.recommended_rerank``, anchored
        at the same observation: ``rerank = 40·k`` reached recall 1.000 on
        both the 8-bit m=16/ksub=256 and 4-bit m=32/ksub=16 configs on a
        1M×128 clustered corpus). Guidance for corpora of similar difficulty, not a guarantee;
        returns 0 when the raw ADC scan alone is expected to meet the
        target. Requires ``keep_vectors`` originals to actually rerank."""
        if not 0.0 < recall_target <= 1.0:
            raise ValueError(
                f"recall_target must be in (0, 1], got {recall_target}"
            )
        raw = 0.63 if self.packed4 else 0.72
        if recall_target <= raw:
            return 0
        if recall_target >= 0.99:
            factor = 40
        elif recall_target >= 0.9:
            factor = 20
        else:
            factor = 12 if self.packed4 else 10
        return factor * k

    def prepare_filter(self, filter_mask):
        """Upload a ``[num_vectors]`` boolean/int row predicate once and
        return a :class:`~metrovector_tpu.engine.PreparedFilter` reusable
        across :meth:`search` calls (the serving path for a hot predicate).
        Composed with the live tombstone plane at launch, so deletions
        made after preparation are still honored. Invalidated by
        :meth:`add_rows` (capacity growth changes the padded length)."""
        from ..engine import PreparedFilter
        from ..utils.filters import padded_filter_plane

        full = padded_filter_plane(
            filter_mask, self.num_vectors, self.codes.shape[0], np.int32
        )
        return PreparedFilter(
            mask=jax.device_put(full), num_valid=self.num_vectors
        )

    def _effective_mask(self, filter_mask):
        """Compose the user predicate (raw array or PreparedFilter) with
        the tombstone plane into the kernel's validity input."""
        if filter_mask is None:
            return self.valid
        from ..engine import PreparedFilter
        from ..utils.filters import checked_prepared_mask

        if isinstance(filter_mask, PreparedFilter):
            fdev = checked_prepared_mask(
                filter_mask, self.num_vectors, self.codes.shape[0]
            )
        else:
            fdev = self.prepare_filter(filter_mask).mask
        if self.valid is None:
            return fdev
        return self.valid * fdev.astype(self.valid.dtype)

    def search(
        self,
        queries: np.ndarray,
        k: int = 10,
        rerank: int = 0,
        exact_lut: bool = True,
        block_rows: int | None = None,
        filter_mask=None,
    ):
        """Approximate top-k by ADC over the codes (:func:`adc_topk`).
        ``rerank=R`` (R ≥ k) rescores the top-R ADC candidates against the
        original vectors (requires ``keep_vectors``/``db``), typically
        recovering recall@k ≈ 1.0 with R ≈ 4–8·k. ``filter_mask``:
        optional ``[num_vectors]`` boolean/int row predicate (or a prepared
        one from :meth:`prepare_filter`) — rows with 0 are excluded from
        the ADC scan itself (so the ``rerank`` candidate pool is all
        filter-passing), composed with tombstones exactly like the dense
        engine (``SearchEngine.search``). Under very low selectivity,
        raise ``rerank`` — recall within the filtered subset is bounded by
        how many passing rows the ADC fetch surfaces. Returns a
        ``SearchResult``."""
        from ..engine import SearchResult

        q = np.ascontiguousarray(queries, np.float32)
        if q.ndim == 1:
            q = q[None]
        if q.shape[1] != self.dim:
            from ..errors import DimensionMismatchError

            raise DimensionMismatchError(expected=self.dim, actual=int(q.shape[1]))
        qnorms = np.einsum("ij,ij->i", q, q, dtype=np.float64).astype(np.float32)
        qdev = jax.device_put(q)
        eff_valid = self._effective_mask(filter_mask)
        fetch = max(k, rerank) if rerank else k
        fetch = min(fetch, self.num_vectors) or 1
        qk = qdev
        if self.metric == DistanceMetric.COSINE:
            qk = qdev * jax.lax.rsqrt(
                jnp.maximum(jnp.sum(qdev * qdev, axis=1, keepdims=True), 1e-30)
            )
        s, i = adc_topk(
            qk, self.codes, jnp.asarray(self.codebooks), self.recon_norms,
            self.num_vectors, fetch, self.metric, valid_mask=eff_valid,
            block_rows=self.adc_block_rows if block_rows is None
            else block_rows,
            exact_lut=exact_lut, packed4=self.packed4,
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
                 block_rows_candidates=None, iters: int = 3,
                 apply: bool = True, persist: bool = False,
                 **search_kw) -> list[dict]:
        """Measure candidate ADC ``block_rows`` with single-launch timings
        (one launch, one forced readback each) and optionally apply the
        fastest as this index's default scan tile.

        ``**search_kw`` reaches :meth:`search` (e.g. ``rerank=``,
        ``exact_lut=``) so the measured configuration is the served one.
        ``apply=True`` sets :attr:`adc_block_rows`; ``persist=True``
        additionally writes it into the source file's PerformanceHints
        (``hints["tuned"][space]["adc"]``) — requires an index built via
        :meth:`from_space` on a file-backed space."""
        from ..utils.tune import block_rows_around, measure_candidates

        if persist and self._host_space is None:
            raise ValueError(
                "persist requires an index built from a file-backed "
                "VectorSpace (PQIndex.from_space)"
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
                # search returns host arrays — the readback is inherent
                self.search(queries, k=k, block_rows=cfg["block_rows"],
                            **search_kw)
            return run

        results = measure_candidates(candidates, run_with, iters)
        if apply and results and np.isfinite(results[0]["ms"]):
            self.adc_block_rows = results[0]["block_rows"]
            if persist:
                from ..utils.tune import persist_tuned

                persist_tuned(
                    self._host_space, "adc",
                    {"block_rows": self.adc_block_rows},
                )
        elif persist:
            raise RuntimeError(
                "nothing persisted: no finite-time winner to apply "
                f"(apply={apply})"
            )
        return results
