"""Distance score conventions and the exact top-k scan.

The scalar loops of the reference (`examples/similarity_search.rs:140-176`,
`examples/simple.rs:80-87` in thegenem0/metrovector) re-expressed as batched
matrix algebra: every dense search surface (single device, sharded,
streamed) runs :func:`exact_topk`, and tests compare it against the NumPy
oracle :func:`numpy_oracle`.

Score convention
----------------
Internally every metric is mapped to a **score where greater is better**, so
top-k is always a max-k:

* ``INNER_PRODUCT``: ``score = q · x``
* ``COSINE``:        ``score = (q · x) / (‖q‖ ‖x‖)``
* ``L2``:            ``score = 2 q·x − ‖x‖²``  (= ``‖q‖² − ‖q−x‖²``; the
  per-query ``‖q‖²`` shifts all scores equally and cannot change ranking,
  so it is omitted from selection and only restored when converting scores
  to user-facing distances)

All accumulation is f32 regardless of storage dtype (int8 accumulates in
int32; `preferred_element_type=f32` guards against catastrophic
cancellation for near-duplicate vectors — SURVEY.md §7 "exactness").

Exactness contract
------------------
Rankings are exact up to f32 score resolution of the expanded form: two DB
rows whose expanded-form scores differ by less than ~1 ulp at the score's
magnitude (≈1.2e-7 · ‖x‖²) may swap. On integer-valued corpora (SIFT/DEEP
style) every score is exactly representable and rankings are absolutely
exact. For adversarial float data where ‖q−x‖² ≪ ‖x‖² (dense clusters far
from the origin), the reference's direct ``Σ(a−b)²`` form
(`examples/similarity_search.rs:152-157`) resolves ties the expanded form
cannot; such ties are physically meaningless at f32 input precision but can
flip the tail of a top-k list.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..format.constants import DistanceMetric

# Plain Python float: a module-level jnp scalar would initialize the
# XLA backend at import time, breaking jax.distributed.initialize
# in multi-process programs. Weak-typed, so traced uses are identical.
_NEG_INF = float("-inf")

PRECISIONS = ("highest", "high", "default")
# Corpus rows scored per scan step: the [Q, block_rows] f32 score tile is
# the only per-step intermediate (16 MB at Q=256).
DEFAULT_BLOCK_ROWS = 16384
# Query rows are scored in multiples of this many (zero-padded).
QUERY_TILE = 8

_DIMS = (((1,), (1,)), ((), ()))


def _dot(a, b, precision):
    return jax.lax.dot_general(
        a, b, dimension_numbers=_DIMS,
        preferred_element_type=jnp.float32, precision=precision,
    )


def _split_bf16(v):
    """``v = hi + lo`` with ``hi`` = v rounded to bf16 and ``lo`` the bf16
    rounding of the exact f32 remainder. The rounding is a
    ``reduce_precision``, not an f32→bf16→f32 convert pair: XLA may drop
    such a pair as excess precision (it does on the GPU), which zeroes
    ``lo`` and leaves one bf16 dot."""
    hi = jax.lax.reduce_precision(v, exponent_bits=8, mantissa_bits=7)
    return hi.astype(jnp.bfloat16), (v - hi).astype(jnp.bfloat16)


def block_dots(queries: jax.Array, db: jax.Array,
               precision: str = "highest") -> jax.Array:
    """Raw ``[Q, N]`` f32 dot products of query rows with corpus rows.

    * int8 operands: an integer dot with int32 accumulation (exact), cast
      to f32.
    * bf16 operands: one bf16 dot with f32 accumulation.
    * f32 operands, ``precision``:

      - ``"highest"``: f32 inputs at ``Precision.HIGHEST`` (no TF32);
      - ``"high"``: three explicit bf16 dots with f32 accumulation,
        ``q_hi·x_hi + q_hi·x_lo + q_lo·x_hi`` (``v = v_hi + v_lo`` splits
        each value into two bf16 parts; the dropped ``q_lo·x_lo`` term is
        ≤ 2⁻¹⁶ relative);
      - ``"default"``: bf16 operands with f32 accumulation.

    Every dot names its precision: an unnamed f32 dot may run in TF32.
    """
    if precision not in PRECISIONS:
        raise ValueError(
            f"unknown precision {precision!r}; one of {PRECISIONS}"
        )
    if jnp.issubdtype(db.dtype, jnp.integer):
        return jax.lax.dot_general(
            queries, db, dimension_numbers=_DIMS,
            preferred_element_type=jnp.int32,
            precision=jax.lax.Precision.DEFAULT,
        ).astype(jnp.float32)
    default = jax.lax.Precision.DEFAULT
    if db.dtype == jnp.bfloat16 or precision == "default":
        return _dot(
            queries.astype(jnp.bfloat16), db.astype(jnp.bfloat16), default
        )
    q32 = queries.astype(jnp.float32)
    x32 = db.astype(jnp.float32)
    if precision == "high":
        q_hi, q_lo = _split_bf16(q32)
        x_hi, x_lo = _split_bf16(x32)
        dots = _dot(q_hi, x_hi, default)
        dots += _dot(q_hi, x_lo, default)
        dots += _dot(q_lo, x_hi, default)
        return dots
    return _dot(q32, x32, jax.lax.Precision.HIGHEST)


def score_epilogue(dots, db_norms, metric):
    """Greater-is-better ``[Q, N]`` scores from raw dots and the rows'
    squared norms (queries pre-normalized for cosine)."""
    metric = DistanceMetric(metric)
    if metric == DistanceMetric.INNER_PRODUCT:
        return dots
    if metric == DistanceMetric.L2:
        return 2.0 * dots - db_norms[None, :]
    if metric == DistanceMetric.COSINE:
        # queries are pre-normalized by the caller; finish with 1/‖x‖
        return dots * jax.lax.rsqrt(jnp.maximum(db_norms, 1e-30))[None, :]
    raise NotImplementedError(f"metric {metric!r} has no built-in score")


def scores_to_distances(
    scores: jax.Array, metric: DistanceMetric, query_sq_norms: jax.Array | None = None
) -> jax.Array:
    """Convert internal scores to the user-facing quantity per metric:
    Euclidean distance for L2 (ascending = better, like the reference's
    ``find_top_k_similar``), similarity in [-1, 1] for cosine, raw dot
    product for inner product."""
    metric = DistanceMetric(metric)
    if metric == DistanceMetric.L2:
        if query_sq_norms is None:
            raise ValueError("L2 distance conversion requires query norms")
        return jnp.sqrt(jnp.maximum(query_sq_norms[:, None] - scores, 0.0))
    return scores


def distances_np(
    scores, metric: DistanceMetric, query_sq_norms=None
):
    """NumPy twin of :func:`scores_to_distances` for host-side result
    finalization — the conversion is trivial elementwise math, and routing
    it through jax from host arrays would add a host↔device round trip per
    query batch."""
    metric = DistanceMetric(metric)
    scores = np.asarray(scores)
    if metric == DistanceMetric.L2:
        if query_sq_norms is None:
            raise ValueError("L2 distance conversion requires query norms")
        return np.sqrt(
            np.maximum(np.asarray(query_sq_norms)[:, None] - scores, 0.0)
        )
    return scores


def scan_topk(block_scores, n: int, nq: int, k: int, block_rows: int,
              num_valid, row_arrays=(), valid_mask=None):
    """Blocked top-k over ``n`` rows with a carried ``[Q, k]`` candidate
    list, so the full ``[Q, N]`` score matrix never materializes.

    ``block_scores(*blocks)`` returns the ``[Q, block_rows]`` f32 scores of
    one block of rows; ``blocks`` are the matching slices of each
    ``row_arrays`` entry (row-major, leading axis
    ``n``). Blocks are read in place with ``dynamic_slice`` — no padded
    copy of the corpus. The last block is clamped to end at row ``n``;
    rows it re-reads were already scored and are masked out.

    Returns ``(scores [Q, k], indices [Q, k] int32)`` best-first. Equal
    scores keep the lowest row index (``lax.top_k`` is stable and every
    block's rows follow the carried candidates), and −1 marks an unfilled
    slot (fewer than ``k`` live rows)."""
    if block_rows < 1:
        raise ValueError(f"block_rows must be >= 1, got {block_rows}")
    br = min(block_rows, n)
    nblocks = -(-n // br)

    def step(i, carry):
        best_s, best_i = carry
        first = i * br
        start = jnp.minimum(first, n - br)
        blocks = [jax.lax.dynamic_slice_in_dim(a, start, br) for a in row_arrays]
        s = block_scores(*blocks)
        rows = start + jax.lax.broadcasted_iota(jnp.int32, (1, br), 1)
        live = (rows >= first) & (rows < num_valid)
        if valid_mask is not None:
            msk = jax.lax.dynamic_slice_in_dim(valid_mask, start, br)
            live = live & (msk[None, :] != 0)
        s = jnp.where(live, s, _NEG_INF)
        cand_s = jnp.concatenate([best_s, s], axis=1)
        cand_i = jnp.concatenate(
            [best_i, jnp.broadcast_to(rows, (nq, br))], axis=1
        )
        top_s, pos = jax.lax.top_k(cand_s, k)
        return top_s, jnp.take_along_axis(cand_i, pos, axis=1)

    init = (
        jnp.full((nq, k), _NEG_INF, dtype=jnp.float32),
        jnp.full((nq, k), -1, dtype=jnp.int32),
    )
    best_s, best_i = jax.lax.fori_loop(0, nblocks, step, init)
    return best_s, jnp.where(jnp.isneginf(best_s), -1, best_i)


@functools.partial(
    jax.jit,
    static_argnames=("k", "metric", "precision", "block_rows", "dequant"),
)
def exact_topk(
    queries: jax.Array,
    db: jax.Array,
    db_norms: jax.Array,
    num_valid,
    k: int,
    metric: DistanceMetric,
    valid_mask: jax.Array | None = None,
    scale=1.0,
    bias_row: jax.Array | None = None,
    bias_scale=0.0,
    precision: str = "highest",
    block_rows: int | None = None,
    dequant: tuple[float, float] | None = None,
) -> tuple[jax.Array, jax.Array]:
    """Exact top-k over one resident corpus block: per block, the dots of
    :func:`block_dots`, the affine corrections, the metric epilogue and a
    carried top-k (:func:`scan_topk`).

    Args:
      queries: ``[Q, D]`` in the corpus' compute dtype (pre-normalized for
        cosine; pre-quantized int8 for integer corpora).
      db: ``[N, D]`` corpus (f32 / bf16 / f16 / int8).
      db_norms: ``[N]`` f32 squared L2 norms in dequantized value space.
      num_valid: scalar — rows ≥ this are padding.
      k, metric: static.
      valid_mask: optional ``[N]``; 0 ⇒ row is tombstoned or filtered.
      scale: multiplier on the raw dots (int8: the combined dequant factor
        ``s_q·s_x``). Traced, so per-batch query scales share one program.
      bias_row / bias_scale: optional ``[N]`` f32 per-row additive dot
        correction, ``dots += bias_scale · bias_row`` (the offset-uint8
        path's per-row code sums, see ``DeviceSpace.prepare_queries``).
      precision: ``"highest"`` / ``"high"`` / ``"default"``, see
        :func:`block_dots`.
      block_rows: rows per scan step (static; default
        :data:`DEFAULT_BLOCK_ROWS`).
      dequant: static ``(offset, dq_scale)`` — score the affine-coded
        corpus as ``x = (c + offset)·dq_scale`` per block (affine-uint8
        cosine: ``offset = 128 − zero_point``), with f32 queries.

    Returns ``(scores [Q, k] f32, indices [Q, k] int32)`` best-first with
    the greater-is-better convention above; −1 marks an unfilled slot.
    """
    n, nq = db.shape[0], queries.shape[0]
    # Score whole QUERY_TILE-row groups, so a query's dots come from the
    # same matmul shape whether it is searched alone or in a small batch.
    queries = jnp.pad(queries, ((0, -nq % QUERY_TILE), (0, 0)))
    br = DEFAULT_BLOCK_ROWS if block_rows is None else block_rows
    scale = jnp.asarray(scale, jnp.float32)
    bias_scale = jnp.asarray(bias_scale, jnp.float32)
    rows = [db, db_norms] + ([bias_row] if bias_row is not None else [])

    def block_scores(blk, nrm, *bias):
        if dequant is not None:
            off, dq = dequant
            blk = (blk.astype(jnp.float32) + jnp.float32(off)) * jnp.float32(dq)
        dots = block_dots(queries, blk, precision) * scale
        if bias:
            dots = dots + bias_scale * bias[0][None, :]
        return score_epilogue(dots, nrm, metric)

    s, i = scan_topk(
        block_scores, n, queries.shape[0], k, br,
        jnp.asarray(num_valid, jnp.int32), rows, valid_mask,
    )
    return s[:nq], i[:nq]


@functools.partial(jax.jit, static_argnames=("k", "metric"))
def rescore_topk(
    queries: jax.Array,
    db: jax.Array,
    db_norms: jax.Array,
    cand_idx: jax.Array,
    k: int,
    metric: DistanceMetric,
) -> tuple[jax.Array, jax.Array]:
    """Exact (f32 HIGHEST) re-scoring of a small candidate set, returning
    the verified top-k — the second stage of the engine's
    ``precision="high_verified"`` mode (a 'high' fetch of ``k + margin``
    candidates, then this tiny exact pass repairs any sub-ulp boundary
    swaps at the rank-k/k+1 boundary).

    ``queries``: ``[Q, D]`` f32 (cosine queries pre-normalized, matching
    :meth:`DeviceSpace.prepare_queries`). ``cand_idx``: ``[Q, m]`` row
    indices from the approximate pass, ``m ≥ k``; ``-1`` marks unfilled
    slots (fewer than m unmasked rows) and stays ``-1`` in the output.
    The candidate gather is ``Q·m`` rows — microscopic next to the full
    scan. Ties break to the lowest row index (two-key ``lax.sort``),
    matching :func:`numpy_oracle` exactly.
    """
    metric = DistanceMetric(metric)
    q = queries.astype(jnp.float32)
    valid = cand_idx >= 0
    safe = jnp.where(valid, cand_idx, 0)
    cand = jnp.take(db, safe, axis=0).astype(jnp.float32)  # [Q, m, D]
    dots = jax.lax.dot_general(
        q,
        cand,
        dimension_numbers=(((1,), (2,)), ((0,), (0,))),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )  # [Q, m]
    nrm = jnp.take(db_norms, safe)  # [Q, m]
    if metric == DistanceMetric.L2:
        scores = 2.0 * dots - nrm
    elif metric == DistanceMetric.COSINE:
        qin = jax.lax.rsqrt(jnp.maximum(jnp.sum(q * q, axis=-1), 1e-30))
        scores = dots * jax.lax.rsqrt(jnp.maximum(nrm, 1e-30)) * qin[:, None]
    elif metric == DistanceMetric.INNER_PRODUCT:
        scores = dots
    else:
        raise NotImplementedError(
            f"metric {metric!r} has no built-in score kernel"
        )
    scores = jnp.where(valid, scores, _NEG_INF)
    tie = jnp.where(valid, cand_idx, jnp.int32(2**31 - 1))
    neg_s, idx_sorted = jax.lax.sort(
        (-scores, tie), dimension=-1, num_keys=2, is_stable=True
    )
    top_s = -neg_s[:, :k]
    top_i = idx_sorted[:, :k]
    return top_s, jnp.where(jnp.isneginf(top_s), -1, top_i)


def numpy_oracle(queries, db, k, metric, valid_mask=None):
    """Reference-semantics brute force in NumPy (the scalar loops of
    ``examples/similarity_search.rs:140-176`` vectorized, f64 accumulation):
    ground truth for parity tests. Returns (scores [Q,k], indices [Q,k])."""
    q = np.asarray(queries, dtype=np.float64)
    x = np.asarray(db, dtype=np.float64)
    metric = DistanceMetric(metric)
    if metric == DistanceMetric.L2:
        d2 = ((q[:, None, :] - x[None, :, :]) ** 2).sum(-1)
        s = -d2  # greater-is-better, offset by ‖q‖² vs the jax convention
        s += (q * q).sum(-1)[:, None]
    elif metric == DistanceMetric.COSINE:
        s = (q @ x.T) / np.maximum(
            np.linalg.norm(q, axis=1)[:, None] * np.linalg.norm(x, axis=1)[None, :],
            1e-30,
        )
    elif metric == DistanceMetric.INNER_PRODUCT:
        s = q @ x.T
    else:
        raise NotImplementedError(metric)
    if valid_mask is not None:
        s = np.where(np.asarray(valid_mask)[None, :] != 0, s, -np.inf)
    # Rank at f32 granularity — the precision every engine actually scores
    # in. Ranking the raw f64 values is subtly WRONG for exact-duplicate
    # rows: BLAS dgemm's blocking can give bit-identical columns 1-ulp-
    # different f64 results depending on their position, silently breaking
    # the lowest-index tie contract this oracle defines (found by the
    # duplicate-heavy fuzzer on cosine/IP; the L2 path's elementwise
    # reduction was immune). Casting collapses sub-f32-ulp positional
    # noise so ties are ties.
    s = s.astype(np.float32)
    idx = np.argsort(-s, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(s, idx, axis=1), idx
