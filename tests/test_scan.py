"""The exact top-k scan (``ops.distances.exact_topk``) against the NumPy
oracle: single and multi block, ragged tails, ``num_valid``, tombstones,
query padding, bf16 / int8 corpora, k > 128, tie order, the precision
ladder, the offset-uint8 ``bias_row`` algebra and affine dequantization.
"""

import jax
import ml_dtypes
import numpy as np
import pytest

from metrovector_tpu import DistanceMetric
from metrovector_tpu.ops import exact_topk, numpy_oracle
from metrovector_tpu.ops.distances import (
    PRECISIONS,
    QUERY_TILE,
    block_dots,
)

METRICS = [DistanceMetric.L2, DistanceMetric.COSINE, DistanceMetric.INNER_PRODUCT]


def _case(rng, n, d, q):
    db = rng.standard_normal((n, d)).astype(np.float32)
    queries = rng.standard_normal((q, d)).astype(np.float32)
    norms = (db.astype(np.float64) ** 2).sum(1).astype(np.float32)
    return queries, db, norms


def _unit(q):
    return q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-30)


def _run(queries, db, norms, n_valid, k, metric, **kw):
    q = _unit(queries) if metric == DistanceMetric.COSINE else queries
    return exact_topk(q, db, norms, n_valid, k, metric, **kw)


def _overlap(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return min(len(set(a[r]) & set(b[r])) / a.shape[1] for r in range(len(a)))


@pytest.mark.parametrize("metric", METRICS)
def test_scan_matches_oracle_single_block(rng, metric):
    queries, db, norms = _case(rng, n=512, d=64, q=5)
    _, i = _run(queries, db, norms, 512, 10, metric, block_rows=512)
    _, oi = numpy_oracle(queries, db, 10, metric)
    assert np.array_equal(np.asarray(i), oi)


@pytest.mark.parametrize("metric", METRICS)
def test_scan_multi_block(rng, metric):
    queries, db, norms = _case(rng, n=1024, d=64, q=3)
    _, i = _run(queries, db, norms, 1024, 7, metric, block_rows=256)
    _, oi = numpy_oracle(queries, db, 7, metric)
    assert np.array_equal(np.asarray(i), oi)


def test_scan_ragged_last_block(rng):
    """N not a multiple of block_rows: the last block is clamped to end at
    row N and the rows it re-reads are not scored twice."""
    queries, db, norms = _case(rng, n=640, d=32, q=2)
    _, i = _run(queries, db, norms, 640, 50, DistanceMetric.L2, block_rows=256)
    _, oi = numpy_oracle(queries, db, 50, DistanceMetric.L2)
    assert np.array_equal(np.asarray(i), oi)
    assert all(len(set(r)) == 50 for r in np.asarray(i))


def test_scan_num_valid_masks_padding(rng):
    queries, db, norms = _case(rng, n=512, d=32, q=2)
    db[200:] = 1000.0  # rows ≥ 200 are tile padding with garbage
    norms[200:] = 0.0
    _, i = _run(queries, db, norms, 200, 8, DistanceMetric.INNER_PRODUCT,
                block_rows=256)
    assert np.asarray(i).max() < 200
    _, oi = numpy_oracle(queries, db[:200], 8, DistanceMetric.INNER_PRODUCT)
    assert np.array_equal(np.asarray(i), oi)


def test_scan_tombstones(rng):
    queries, db, norms = _case(rng, n=256, d=32, q=2)
    _, base = _run(queries, db, norms, 256, 1, DistanceMetric.L2)
    mask = np.ones(256, np.float32)
    mask[np.asarray(base).ravel()] = 0.0
    _, i2 = _run(queries, db, norms, 256, 4, DistanceMetric.L2,
                 valid_mask=mask, block_rows=64)
    assert not np.intersect1d(np.asarray(i2), np.asarray(base)).size
    _, oi = numpy_oracle(queries, db, 4, DistanceMetric.L2, valid_mask=mask)
    assert np.array_equal(np.asarray(i2), oi)


def test_scan_query_tile_padding(rng):
    """Q not a multiple of the query tile (and more than one tile): the
    zero-padded query rows never reach the output."""
    queries, db, norms = _case(rng, n=256, d=32, q=2 * QUERY_TILE + 3)
    s, i = _run(queries, db, norms, 256, 3, DistanceMetric.L2, block_rows=64)
    assert np.asarray(i).shape == (2 * QUERY_TILE + 3, 3)
    _, oi = numpy_oracle(queries, db, 3, DistanceMetric.L2)
    assert np.array_equal(np.asarray(i), oi)


def test_scan_query_alone_or_batched_bit_identical(rng):
    """A query's scores do not depend on how many queries share its
    batch (up to one query tile): the serving batcher relies on it."""
    queries, db, norms = _case(rng, n=300, d=48, q=5)
    s_all, i_all = _run(queries, db, norms, 300, 6, DistanceMetric.L2)
    for r in range(5):
        s1, i1 = _run(queries[r:r + 1], db, norms, 300, 6, DistanceMetric.L2)
        np.testing.assert_array_equal(np.asarray(i1)[0], np.asarray(i_all)[r])
        np.testing.assert_array_equal(np.asarray(s1)[0], np.asarray(s_all)[r])


def test_scan_bf16_db(rng):
    queries, db, norms = _case(rng, n=512, d=64, q=4)
    db16 = db.astype(ml_dtypes.bfloat16)
    norms16 = (db16.astype(np.float64) ** 2).sum(1).astype(np.float32)
    _, i = exact_topk(
        queries.astype(ml_dtypes.bfloat16), db16, norms16, 512, 10,
        DistanceMetric.L2, block_rows=128,
    )
    # bf16 rounding perturbs near-ties; require strong overlap w/ f32 truth.
    _, oi = numpy_oracle(queries, db, 10, DistanceMetric.L2)
    assert _overlap(i, oi) >= 0.8


def test_scan_int8_symmetric(rng):
    d = 64
    x = rng.standard_normal((384, d)).astype(np.float32)
    scale_x = float(np.abs(x).max()) / 127.0
    codes = np.clip(np.rint(x / scale_x), -128, 127).astype(np.int8)
    deq = codes.astype(np.float32) * scale_x
    norms = (deq.astype(np.float64) ** 2).sum(1).astype(np.float32)

    queries = rng.standard_normal((3, d)).astype(np.float32)
    scale_q = float(np.abs(queries).max()) / 127.0
    qcodes = np.clip(np.rint(queries / scale_q), -128, 127).astype(np.int8)

    s, i = exact_topk(
        qcodes, codes, norms, 384, 10, DistanceMetric.INNER_PRODUCT,
        scale=scale_q * scale_x, block_rows=128,
    )
    # The scan computes sq·sx·(integer dot), which equals the dequantized
    # dot: ranking matches the dequantized-float oracle exactly.
    _, oi = numpy_oracle(qcodes.astype(np.float32) * scale_q, deq, 10,
                         DistanceMetric.INNER_PRODUCT)
    assert np.array_equal(np.asarray(i), oi)
    deq_scores = (qcodes.astype(np.float64) * scale_q) @ deq.T.astype(np.float64)
    np.testing.assert_allclose(
        np.asarray(s), np.take_along_axis(deq_scores, oi, 1), rtol=1e-5
    )


def test_scan_k_exceeds_128(rng):
    queries, db, norms = _case(rng, n=512, d=32, q=2)
    _, i = _run(queries, db, norms, 512, 150, DistanceMetric.L2, block_rows=128)
    _, oi = numpy_oracle(queries, db, 150, DistanceMetric.L2)
    assert np.array_equal(np.asarray(i), oi)


def test_scan_duplicates_tie_lowest_index_and_tombstones(rng):
    """Exact duplicates tie: the lowest row index wins, across blocks, and
    tombstoned rows never surface."""
    n, d, k = 512, 16, 12
    base = rng.standard_normal((64, d)).astype(np.float32)
    db = base[rng.integers(0, 64, n)]  # many exact duplicates
    q = rng.standard_normal((4, d)).astype(np.float32)
    norms = (db.astype(np.float64) ** 2).sum(1).astype(np.float32)
    mask = np.ones(n, np.float32)
    mask[rng.choice(n, 40, replace=False)] = 0.0
    _, i = exact_topk(q, db, norms, n, k, DistanceMetric.L2,
                      valid_mask=mask, block_rows=96)
    masked = db.copy().astype(np.float64)
    masked[mask == 0] = np.nan
    _, oi = numpy_oracle(q, masked, k, DistanceMetric.L2)
    np.testing.assert_array_equal(np.asarray(i), oi)


def test_scan_all_equal_scores_keep_row_order(rng):
    """Every row scores the same: the result is rows 0..k-1 in order,
    whatever the block size (the carried list precedes each block)."""
    db = np.ones((300, 8), np.float32)
    norms = np.full(300, 8.0, np.float32)
    q = np.ones((2, 8), np.float32)
    for br in (300, 64, 7):
        _, i = exact_topk(q, db, norms, 300, 20, DistanceMetric.L2,
                          block_rows=br)
        assert (np.asarray(i) == np.arange(20)).all(), br


def test_scan_int8_k100(rng):
    n, d, k = 768, 32, 100
    db = rng.integers(-128, 127, (n, d)).astype(np.int8)
    q = rng.integers(-128, 127, (5, d)).astype(np.int8)
    norms = (db.astype(np.float64) ** 2).sum(1).astype(np.float32)
    _, i = exact_topk(q, db, norms, n, k, DistanceMetric.L2, block_rows=256)
    _, oi = numpy_oracle(
        q.astype(np.float32), db.astype(np.float64), k, DistanceMetric.L2
    )
    np.testing.assert_array_equal(np.asarray(i), oi)


def test_scan_unfilled_slots_are_sentinels(rng):
    """Fewer live rows than k: the tail is −inf scores and −1 ids."""
    queries, db, norms = _case(rng, n=64, d=16, q=3)
    mask = np.zeros(64, np.float32)
    mask[[5, 40, 41]] = 1.0
    s, i = _run(queries, db, norms, 50, 6, DistanceMetric.L2,
                valid_mask=mask, block_rows=16)
    s, i = np.asarray(s), np.asarray(i)
    assert (np.sort(i[:, :3], axis=1) == [5, 40, 41]).all()
    assert (i[:, 3:] == -1).all() and np.isneginf(s[:, 3:]).all()


def _dtype_case(rng, dtype, n=400, d=32, q=4):
    """(queries, corpus, norms, oracle queries, oracle corpus, scale)."""
    if dtype == "int8":
        db = rng.integers(-127, 128, (n, d)).astype(np.int8)
        qq = rng.integers(-127, 128, (q, d)).astype(np.int8)
        f = db.astype(np.float32)
        norms = (f.astype(np.float64) ** 2).sum(1).astype(np.float32)
        return qq, db, norms, qq.astype(np.float32), f
    queries, db, norms = _case(rng, n, d, q)
    if dtype == "bf16":
        db = db.astype(ml_dtypes.bfloat16)
        norms = (db.astype(np.float64) ** 2).sum(1).astype(np.float32)
        return queries.astype(ml_dtypes.bfloat16), db, norms, queries, \
            db.astype(np.float32)
    return queries, db, norms, queries, db


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("precision", PRECISIONS)
def test_precision_metric_dtype_matrix(rng, precision, metric, dtype):
    """Every (precision, metric, dtype) combination runs the same scan:
    integer corpora and f32 at 'highest' / 'high' rank exactly like the
    oracle on well-separated data; bf16 operands ('default', or bf16
    storage) keep strong overlap."""
    q, db, norms, oq, odb = _dtype_case(rng, dtype)
    if metric == DistanceMetric.COSINE and dtype != "int8":
        q = _unit(oq).astype(q.dtype)
        oq = _unit(oq)
    _, i = exact_topk(q, db, norms, db.shape[0], 10, metric,
                      precision=precision, block_rows=128)
    _, oi = numpy_oracle(oq, odb, 10, metric)
    exact = dtype == "int8" or (dtype == "f32" and precision != "default")
    if exact:
        assert np.array_equal(np.asarray(i), oi)
    else:
        assert _overlap(i, oi) >= 0.8


@pytest.mark.parametrize("precision", PRECISIONS)
def test_every_dot_names_its_precision(rng, precision):
    """No dot on the exact path is left to the compiler's default
    precision (which may be TF32 for f32 operands on a GPU)."""
    q = np.ones((8, 16), np.float32)
    x = np.ones((32, 16), np.float32)
    jaxpr = jax.make_jaxpr(
        lambda a, b: block_dots(a, b, precision)
    )(q, x)
    dots = [e for e in jaxpr.jaxpr.eqns if e.primitive.name == "dot_general"]
    assert dots
    for e in dots:
        assert e.params["precision"] is not None, precision
    if precision == "highest":
        assert all(
            jax.lax.Precision.HIGHEST in tuple(e.params["precision"])
            for e in dots
        )
    if precision == "high":
        assert len(dots) == 3  # the explicit three-term bf16 split
        # the hi parts are reduce_precision roundings, which the compiler
        # may not drop as excess precision (a convert pair it may)
        rp = [e for e in jaxpr.jaxpr.eqns
              if e.primitive.name == "reduce_precision"]
        assert len(rp) == 2


def test_high_split_error_bound(rng):
    """'high' = q_hi·x_hi + q_hi·x_lo + q_lo·x_hi: within 2⁻¹⁴·‖q‖‖x‖ of
    the exact dot (the certificate's C(D) head term)."""
    q = rng.standard_normal((8, 96)).astype(np.float32)
    x = rng.standard_normal((64, 96)).astype(np.float32)
    got = np.asarray(block_dots(q, x, "high"), np.float64)
    ref = q.astype(np.float64) @ x.astype(np.float64).T
    bound = 2.0 ** -14 * np.outer(
        np.linalg.norm(q, axis=1), np.linalg.norm(x, axis=1)
    )
    assert (np.abs(got - ref) <= bound).all()
    # and it is far tighter than one bf16 pass
    one = np.asarray(block_dots(q, x, "default"), np.float64)
    assert np.abs(got - ref).max() < np.abs(one - ref).max() / 16


def test_unknown_precision_rejected(rng):
    q, db, norms = _case(rng, n=32, d=8, q=1)
    with pytest.raises(ValueError, match="precision"):
        exact_topk(q, db, norms, 32, 3, DistanceMetric.L2, precision="tf32")


def test_block_rows_must_be_positive(rng):
    q, db, norms = _case(rng, n=32, d=8, q=1)
    with pytest.raises(ValueError, match="block_rows"):
        exact_topk(q, db, norms, 32, 3, DistanceMetric.L2, block_rows=0)


@pytest.mark.parametrize(
    "metric", [DistanceMetric.L2, DistanceMetric.INNER_PRODUCT]
)
def test_bias_row_offset_uint8_algebra(rng, metric):
    """uint8 codes c re-centred to c' = c − 128 (int8) with per-row sums
    Σc' as ``bias_row``: ``scale·(q'·c') + bias_scale·Σc'`` ranks exactly
    like q·c on the uint8 values for integer queries q = q' + 128."""
    n, d = 300, 24
    u8 = rng.integers(0, 256, (n, d)).astype(np.float32)
    c = (u8 - 128).astype(np.int8)
    rowsums = c.astype(np.int32).sum(1).astype(np.float32)
    norms = (u8.astype(np.float64) ** 2).sum(1).astype(np.float32)
    qf = rng.integers(0, 256, (5, d)).astype(np.float32)
    q = (qf - 128).astype(np.int8)
    _, i = exact_topk(q, c, norms, n, 9, metric, scale=1.0,
                      bias_row=rowsums, bias_scale=128.0, block_rows=64)
    _, oi = numpy_oracle(qf, u8, 9, metric)
    assert np.array_equal(np.asarray(i), oi)


def test_dequant_affine_cosine(rng):
    """``dequant=(offset, s)`` scores x = (c' + offset)·s per block: cosine
    over affine uint8 codes equals the oracle on the dequantized rows."""
    n, d, zp, sc = 256, 16, 7.0, 0.25
    u8 = rng.integers(0, 256, (n, d)).astype(np.float32)
    deq = (u8 - zp) * sc
    norms = (deq.astype(np.float64) ** 2).sum(1).astype(np.float32)
    c = (u8 - 128).astype(np.int8)
    q = _unit(rng.standard_normal((4, d)).astype(np.float32))
    _, i = exact_topk(q, c, norms, n, 8, DistanceMetric.COSINE,
                      dequant=(128.0 - zp, sc), block_rows=64)
    _, oi = numpy_oracle(q, deq, 8, DistanceMetric.COSINE)
    assert np.array_equal(np.asarray(i), oi)


def test_scale_is_traced_not_static(rng):
    """Per-batch int8 query scales share one compiled program."""
    d = 16
    db = rng.integers(-127, 128, (64, d)).astype(np.int8)
    norms = np.zeros(64, np.float32)
    q = rng.integers(-127, 128, (2, d)).astype(np.int8)
    exact_topk(q, db, norms, 64, 3, DistanceMetric.INNER_PRODUCT, scale=0.5)
    before = exact_topk._cache_size()
    for s in (0.25, 0.125, 3.0):
        exact_topk(q, db, norms, 64, 3, DistanceMetric.INNER_PRODUCT,
                   scale=s)
    assert exact_topk._cache_size() == before
