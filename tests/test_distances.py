"""Numerical parity of the exact top-k scan against the NumPy oracle
(the reference's scalar loops are the behavioral spec — SURVEY.md §4)."""

import numpy as np
import pytest

from metrovector_tpu import DistanceMetric
from metrovector_tpu.ops import exact_topk, numpy_oracle, scores_to_distances

METRICS = [DistanceMetric.L2, DistanceMetric.COSINE, DistanceMetric.INNER_PRODUCT]


def _case(rng, n=500, d=32, q=7):
    db = rng.standard_normal((n, d)).astype(np.float32)
    queries = rng.standard_normal((q, d)).astype(np.float32)
    norms = (db.astype(np.float64) ** 2).sum(1).astype(np.float32)
    return queries, db, norms


@pytest.mark.parametrize("metric", METRICS)
def test_xla_topk_matches_oracle(rng, metric):
    queries, db, norms = _case(rng)
    k = 10
    s, i = exact_topk(queries, db, norms, db.shape[0], k, metric)
    _, oi = numpy_oracle(queries, db, k, metric)
    assert np.array_equal(np.asarray(i), oi)


@pytest.mark.parametrize("metric", METRICS)
def test_xla_topk_blocked_scan(rng, metric):
    """Block-scanned path (N > block_rows) must agree with one-shot."""
    queries, db, norms = _case(rng, n=1000)
    k = 5
    s1, i1 = exact_topk(queries, db, norms, db.shape[0], k, metric)
    s2, i2 = exact_topk(
        queries, db, norms, db.shape[0], k, metric, block_rows=128
    )
    assert np.array_equal(np.asarray(i1), np.asarray(i2))
    np.testing.assert_allclose(np.asarray(s1), np.asarray(s2), rtol=1e-5)


def test_padding_rows_never_surface(rng):
    queries, db, norms = _case(rng, n=64)
    # Physical block has 100 rows; only 64 are valid. Pad rows carry huge
    # norms/garbage to prove masking, not zero-padding, protects results.
    db_pad = np.concatenate([db, np.full((36, db.shape[1]), 100.0, np.float32)])
    norms_pad = np.concatenate([norms, np.zeros(36, np.float32)])
    for metric in METRICS:
        _, i = exact_topk(queries, db_pad, norms_pad, 64, 8, metric)
        assert np.asarray(i).max() < 64


def test_tombstone_masking(rng):
    queries, db, norms = _case(rng, n=200, q=3)
    _, base = exact_topk(queries, db, norms, 200, 1, DistanceMetric.L2)
    # Tombstone every query's nearest neighbor; it must vanish from results.
    mask = np.ones(200, np.float32)
    mask[np.asarray(base).ravel()] = 0.0
    _, i2 = exact_topk(
        queries, db, norms, 200, 5, DistanceMetric.L2,
        valid_mask=np.asarray(mask),
    )
    assert not np.intersect1d(np.asarray(i2), np.asarray(base)).size
    _, oi = numpy_oracle(queries, db, 5, DistanceMetric.L2, valid_mask=mask)
    assert np.array_equal(np.asarray(i2), oi)


def test_l2_score_to_distance_roundtrip(rng):
    queries, db, norms = _case(rng, n=100, q=4)
    s, i = exact_topk(queries, db, norms, 100, 3, DistanceMetric.L2)
    qn = (queries.astype(np.float64) ** 2).sum(1).astype(np.float32)
    dist = np.asarray(scores_to_distances(s, DistanceMetric.L2, qn))
    true = np.linalg.norm(
        queries[:, None, :] - db[np.asarray(i)], axis=-1
    )
    np.testing.assert_allclose(dist, true, rtol=1e-4, atol=1e-4)
    # distances ascend as scores descend
    assert (np.diff(dist, axis=1) >= -1e-5).all()


def test_k_larger_than_handful(rng):
    queries, db, norms = _case(rng, n=300, q=2)
    s, i = exact_topk(queries, db, norms, 300, 100, DistanceMetric.COSINE)
    _, oi = numpy_oracle(queries, db, 100, DistanceMetric.COSINE)
    assert np.array_equal(np.asarray(i), oi)
