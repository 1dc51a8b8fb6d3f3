"""Verified-'high' precision: recall 1.000 at 'high' scan speed.

``precision="high_verified"`` runs the full-corpus scan with the three
bf16 dots of the 'high' path (whose failure mode is a sub-ulp tie flip at
the top-k boundary), over-fetching ``k + verify_margin`` candidates, then exactly
re-scores just those candidates at f32 HIGHEST on-device
(:func:`~metrovector_tpu.ops.distances.rescore_topk`). The result must
match the f64 oracle bit-for-rank, including lowest-index tie-breaks.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from metrovector_tpu.engine import SearchEngine
from metrovector_tpu.format.builder import Builder
from metrovector_tpu.format.constants import DistanceMetric
from metrovector_tpu.ops.distances import numpy_oracle, rescore_topk


def _engine(tmp_path, data, metric=DistanceMetric.L2, **kw):
    b = Builder()
    b.add_vector_space("v", dim=data.shape[1], metric=metric)
    b.add_vectors("v", data)
    path = tmp_path / "v.mvt"
    b.build().save(path)
    return SearchEngine.open(
        path, precision="high_verified", **kw
    )


@pytest.mark.parametrize(
    "metric",
    [DistanceMetric.L2, DistanceMetric.COSINE, DistanceMetric.INNER_PRODUCT],
)
def test_verified_high_matches_oracle(tmp_path, rng, metric):
    data = rng.standard_normal((500, 64)).astype(np.float32)
    eng = _engine(tmp_path, data, metric)
    q = rng.standard_normal((7, 64)).astype(np.float32)
    res = eng.search(q, k=10)
    _, oi = numpy_oracle(q, data, 10, metric)
    np.testing.assert_array_equal(res.indices, oi)
    # well-separated data: the certificate holds, no HIGHEST rerun
    assert eng.verify_stats == {"certified": 7, "fallbacks": 0}


def test_verified_high_matches_highest_on_near_ties(tmp_path, rng):
    """The feature's contract: ``high_verified`` == ``highest``
    bit-for-rank, on data dense with near-ties (cluster far from the
    origin, score gaps a handful of f32 ulps — the regime where the raw
    'high' scan is known to swap boundary ranks)."""
    base = np.full(32, 100.0, np.float32)
    data = (base + 0.1 * rng.standard_normal((300, 32))).astype(np.float32)
    q = (base + 0.1 * rng.standard_normal((9, 32))).astype(np.float32)
    ver = _engine(tmp_path, data)
    res_v = ver.search(q, k=10)
    b = Builder()
    b.add_vector_space("hx", dim=32)
    b.add_vectors("hx", data)
    p = tmp_path / "hx.mvt"
    b.build().save(p)
    hi = SearchEngine.open(p, precision="highest")
    res_h = hi.search(q, k=10)
    np.testing.assert_array_equal(res_v.indices, res_h.indices)
    np.testing.assert_allclose(res_v.scores, res_h.scores, rtol=1e-6)
    # this corpus IS degenerate at the boundary (scores within the 'high'
    # error band) — the guarantee must come from the certified fallback
    assert ver.verify_stats["fallbacks"] > 0


def test_verified_high_exact_ties_break_low_index(tmp_path, rng):
    """Duplicate rows produce exactly tied scores; the verified repair
    must break them to the lowest row index like the oracle."""
    row = rng.standard_normal(32).astype(np.float32)
    data = rng.standard_normal((100, 32)).astype(np.float32) * 10
    for i in (3, 17, 42, 77):  # plant 4 identical rows
        data[i] = row
    eng = _engine(tmp_path, data)
    res = eng.search(row[None, :], k=4)
    np.testing.assert_array_equal(res.indices, [[3, 17, 42, 77]])


def test_verified_high_composes_with_filters(tmp_path, rng):
    data = rng.standard_normal((400, 48)).astype(np.float32)
    eng = _engine(tmp_path, data)
    q = rng.standard_normal((5, 48)).astype(np.float32)
    fm = (np.arange(400) % 3 == 0)
    res = eng.search(q, k=10, filter_mask=fm)
    _, oi = numpy_oracle(q, data, 10, DistanceMetric.L2, valid_mask=fm)
    np.testing.assert_array_equal(res.indices, oi)


def test_verified_high_sparse_filter_sentinels(tmp_path, rng):
    """Fewer passing rows than k: the tail must hold -1 sentinels, and
    the passing rows must rank exactly."""
    data = rng.standard_normal((200, 32)).astype(np.float32)
    eng = _engine(tmp_path, data)
    q = rng.standard_normal((3, 32)).astype(np.float32)
    fm = np.zeros(200, bool)
    fm[[5, 50, 150]] = True
    res = eng.search(q, k=8, filter_mask=fm)
    _, oi = numpy_oracle(q, data, 8, DistanceMetric.L2, valid_mask=fm)
    np.testing.assert_array_equal(res.indices[:, :3], oi[:, :3])
    assert (res.indices[:, 3:] == -1).all()


def test_verified_high_margin_clamps_to_corpus(tmp_path, rng):
    """k + margin past num_valid must clamp, not crash (tiny corpus)."""
    data = rng.standard_normal((12, 32)).astype(np.float32)
    eng = _engine(tmp_path, data, verify_margin=64)
    q = rng.standard_normal((2, 32)).astype(np.float32)
    res = eng.search(q, k=10)
    _, oi = numpy_oracle(q, data, 10, DistanceMetric.L2)
    np.testing.assert_array_equal(res.indices, oi)


def test_verify_margin_validation(tmp_path, rng):
    data = rng.standard_normal((20, 32)).astype(np.float32)
    with pytest.raises(ValueError, match="verify_margin"):
        _engine(tmp_path, data, verify_margin=0)
    b = Builder()
    b.add_vector_space("w", dim=32)
    b.add_vectors("w", data)
    p = tmp_path / "w.mvt"
    b.build().save(p)
    with pytest.raises(ValueError, match="unknown precision"):
        SearchEngine.open(p, precision="bogus")


def test_rescore_topk_unit(rng):
    """Direct unit test of the repair primitive: candidate sets with
    deliberately wrong input order, -1 slots, and exact ties."""
    db = rng.standard_normal((50, 16)).astype(np.float32)
    db[7] = db[31]  # exact tie pair
    norms = np.einsum("ij,ij->i", db, db).astype(np.float32)
    q = rng.standard_normal((2, 16)).astype(np.float32)
    # candidates in arbitrary (wrong) order, one invalid slot
    cand = np.array([[31, 4, 7, 2, -1], [10, 11, 12, 13, 14]], np.int32)
    s, i = rescore_topk(
        jnp.asarray(q), jnp.asarray(db), jnp.asarray(norms),
        jnp.asarray(cand), 3, DistanceMetric.L2,
    )
    s, i = np.asarray(s), np.asarray(i)
    for r in range(2):
        valid = cand[r][cand[r] >= 0]
        exact = {
            int(c): 2.0 * float(np.dot(q[r], db[c], )) - float(norms[c])
            for c in valid
        }
        # oracle order within the candidate set: score desc, index asc
        want = sorted(exact, key=lambda c: (-exact[c], c))[:3]
        assert list(i[r]) == want
    # tie pair: lower index (7) must precede 31 when both are candidates
    r0 = list(i[0])
    if 7 in r0 and 31 in r0:
        assert r0.index(7) < r0.index(31)


def test_rescore_topk_all_invalid():
    """All-sentinel candidate rows stay sentinels."""
    db = np.eye(4, 16, dtype=np.float32)
    norms = np.ones(4, np.float32)
    cand = np.full((1, 3), -1, np.int32)
    s, i = rescore_topk(
        jnp.asarray(np.zeros((1, 16), np.float32)), jnp.asarray(db),
        jnp.asarray(norms), jnp.asarray(cand), 2, DistanceMetric.L2,
    )
    assert (np.asarray(i) == -1).all()
    assert np.isneginf(np.asarray(s)).all()


@pytest.mark.parametrize(
    "metric",
    [DistanceMetric.L2, DistanceMetric.COSINE, DistanceMetric.INNER_PRODUCT],
)
def test_verified_high_serving_pad_rows_certify(tmp_path, rng, metric):
    """MicroBatcher pads off-rung batches by replicating a real query —
    a zero pad row is degenerate (all scores 0.0, certificate 0 > 0+eps
    fails) and would force a full-HIGHEST relaunch of every padded
    batch, silently negating high_verified's serving throughput."""
    from metrovector_tpu.serving import MicroBatcher

    data = rng.standard_normal((500, 64)).astype(np.float32)
    eng = _engine(tmp_path, data, metric)
    q = rng.standard_normal((3, 64)).astype(np.float32)  # pads 3 -> 4
    with MicroBatcher(eng, k=5, max_wait_ms=20.0) as mb:
        futs = [mb.submit(q[i]) for i in range(3)]
        got = [f.result(timeout=300) for f in futs]
    _, oi = numpy_oracle(q, data, 5, metric)
    for i in range(3):
        np.testing.assert_array_equal(got[i].indices[0], oi[i])
    assert eng.verify_stats["fallbacks"] == 0
    assert eng.verify_stats["certified"] >= 4  # incl. the pad row
