"""IVF-PQ: coarse quantizer + residual PQ codes + optional exact re-rank.
No counterpart exists in the reference (it declares IVF and PQ schemas
separately, implements neither); the behavioral spec is the classic
IVF-PQ algebra: codes encode ``x − centroid``, search scores
``2(q·c + q·r̂) − ‖x̂‖²`` for L2.
"""

import numpy as np
import pytest

from metrovector_tpu import Builder, DistanceMetric, Reader
from metrovector_tpu.index import IVFPQIndex, PQIndex, train_ivfpq
from metrovector_tpu.index.pq import reconstruct_pq
from metrovector_tpu.ops import numpy_oracle

METRICS = [DistanceMetric.L2, DistanceMetric.COSINE, DistanceMetric.INNER_PRODUCT]


def _clustered(rng, n_clusters=8, per=100, d=16, spread=0.05):
    centers = rng.standard_normal((n_clusters, d)).astype(np.float32) * 3
    data = np.concatenate(
        [c + spread * rng.standard_normal((per, d)).astype(np.float32) for c in centers]
    )
    return data


def test_train_ivfpq_shapes(rng):
    data = _clustered(rng)
    cents, assign, books, codes = train_ivfpq(data, 8, m=4, ksub=16, iters=5)
    assert cents.shape == (8, 16)
    assert assign.shape == (800,)
    assert books.shape == (4, 16, 4)
    assert codes.shape == (800, 4)
    # residual encoding: full reconstruction must be closer to the data
    # than the coarse centroid alone
    recon = reconstruct_pq(codes, books) + cents[assign]
    coarse_err = ((data - cents[assign]) ** 2).sum()
    full_err = ((data - recon) ** 2).sum()
    assert full_err < 0.6 * coarse_err


@pytest.mark.parametrize("metric", METRICS)
def test_full_probe_adc_matches_reconstructed_bruteforce(rng, metric):
    """nprobe == C with no re-rank must rank exactly like brute force over
    the reconstructions x̂ = c + r̂ (the ADC scoring identity)."""
    data = _clustered(rng, n_clusters=4, per=50)
    idx = IVFPQIndex.build(data, metric, num_clusters=4, m=4, ksub=16, iters=6)
    # rebuild x̂ from the bucket layout
    ids = np.asarray(idx.bucket_ids).reshape(-1)
    codes = np.asarray(idx.buckets).reshape(-1, 4)
    live = ids >= 0
    recon = np.zeros_like(data)
    cent_of = np.repeat(idx.cells, idx.bucket_rows)
    recon[ids[live]] = (
        reconstruct_pq(codes[live].astype(np.uint8), idx.codebooks)
        + idx.centroids[cent_of[live]]
    )
    q = rng.standard_normal((6, 16)).astype(np.float32)
    res = idx.search(q, k=10, nprobe=4)
    _, oi = numpy_oracle(q, recon, 10, metric)
    assert np.array_equal(res.indices, oi)


def test_rerank_recovers_exact_on_clustered(rng):
    data = _clustered(rng, n_clusters=16, per=100, d=32)
    idx = IVFPQIndex.build(
        data, DistanceMetric.L2, num_clusters=16, m=8, ksub=16, iters=8
    )
    q = data[rng.choice(len(data), 20)] + 0.01 * rng.standard_normal(
        (20, 32)
    ).astype(np.float32)
    res = idx.search(q, k=10, nprobe=4, rerank=100)
    _, oi = numpy_oracle(q, data, 10, DistanceMetric.L2)
    hits = sum(len(set(res.indices[i]) & set(oi[i])) for i in range(20))
    assert hits / 200 >= 0.95


def test_nprobe_monotone_recall(rng):
    data = _clustered(rng, n_clusters=8, per=80)
    idx = IVFPQIndex.build(data, DistanceMetric.L2, num_clusters=8, m=4, ksub=16)
    q = rng.standard_normal((15, 16)).astype(np.float32)
    _, oi = numpy_oracle(q, data, 10, DistanceMetric.L2)

    def recall(nprobe):
        res = idx.search(q, k=10, nprobe=nprobe, rerank=60)
        return sum(len(set(res.indices[i]) & set(oi[i])) for i in range(15))

    assert recall(1) <= recall(4) <= recall(8)


def test_probe_widening_crosses_cells(rng):
    """A query equidistant from two tight cells must pull candidates from
    one cell at nprobe=1 and both at nprobe=2 (also regression-covers
    k-means++ seeding on degenerate constant subspaces, which used to
    crash with zero-sum D² probabilities)."""
    d = 16
    a = np.zeros((40, d), np.float32)
    a[:, 0] = 5 + 0.1 * rng.standard_normal(40)
    b = np.zeros((40, d), np.float32)
    b[:, 0] = -5 + 0.1 * rng.standard_normal(40)
    data = np.concatenate([a, b])
    idx = IVFPQIndex.build(
        data, DistanceMetric.L2, num_clusters=2, m=4, ksub=16, iters=10
    )
    q = np.zeros((1, d), np.float32)
    side1 = set(np.asarray(idx.search(q, k=20, nprobe=1).indices[0]) // 40)
    side2 = set(np.asarray(idx.search(q, k=20, nprobe=2).indices[0]) // 40)
    assert side1 in ({0}, {1})
    assert side2 == {0, 1}


def test_skewed_fills_split_into_capped_buckets(rng):
    """One heavy cell must split into several fixed-size buckets (bounded
    device-memory/probe cost) while full-probe search stays exhaustive."""
    from metrovector_tpu.index.ivf import bucket_layout

    # 90% of rows in one cluster
    assign = np.zeros(1000, np.int32)
    assign[900:] = np.arange(100) % 9 + 1
    cells, row_lists, bucket_rows = bucket_layout(
        assign, np.ones(1000, bool), 10
    )
    assert bucket_rows <= 2 * -(-1000 // 10) + 8  # capped near 2x mean
    assert (cells == 0).sum() > 1  # the heavy cell split
    got = np.concatenate([r for r in row_lists if len(r)])
    assert sorted(got) == list(range(1000))  # no row lost or duplicated

    # end-to-end: 4 well-separated blobs with skewed sizes (850/50/50/50) —
    # k-means recovers the blobs, so the heavy one must split.
    blob_centers = rng.standard_normal((4, 16)).astype(np.float32) * 8
    sizes = [850, 50, 50, 50]
    data = np.concatenate(
        [
            blob_centers[i]
            + 0.1 * rng.standard_normal((sz, 16)).astype(np.float32)
            for i, sz in enumerate(sizes)
        ]
    )
    idx = IVFPQIndex.build(
        data, DistanceMetric.L2, num_clusters=4, m=4, ksub=16, iters=6
    )
    assert idx.num_buckets > idx.num_clusters
    q = rng.standard_normal((5, 16)).astype(np.float32)
    res = idx.search(q, k=10, nprobe=idx.num_buckets, rerank=1000)
    _, oi = numpy_oracle(q, data, 10, DistanceMetric.L2)
    assert np.array_equal(res.indices, oi)


def test_kmeans_on_constant_data(rng):
    """All-identical rows: seeding must not crash, every row lands in one
    cluster at the data point."""
    from metrovector_tpu.index import train_kmeans

    data = np.ones((50, 8), np.float32) * 3.0
    cents, assign = train_kmeans(data, 4, iters=3)
    np.testing.assert_allclose(cents[assign], data, atol=1e-6)


def test_ivfpq_persistence_roundtrip(tmp_path, rng):
    data = _clustered(rng, n_clusters=4, per=60)
    cents, assign, books, codes = train_ivfpq(data, 4, m=4, ksub=16, iters=5)

    b = Builder()
    b.add_vector_space("s", dim=16)
    b.add_vectors("s", data)
    b.set_ivf_index("s", cents, assign, nprobe=2)
    b.set_pq_index("s", books, codes, residual=True)
    path = tmp_path / "ivfpq.mvt"
    b.build().save(path)

    sp = Reader.open(path).vector_space("s")
    assert sp.info.pq.residual is True
    # stored recon norms are FULL reconstruction norms (centroid + residual)
    _, _, rn = sp.pq_arrays()
    recon = reconstruct_pq(codes, books) + cents[assign]
    np.testing.assert_allclose(
        rn, (recon.astype(np.float64) ** 2).sum(1).astype(np.float32), rtol=1e-6
    )

    idx = IVFPQIndex.from_space(sp)
    # reused, not retrained
    np.testing.assert_array_equal(idx.centroids, cents)
    np.testing.assert_array_equal(idx.codebooks, books)
    q = rng.standard_normal((5, 16)).astype(np.float32)
    res = idx.search(q, k=5, nprobe=4, rerank=240)
    _, oi = numpy_oracle(q, data, 5, DistanceMetric.L2)
    assert np.array_equal(res.indices, oi)

    # a plain PQIndex must NOT consume the residual sidecar
    pq = PQIndex.from_space(sp, m=4, ksub=16, iters=3)
    r2 = pq.search(q, k=5, rerank=240)
    assert np.array_equal(r2.indices, oi)


def test_residual_pq_requires_ivf_first(rng):
    data = _clustered(rng, n_clusters=2, per=20)
    cents, assign, books, codes = train_ivfpq(data, 2, m=4, ksub=8, iters=3)
    b = Builder()
    b.add_vector_space("s", dim=16)
    b.add_vectors("s", data)
    from metrovector_tpu.errors import BuildError

    with pytest.raises(BuildError, match="set_ivf_index"):
        b.set_pq_index("s", books, codes, residual=True)


def test_ivfpq_excludes_tombstones(tmp_path, rng):
    data = _clustered(rng, n_clusters=2, per=30)
    b = Builder()
    b.add_vector_space("s", dim=16)
    b.add_vectors("s", data)
    b.delete_vector("s", 5)
    path = tmp_path / "t.mvt"
    b.build().save(path)
    sp = Reader.open(path).vector_space("s")
    idx = IVFPQIndex.from_space(sp, num_clusters=2, m=4, ksub=8, iters=3)
    res = idx.search(data[5], k=5, nprobe=2, rerank=59)
    assert 5 not in res.indices


# ------------------------------------------------------------------------
# Gather-free masked-scan probing (round 2): dense ADC + per-bucket bias
# must reproduce the traversal probe exactly (this path replaces the
# probe's gathers for batch serving).


@pytest.mark.parametrize(
    "metric",
    [DistanceMetric.L2, DistanceMetric.INNER_PRODUCT, DistanceMetric.COSINE],
)
def test_masked_scan_matches_probe(rng, metric):
    n, d = 2500, 32
    centers = rng.standard_normal((30, d)).astype(np.float32) * 4
    db = centers[rng.integers(0, 30, n)] + rng.standard_normal(
        (n, d)
    ).astype(np.float32) * 0.3
    idx = IVFPQIndex.build(
        db, metric, num_clusters=12, m=4, ksub=32, iters=4, keep_vectors=True
    )
    q = db[rng.integers(0, n, 33)] + 0.05 * rng.standard_normal(
        (33, d)
    ).astype(np.float32)
    rp = idx.search(q, k=9, nprobe=4, mode="probe")
    rs = idx.search(q, k=9, nprobe=4, mode="scan",
                    exact_lut=True)
    np.testing.assert_array_equal(rp.indices, rs.indices)
    np.testing.assert_allclose(rp.scores, rs.scores, rtol=1e-4, atol=1e-4)
    # rerank composes identically on both paths
    rpr = idx.search(q, k=5, nprobe=4, rerank=40, mode="probe")
    rsr = idx.search(q, k=5, nprobe=4, rerank=40, mode="scan",
                     exact_lut=True)
    np.testing.assert_array_equal(rpr.indices, rsr.indices)


def test_masked_scan_respects_nprobe_semantics(rng):
    """A row outside every probed bucket must never surface in scan mode."""
    n, d = 1200, 16
    centers = rng.standard_normal((20, d)).astype(np.float32) * 6
    db = centers[rng.integers(0, 20, n)] + rng.standard_normal(
        (n, d)
    ).astype(np.float32) * 0.2
    idx = IVFPQIndex.build(
        db, DistanceMetric.L2, num_clusters=8, m=4, ksub=16, iters=4
    )
    q = db[:7]
    res = idx.search(q, k=10, nprobe=2, mode="scan",
                     exact_lut=True)
    # recompute which buckets each query probes, on the host
    pc = np.asarray(idx.probe_centroids)
    cs = 2 * q @ pc.T - (pc**2).sum(1)[None]
    ids = np.asarray(idx.bucket_ids)
    for r in range(len(q)):
        probed = np.argsort(-cs[r], kind="stable")[:2]
        allowed = set(int(x) for b in probed for x in ids[b] if x >= 0)
        got = set(int(x) for x in res.indices[r] if x >= 0)
        assert got <= allowed, f"query {r} surfaced unprobed rows"


def test_auto_mode_routes_by_batch(rng):
    n, d = 800, 16
    db = rng.standard_normal((n, d)).astype(np.float32)
    idx = IVFPQIndex.build(
        db, DistanceMetric.L2, num_clusters=8, m=4, ksub=16, iters=3
    )
    small = idx.search(db[:4], k=5, nprobe=8, mode="auto")
    big = idx.search(db[:40], k=5, nprobe=8, mode="auto",
                     exact_lut=True)
    # nprobe == all buckets → both modes see the whole corpus: results of
    # the large batch's first rows must match the small batch's rows
    np.testing.assert_array_equal(small.indices, big.indices[:4])


def test_ivfpq_packed4_both_modes_and_lifecycle(tmp_path, rng):
    """4-bit nibble-packed codes on IVF-PQ: both serving modes (bucket
    traversal and gather-free masked scan) rank like the reconstruction
    algebra; persistence round-trips the packed width; online mutation
    keeps packing. Half the code bytes of the 8-bit layout."""
    data = _clustered(rng, n_clusters=6, per=80)
    cents, assign, books, codes = train_ivfpq(data, 6, m=4, ksub=16, iters=5)

    packed = IVFPQIndex.build(
        data, DistanceMetric.L2, 6, centroids=cents, assignments=assign,
        codebooks=books, codes=codes, pack4=True,
    )
    plain = IVFPQIndex.build(
        data, DistanceMetric.L2, 6, centroids=cents, assignments=assign,
        codebooks=books, codes=codes,
    )
    assert packed.packed4 and not plain.packed4
    assert packed.codes_row.shape[1] == 2  # ceil(4/2)
    assert packed.buckets.shape[2] == 2 and plain.buckets.shape[2] == 4

    q = rng.standard_normal((40, 16)).astype(np.float32)
    _, oi = numpy_oracle(q, data, 5, DistanceMetric.L2)
    for mode in ("probe", "scan"):
        # exact after re-rank: candidates from 4-bit ADC, scores from the
        # original vectors
        res = packed.search(q, k=5, nprobe=6, rerank=240, mode=mode)
        assert np.array_equal(res.indices, oi), mode
        # without re-rank both widths score the same reconstructions —
        # rankings agree up to ADC formulation rounding (gate on overlap)
        rp = packed.search(q, k=5, nprobe=6, mode=mode)
        ru = plain.search(q, k=5, nprobe=6, mode=mode)
        overlap = np.mean([
            len(set(rp.indices[i]) & set(ru.indices[i])) / 5
            for i in range(q.shape[0])
        ])
        assert overlap >= 0.95, (mode, overlap)

    # persistence: packed sidecar reattaches packed
    b = Builder()
    b.add_vector_space("s", dim=16)
    b.add_vectors("s", data)
    b.set_ivf_index("s", cents, assign, nprobe=2)
    from metrovector_tpu.index.pq import pack_codes4

    b.set_pq_index("s", books, pack_codes4(codes), residual=True,
                   packed4=True)
    path = tmp_path / "p4.mvt"
    b.build().save(path)
    sp = Reader.open(path).vector_space("s")
    idx = IVFPQIndex.from_space(sp)
    assert idx.packed4 and idx.codes_row.shape[1] == 2
    res = idx.search(q, k=5, nprobe=6, rerank=240)
    assert np.array_equal(res.indices, oi)

    # online mutation keeps the packed layout and stays searchable
    new = data[:7] + 0.01
    idx.add_rows(new)
    assert idx.codes_row.shape[1] == 2
    r3 = idx.search(new[:2], k=1, nprobe=6, rerank=60)
    assert (r3.distances[:, 0] < 0.1).all()
    idx.delete_rows([int(r3.indices[0, 0])])
    r4 = idx.search(new[:1], k=1, nprobe=6, rerank=60)
    assert r4.indices[0, 0] != r3.indices[0, 0]


def test_recommended_rerank_guidance(rng):
    """pack4 recall guidance (1M×128 clustered corpus, nprobe 16) is
    surfaced in code: recall-1.0 target maps to 40·k on both code widths,
    low targets fall back to scan-only recall where 8-bit suffices."""
    data = rng.standard_normal((400, 16)).astype(np.float32)
    i8 = IVFPQIndex.build(
        data, DistanceMetric.L2, num_clusters=8, m=4, ksub=16, pack4=False
    )
    i4 = IVFPQIndex.build(
        data, DistanceMetric.L2, num_clusters=8, m=4, ksub=16, pack4=True
    )

    assert i4.recommended_rerank(k=10) == 400
    assert i8.recommended_rerank(k=10, recall_target=1.0) == 400
    # 8-bit raw scan (~0.74 measured) meets a 0.7 target; 4-bit does not
    assert i8.recommended_rerank(k=10, recall_target=0.7) == 0
    assert i4.recommended_rerank(k=10, recall_target=0.7) > 0
    # monotone in target, scales with k
    assert (
        i4.recommended_rerank(k=10, recall_target=0.8)
        <= i4.recommended_rerank(k=10, recall_target=0.95)
        <= i4.recommended_rerank(k=10, recall_target=1.0)
    )
    assert i4.recommended_rerank(k=100) == 10 * i4.recommended_rerank(k=10)
    with pytest.raises(ValueError):
        i4.recommended_rerank(k=10, recall_target=0.0)

    # the recommended depth actually reaches recall 1.0 on this corpus
    q = rng.standard_normal((8, 16)).astype(np.float32)
    _, oi = numpy_oracle(q, data, 10, DistanceMetric.L2)
    res = i4.search(q, k=10, nprobe=8, rerank=i4.recommended_rerank(k=10))
    assert np.array_equal(res.indices, oi)
