"""End-to-end slice tests: build file → open → device upload → search →
ranking parity with the NumPy port of the reference's brute force
(`examples/similarity_search.rs:140-176`). SURVEY.md §7 build-plan step 2."""

import numpy as np
import pytest


def test_filtered_search_via_metadata(tmp_path=None):
    """filter_mask restricts results exactly (composed with tombstones):
    the canonical vector-DB 'search within category' flow."""
    from metrovector_tpu import Builder, DistanceMetric, Reader, SearchEngine
    from metrovector_tpu.ops import numpy_oracle
    import tempfile, os

    rng = np.random.default_rng(8)
    data = rng.standard_normal((300, 16)).astype(np.float32)
    cats = [("red" if i % 3 == 0 else "blue") for i in range(300)]
    b = Builder()
    b.add_vector_space("v", dim=16)
    b.add_vectors("v", data)
    b.add_metadata_column("v", "cat", cats)
    b.delete_vector("v", 0)  # a red row, also tombstoned
    path = os.path.join(tempfile.mkdtemp(), "f.mvt")
    b.build().save(path)

    r = Reader.open(path)
    sp = r.vector_space("v")
    col = sp.metadata_column("cat")
    mask = np.asarray([c == "red" for c in col])
    eng = SearchEngine(sp)
    q = rng.standard_normal((5, 16)).astype(np.float32)
    res = eng.search(q, k=10, filter_mask=mask)
    # oracle over red rows minus the tombstone
    oracle_mask = mask.copy()
    oracle_mask[0] = False
    _, oi = numpy_oracle(q, data, 10, DistanceMetric.L2,
                         valid_mask=oracle_mask.astype(np.float32))
    assert np.array_equal(res.indices, oi)
    assert all(cats[i] == "red" for row in res.indices for i in row if i >= 0)
    assert 0 not in res.indices

    # filter with fewer matches than k: -1 sentinels fill the tail
    tiny = np.zeros(300, bool)
    tiny[[7, 8]] = True
    res2 = eng.search(q[:1], k=5, filter_mask=tiny)
    assert set(res2.indices[0][:2]) == {7, 8}
    assert (res2.indices[0][2:] == -1).all()

    # wrong-length mask raises
    import pytest as _pytest
    from metrovector_tpu.errors import DimensionMismatchError

    with _pytest.raises(DimensionMismatchError):
        eng.search(q[:1], k=3, filter_mask=np.ones(10, bool))


def test_prepared_filter_matches_raw_mask():
    """prepare_filter: one upload, many searches — results identical to
    passing the raw mask, composed with live tombstones, invalidated by
    corpus growth."""
    from metrovector_tpu import Builder, SearchEngine
    from metrovector_tpu.errors import DimensionMismatchError
    import tempfile, os

    rng = np.random.default_rng(21)
    data = rng.standard_normal((257, 16)).astype(np.float32)
    b = Builder()
    b.add_vector_space("v", dim=16)
    b.add_vectors("v", data)
    path = os.path.join(tempfile.mkdtemp(), "pf.mvt")
    b.build().save(path)

    for block_rows in (None, 64):  # one scan block, several blocks
        eng = SearchEngine.open(path, block_rows=block_rows)
        mask = rng.random(257) < 0.4
        pf = eng.prepare_filter(mask)
        q = rng.standard_normal((6, 16)).astype(np.float32)
        raw = eng.search(q, k=8, filter_mask=mask)
        prepped = eng.search(q, k=8, filter_mask=pf)
        np.testing.assert_array_equal(prepped.indices, raw.indices)
        np.testing.assert_array_equal(prepped.scores, raw.scores)

        # composes with a deletion made AFTER preparation
        victim = int(raw.indices[0, 0])
        eng.space.delete_rows([victim])
        res = eng.search(q, k=8, filter_mask=pf)
        assert victim not in res.indices

        # corpus growth invalidates the prepared mask (row count changed)
        eng.space.add_rows(rng.standard_normal((3, 16)).astype(np.float32))
        with pytest.raises(DimensionMismatchError):
            eng.search(q, k=8, filter_mask=pf)
        # wrong-shape prepare raises up front
        with pytest.raises(DimensionMismatchError):
            eng.prepare_filter(np.ones(10, bool))


def test_search_pipelined_matches_search(rng_engine_fixtureless=None):
    """Pipelined batches must return the same results, in order, as
    sequential search() calls."""
    from metrovector_tpu import Builder, DistanceMetric, SearchEngine
    import tempfile, os

    rng = np.random.default_rng(3)
    data = rng.standard_normal((600, 32)).astype(np.float32)
    b = Builder()
    b.add_vector_space("v", dim=32)
    b.add_vectors("v", data)
    path = os.path.join(tempfile.mkdtemp(), "p.mvt")
    b.build().save(path)
    eng = SearchEngine.open(path)
    batches = [rng.standard_normal((q, 32)).astype(np.float32) for q in (4, 7, 1)]
    piped = list(eng.search_pipelined(iter(batches), k=5))
    assert len(piped) == 3
    for q, res in zip(batches, piped):
        ref = eng.search(q, k=5)
        np.testing.assert_array_equal(res.indices, ref.indices)
        np.testing.assert_allclose(res.distances, ref.distances, rtol=1e-6)

from metrovector_tpu import Builder, DataType, DistanceMetric, Reader
from metrovector_tpu.engine import DeviceSpace, SearchEngine
from metrovector_tpu.errors import DimensionMismatchError
from metrovector_tpu.ops import numpy_oracle


def _build(tmp_path, rng, n=300, d=24, metric=DistanceMetric.L2,
           dtype=DataType.FLOAT32, name="db.mvt"):
    data = rng.standard_normal((n, d)).astype(np.float32)
    b = Builder()
    b.add_vector_space("v", dim=d, metric=metric, dtype=dtype)
    b.add_vectors("v", data)
    path = tmp_path / name
    b.build().save(path)
    return path, data


@pytest.mark.parametrize("block_rows", [None, 48])
@pytest.mark.parametrize(
    "metric",
    [DistanceMetric.L2, DistanceMetric.COSINE, DistanceMetric.INNER_PRODUCT],
)
def test_search_matches_reference_semantics(tmp_path, rng, block_rows,
                                            metric):
    path, data = _build(tmp_path, rng, metric=metric)
    eng = SearchEngine.open(path, block_rows=block_rows)
    queries = rng.standard_normal((5, 24)).astype(np.float32)
    res = eng.search(queries, k=10)
    _, oi = numpy_oracle(queries, data, 10, metric)
    assert np.array_equal(res.indices, oi)
    # distance convention: L2 ascending real distances, others descending
    if metric == DistanceMetric.L2:
        true = np.linalg.norm(queries[:, None] - data[oi], axis=-1)
        np.testing.assert_allclose(res.distances, true, rtol=1e-4, atol=1e-4)
        assert (np.diff(res.distances, axis=1) >= -1e-5).all()
    else:
        assert (np.diff(res.scores, axis=1) <= 1e-6).all()


def test_single_query_vector(tmp_path, rng):
    path, data = _build(tmp_path, rng)
    eng = SearchEngine.open(path)
    res = eng.search(data[42], k=1)
    assert res.indices.shape == (1, 1)
    assert res.indices[0, 0] == 42  # self-match
    assert res.distances[0, 0] == pytest.approx(0.0, abs=1e-3)


def test_top_helper(tmp_path, rng):
    path, data = _build(tmp_path, rng)
    eng = SearchEngine.open(path)
    pairs = eng.search(data[7], k=3).top(0)
    assert pairs[0][0] == 7
    assert len(pairs) == 3


def test_k_exceeds_corpus(tmp_path, rng):
    path, data = _build(tmp_path, rng, n=6)
    eng = SearchEngine.open(path)
    res = eng.search(rng.standard_normal((2, 24)).astype(np.float32), k=10)
    assert res.indices.shape == (2, 10)
    assert (res.indices[:, 6:] == -1).all()
    assert set(res.indices[0, :6]) == set(range(6))


def test_tombstones_excluded_from_search(tmp_path, rng):
    data = rng.standard_normal((50, 16)).astype(np.float32)
    b = Builder()
    b.add_vector_space("v", dim=16)
    b.add_vectors("v", data)
    b.delete_vector("v", 13)
    path = tmp_path / "t.mvt"
    b.build().save(path)
    eng = SearchEngine.open(path)
    res = eng.search(data[13], k=5)  # query the deleted vector itself
    assert 13 not in res.indices


def test_wrong_dim_query(tmp_path, rng):
    path, _ = _build(tmp_path, rng)
    eng = SearchEngine.open(path)
    with pytest.raises(DimensionMismatchError):
        eng.search(np.zeros((1, 7), np.float32), k=3)


@pytest.mark.parametrize("block_rows", [None, 64])
def test_int8_space_ranking_parity(tmp_path, rng, block_rows):
    """Quantized search must rank like dequantized-float search
    (SURVEY.md §7 'int8 ranking parity')."""
    x = rng.standard_normal((200, 32)).astype(np.float32)
    b = Builder()
    b.add_vector_space("q", dim=32, dtype=DataType.INT8,
                       metric=DistanceMetric.INNER_PRODUCT)
    b.add_vectors("q", x)
    path = tmp_path / "q.mvt"
    b.build().save(path)
    sp = Reader.open(path).vector_space("q")
    scale = sp.quantization.scale
    deq = sp.to_numpy().astype(np.float32) * scale

    eng = SearchEngine(sp, block_rows=block_rows)
    queries = rng.standard_normal((4, 32)).astype(np.float32)
    res = eng.search(queries, k=10)
    # Oracle on quantized values (incl. query quantization error ≤ 1 step)
    qscale = float(np.abs(queries).max()) / 127.0
    qq = np.clip(np.rint(queries / qscale), -128, 127).astype(np.float32) * qscale
    _, oi = numpy_oracle(qq, deq, 10, DistanceMetric.INNER_PRODUCT)
    assert np.array_equal(res.indices, oi)


def test_uint8_affine_space(tmp_path, rng):
    x = (rng.random((100, 16)) * 4 + 1).astype(np.float32)  # positive values
    b = Builder()
    b.add_vector_space("u", dim=16, dtype=DataType.UINT8,
                       metric=DistanceMetric.L2)
    b.add_vectors("u", x)
    path = tmp_path / "u.mvt"
    b.build().save(path)
    sp = Reader.open(path).vector_space("u")
    q = sp.quantization
    deq = (sp.to_numpy().astype(np.float32) - q.zero_point) * q.scale
    eng = SearchEngine(sp)
    queries = x[:3] + rng.standard_normal((3, 16)).astype(np.float32) * 0.01
    res = eng.search(queries, k=5)
    _, oi = numpy_oracle(queries, deq, 5, DistanceMetric.L2)
    assert np.array_equal(res.indices, oi)


def test_bf16_space_end_to_end(tmp_path, rng):
    data = rng.standard_normal((128, 64)).astype(np.float32)
    b = Builder()
    b.add_vector_space("b", dim=64, dtype=DataType.BFLOAT16)
    b.add_vectors("b", data)
    path = tmp_path / "b.mvt"
    b.build().save(path)
    eng = SearchEngine.open(path)
    res = eng.search(data[10], k=1)
    assert res.indices[0, 0] == 10


def test_device_space_nbytes(tmp_path, rng):
    path, data = _build(tmp_path, rng, n=64, d=32)
    sp = Reader.open(path).vector_space("v")
    ds = DeviceSpace.from_space(sp)
    # padded 64×128 f32 + 64 f32 norms
    assert ds.nbytes == 64 * 128 * 4 + 64 * 4
    assert ds.padded_rows == 64 and ds.padded_dim == 128


@pytest.mark.parametrize("precision", ["high", "default"])
def test_precision_modes(tmp_path, rng, precision):
    """'high' (three bf16 dots per block over the f32 corpus) must match
    the f32 oracle exactly on well-separated data; 'default' (bf16-only,
    half the device bytes) must keep very high overlap."""
    path, data = _build(tmp_path, rng, n=400, d=64)
    eng = SearchEngine.open(path, precision=precision)
    queries = rng.standard_normal((5, 64)).astype(np.float32)
    res = eng.search(queries, k=10)
    _, oi = numpy_oracle(queries, data, 10, DistanceMetric.L2)
    if precision == "high":
        assert np.array_equal(res.indices, oi)
        # corpus stays f32 (same bytes as HIGHEST; the split happens on
        # each block's dot operands)
        assert eng.space.data.dtype.name == "float32"
    else:
        overlap = np.mean(
            [len(set(res.indices[r]) & set(oi[r])) / 10 for r in range(5)]
        )
        assert overlap >= 0.9
        # half the memory of f32
        assert eng.space.data.dtype.itemsize == 2


def test_search_radius_matches_bruteforce():
    """Range queries return exactly the rows within the threshold
    (best-first), flag saturation, compose with filters, and work on
    the sparse engine too."""
    from metrovector_tpu import Builder, RadiusResult, SearchEngine, VectorType
    from metrovector_tpu.sparse import SparseSearchEngine
    import tempfile, os

    rng = np.random.default_rng(17)
    data = rng.standard_normal((400, 12)).astype(np.float32)
    b = Builder()
    b.add_vector_space("v", dim=12)
    b.add_vectors("v", data)
    b.add_vector_space("s", dim=12, vector_type=VectorType.SPARSE,
                       metric=DistanceMetric.INNER_PRODUCT)
    b.add_sparse_vectors(
        "s", [(np.nonzero(row > 0.8)[0], row[row > 0.8]) for row in data]
    )
    path = os.path.join(tempfile.mkdtemp(), "r.mvt")
    b.build().save(path)

    eng = SearchEngine.open(path, space_name="v")
    q = rng.standard_normal((4, 12)).astype(np.float32)
    r = 4.0
    res = eng.search_radius(q, radius=r, max_results=400)
    assert isinstance(res, RadiusResult) and not res.truncated.any()
    d = np.linalg.norm(q[:, None] - data[None], axis=-1)
    for i in range(4):
        expected = np.sort(np.nonzero(d[i] <= r)[0])
        assert np.array_equal(np.sort(res.indices[i]), expected)
        assert (np.diff(res.distances[i]) >= -1e-6).all()  # best-first
    # saturation flag: a cap smaller than the match count
    counts = (d[0] <= r).sum()
    small = eng.search_radius(q[:1], radius=r, max_results=max(1, counts // 2))
    assert small.truncated[0]
    # filter composition
    mask = np.arange(400) % 2 == 0
    resf = eng.search_radius(q[:1], radius=r, max_results=400,
                             filter_mask=mask)
    assert all(i % 2 == 0 for i in resf.indices[0])

    # sparse engine: similarity >= threshold semantics (IP descending)
    ssp = SearchEngine.open  # noqa: F841 (namespacing clarity)
    from metrovector_tpu import Reader

    sp = Reader.open(path).vector_space("s")
    seng = SparseSearchEngine(sp)
    dense = sp.to_numpy()
    sim = q @ dense.T
    thr = np.quantile(sim, 0.98)
    sres = seng.search_radius(q, radius=float(thr), max_results=400)
    for i in range(4):
        expected = np.sort(np.nonzero(sim[i] >= thr)[0])
        assert np.array_equal(np.sort(sres.indices[i]), expected)

    # full coverage: when the cap already spans the whole corpus and every
    # row meets the threshold, "more matches may exist" is impossible —
    # truncated must stay False (regression: advisor r3)
    full = eng.search_radius(q, radius=1e9, max_results=400)
    assert all(len(ix) == 400 for ix in full.indices)
    assert not full.truncated.any()
    sfull = seng.search_radius(q, radius=float(sim.min()) - 1.0,
                               max_results=400)
    assert all(len(ix) == 400 for ix in sfull.indices)
    assert not sfull.truncated.any()
