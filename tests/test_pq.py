"""Product quantization: training, encoding, ADC search, re-ranking,
persistence. The reference declares PQ codebook tables in its extensions
schema (``schema/extensions.fbs``) but never writes or reads them — these
tests define the real behavior.

Core correctness property: ADC with ``exact_lut=True`` must rank exactly
like brute-force search over the *reconstructed* vectors (ADC is exact on
x̂ by the additive-subspace algebra), and re-ranking against the original
vectors must recover oracle recall.
"""

import numpy as np
import pytest

from metrovector_tpu import Builder, DataType, DistanceMetric, Reader
from metrovector_tpu.errors import DimensionMismatchError
from metrovector_tpu.index import (
    PQIndex,
    encode_pq,
    reconstruct_pq,
    train_pq,
)
from metrovector_tpu.ops import numpy_oracle

METRICS = [DistanceMetric.L2, DistanceMetric.COSINE, DistanceMetric.INNER_PRODUCT]


def _data(rng, n=400, d=16):
    return rng.standard_normal((n, d)).astype(np.float32)


def test_train_encode_shapes(rng):
    data = _data(rng)
    books = train_pq(data, m=4, ksub=16, iters=4)
    assert books.shape == (4, 16, 4)
    codes = encode_pq(data, books)
    assert codes.shape == (400, 4)
    assert codes.dtype == np.uint8
    assert codes.max() < 16


def test_train_rejects_indivisible_dim(rng):
    with pytest.raises(ValueError, match="not divisible"):
        train_pq(_data(rng, d=10), m=4)


def test_encoding_is_nearest_centroid(rng):
    """Each code must be the argmin-distance centroid of its subspace."""
    data = _data(rng, n=64, d=8)
    books = train_pq(data, m=2, ksub=8, iters=4)
    codes = encode_pq(data, books)
    for j in range(2):
        sub = data[:, j * 4 : (j + 1) * 4]
        d2 = ((sub[:, None, :] - books[j][None]) ** 2).sum(-1)
        expect = d2.argmin(1)
        assert np.array_equal(codes[:, j], expect)


def test_reconstruction_beats_mean_baseline(rng):
    """PQ reconstruction error must be far below the trivial (all-mean)
    quantizer — i.e. training actually learns the distribution."""
    data = _data(rng, n=800, d=32)
    books = train_pq(data, m=8, ksub=32, iters=8)
    recon = reconstruct_pq(encode_pq(data, books), books)
    err = ((recon - data) ** 2).sum()
    baseline = ((data - data.mean(0)) ** 2).sum()
    assert err < 0.35 * baseline


@pytest.mark.parametrize("metric", METRICS)
def test_adc_ranks_exactly_like_reconstructed_bruteforce(rng, metric):
    """exact_lut ADC == oracle search over x̂, bit-for-rank."""
    data = _data(rng, n=300, d=16)
    idx = PQIndex.build(data, metric, m=4, ksub=16, iters=5)
    recon = reconstruct_pq(np.asarray(idx.codes, np.uint8), idx.codebooks)
    q = _data(rng, n=7, d=16)
    res = idx.search(q, k=10)
    _, oi = numpy_oracle(q, recon, 10, metric)
    assert np.array_equal(res.indices, oi)


@pytest.mark.parametrize("metric", METRICS)
def test_full_rerank_recovers_oracle(rng, metric):
    """rerank == N rescoring the whole corpus must equal the exact oracle
    over the ORIGINAL vectors, regardless of quantization quality."""
    data = _data(rng, n=200, d=16)
    idx = PQIndex.build(data, metric, m=4, ksub=16, iters=4)
    q = _data(rng, n=5, d=16)
    res = idx.search(q, k=10, rerank=200)
    _, oi = numpy_oracle(q, data, 10, metric)
    assert np.array_equal(res.indices, oi)


def test_moderate_rerank_high_recall(rng):
    data = _data(rng, n=1000, d=32)
    idx = PQIndex.build(data, DistanceMetric.L2, m=8, ksub=32, iters=8)
    q = _data(rng, n=20, d=32)
    res = idx.search(q, k=10, rerank=80)
    _, oi = numpy_oracle(q, data, 10, DistanceMetric.L2)
    hits = sum(
        len(set(res.indices[i]) & set(oi[i])) for i in range(len(q))
    )
    assert hits / (20 * 10) >= 0.9


def test_bf16_lut_close_to_exact(rng):
    """The fast bf16 LUT path must agree with exact ADC on most of the
    top-k (it only perturbs scores by bf16 rounding)."""
    data = _data(rng, n=500, d=16)
    idx = PQIndex.build(data, DistanceMetric.L2, m=4, ksub=16, iters=5)
    q = _data(rng, n=8, d=16)
    a = idx.search(q, k=10, exact_lut=True)
    b = idx.search(q, k=10, exact_lut=False)
    overlap = sum(
        len(set(a.indices[i]) & set(b.indices[i])) for i in range(8)
    )
    assert overlap / 80 >= 0.8


def test_rerank_without_vectors_raises(rng):
    data = _data(rng, n=100, d=8)
    idx = PQIndex.build(data, DistanceMetric.L2, m=2, ksub=8, keep_vectors=False)
    assert idx.db is None
    with pytest.raises(ValueError, match="rerank"):
        idx.search(_data(rng, n=2, d=8), k=5, rerank=20)


def test_query_dim_mismatch(rng):
    idx = PQIndex.build(_data(rng, n=50, d=8), DistanceMetric.L2, m=2, ksub=8)
    with pytest.raises(DimensionMismatchError):
        idx.search(np.zeros((1, 12), np.float32), k=3)


def test_k_larger_than_corpus(rng):
    data = _data(rng, n=6, d=8)
    idx = PQIndex.build(data, DistanceMetric.L2, m=2, ksub=4, iters=3)
    res = idx.search(_data(rng, n=2, d=8), k=10)
    assert res.indices.shape == (2, 10)
    assert (res.indices[:, 6:] == -1).all()


# ------------------------------------------------------------ persistence ---


def test_pq_roundtrip_through_file(tmp_path, rng):
    data = _data(rng, n=120, d=16)
    books = train_pq(data, m=4, ksub=16, iters=4)
    codes = encode_pq(data, books)

    b = Builder()
    b.add_vector_space("s", dim=16)
    b.add_vectors("s", data)
    b.set_pq_index("s", books, codes)
    path = tmp_path / "pq.mvt"
    b.build().save(path)

    r = Reader.open(path)
    sp = r.vector_space("s")
    stored = sp.pq_arrays()
    assert stored is not None
    sb, sc, sn = stored
    np.testing.assert_array_equal(sb, books)
    np.testing.assert_array_equal(sc, codes)
    recon = reconstruct_pq(codes, books)
    np.testing.assert_allclose(
        sn, (recon.astype(np.float64) ** 2).sum(1).astype(np.float32), rtol=1e-6
    )

    # from_space must reuse the stored structure (no retraining): the codes
    # on device equal the persisted ones.
    idx = PQIndex.from_space(sp)
    np.testing.assert_array_equal(np.asarray(idx.codes, np.uint8), codes)
    q = _data(rng, n=4, d=16)
    res = idx.search(q, k=5, rerank=120)
    _, oi = numpy_oracle(q, data, 5, DistanceMetric.L2)
    assert np.array_equal(res.indices, oi)


def test_code_only_from_space_skips_dense_rows(tmp_path, rng):
    """keep_vectors=False with a stored sidecar must build straight from
    the sidecar blocks (no dense-row materialization) and search like the
    trained index."""
    data = _data(rng, n=90, d=16)
    books = train_pq(data, m=4, ksub=16, iters=4)
    codes = encode_pq(data, books)
    b = Builder()
    b.add_vector_space("s", dim=16)
    b.add_vectors("s", data)
    b.set_pq_index("s", books, codes)
    path = tmp_path / "co.mvt"
    b.build().save(path)
    sp = Reader.open(path).vector_space("s")

    calls = []
    orig = sp.to_numpy
    sp.to_numpy = lambda: (calls.append(1), orig())[1]
    idx = PQIndex.from_space(sp, keep_vectors=False)
    assert not calls  # dense rows never touched
    assert idx.db is None
    q = _data(rng, n=3, d=16)
    res = idx.search(q, k=5)
    recon = reconstruct_pq(codes, books)
    _, oi = numpy_oracle(q, recon, 5, DistanceMetric.L2)
    assert np.array_equal(res.indices, oi)


def test_pq_validation_errors(rng):
    data = _data(rng, n=30, d=8)
    b = Builder()
    b.add_vector_space("s", dim=8)
    b.add_vectors("s", data)
    books = train_pq(data, m=2, ksub=8, iters=3)
    codes = encode_pq(data, books)
    from metrovector_tpu.errors import BuildError

    with pytest.raises(BuildError):
        b.set_pq_index("s", books, codes[:10])  # wrong row count
    with pytest.raises(DimensionMismatchError):
        b.set_pq_index("s", books[:1], codes[:, :1])  # m*dsub != dim


def test_pq_excludes_tombstoned_rows(tmp_path, rng):
    data = _data(rng, n=60, d=8)
    b = Builder()
    b.add_vector_space("s", dim=8)
    b.add_vectors("s", data)
    b.delete_vector("s", 3)
    b.delete_vector("s", 17)
    path = tmp_path / "t.mvt"
    b.build().save(path)
    sp = Reader.open(path).vector_space("s")
    idx = PQIndex.from_space(sp, m=2, ksub=8, iters=3)
    res = idx.search(data[[3, 17]], k=5, rerank=60)
    assert 3 not in res.indices
    assert 17 not in res.indices


def test_pq_on_quantized_space(tmp_path, rng):
    """PQ over an int8 space trains/encodes on dequantized values."""
    data = (rng.standard_normal((80, 8)) * 0.5).astype(np.float32)
    b = Builder()
    b.add_vector_space("s", dim=8, dtype=DataType.INT8)
    b.add_vectors("s", data)
    path = tmp_path / "q.mvt"
    b.build().save(path)
    sp = Reader.open(path).vector_space("s")
    idx = PQIndex.from_space(sp, m=2, ksub=16, iters=4)
    q = data[:3]
    res = idx.search(q, k=1, rerank=16)
    # nearest neighbor of a stored row is itself (dequant error ≪ row gaps)
    assert np.array_equal(res.indices[:, 0], [0, 1, 2])


def test_packed4_index_and_persistence_roundtrip(rng, tmp_path):
    """PQIndex(pack4=True) must search identically to the unpacked index
    in one scan block and across many (per-block nibble unpack), persist
    through set_pq_index(packed4=True), and
    reattach code-only from the sidecar with half-width codes."""
    import jax
    import numpy as np
    from metrovector_tpu import Builder, Reader
    from metrovector_tpu.format.constants import DistanceMetric
    from metrovector_tpu.index.pq import PQIndex

    n, d, m = 600, 32, 8
    data = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((5, d)).astype(np.float32)
    a = PQIndex.build(data, DistanceMetric.L2, m=m, ksub=16, iters=4,
                      keep_vectors=False)
    b = PQIndex.build(data, DistanceMetric.L2, m=m, ksub=16, iters=4,
                      keep_vectors=False, pack4=True)
    assert not a.packed4 and b.packed4
    assert b.codes.shape == (n, m // 2)
    assert b.code_bytes_per_vector == m // 2
    ra = a.search(q, k=10, rerank=0)
    rb = b.search(q, k=10, rerank=0)
    np.testing.assert_array_equal(ra.indices, rb.indices)
    rp = b.search(q, k=10, rerank=0, block_rows=64)
    np.testing.assert_array_equal(ra.indices, rp.indices)

    # online mutation keeps the packed layout
    b.add_rows(data[:5] + 0.01)
    assert b.codes.shape[1] == m // 2

    # persistence: packed sidecar -> reattach code-only
    bld = Builder()
    bld.add_vector_space("e", dim=d, metric=DistanceMetric.L2)
    bld.add_vectors("e", data)
    bld.set_pq_index("e", a.codebooks, np.asarray(b.codes)[:n],
                     packed4=True)
    path = str(tmp_path / "p4.mvt")
    bld.build().save(path)
    sp = Reader.open(path).vector_space("e")
    assert sp.info.pq.packed4
    c = PQIndex.from_space(sp, keep_vectors=False)
    assert c.packed4 and c.codes.shape == (n, m // 2)
    rc = c.search(q, k=10, rerank=0)
    np.testing.assert_array_equal(ra.indices, rc.indices)
