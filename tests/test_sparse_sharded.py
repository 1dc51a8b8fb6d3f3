"""Multi-chip sparse search on the virtual 8-device CPU mesh: the global
top-k over a row-sharded ELL corpus must match the single-chip sparse
engine and the dense oracle exactly — including per-shard overflow tails
and tombstones. Reference analog: none (``VectorType::Sparse`` is
declared but unimplemented in the reference, ``schema/types.fbs:14-17``)."""

import jax
import numpy as np
import pytest

from metrovector_tpu import Builder, DistanceMetric, Reader, VectorType
from metrovector_tpu.errors import InvalidVectorTypeError
from metrovector_tpu.ops import numpy_oracle
from metrovector_tpu.parallel import ShardedSparseSearchEngine, make_mesh
from metrovector_tpu.sparse import SparseSearchEngine

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 2, reason="needs a multi-device (virtual) platform"
)


def _sparse_file(tmp_path, rng, n=400, dim=300, metric=DistanceMetric.L2,
                 wide=(), tombstone=None, with_ids=False):
    rows = []
    for i in range(n):
        # nnz ≥ 2: single-entry rows sharing a column are EXACT cosine
        # ties (scale collapses), where the engine's rsqrt epilogue and
        # the oracle's f64 divide legitimately disagree by ~1 ulp (the
        # documented sub-ulp contract, ops/distances.py). The
        # sharded-vs-single-chip parity assertion below still pins tie
        # behavior.
        nz = 120 if i in wide else int(rng.integers(2, 10))
        cols = rng.choice(dim, size=nz, replace=False)
        rows.append((cols, rng.standard_normal(nz).astype(np.float32)))
    b = Builder()
    b.add_vector_space("s", dim=dim, vector_type=VectorType.SPARSE,
                       metric=metric)
    b.add_sparse_vectors("s", rows)
    if with_ids:
        b.set_vector_ids("s", np.arange(1000, 1000 + n, dtype=np.uint64))
    if tombstone is not None:
        b.delete_vector("s", tombstone)
    path = tmp_path / "s.mvt"
    b.build().save(path)
    return Reader.open(path).vector_space("s")


@pytest.mark.parametrize(
    "metric",
    [DistanceMetric.L2, DistanceMetric.COSINE, DistanceMetric.INNER_PRODUCT],
)
@pytest.mark.parametrize("ndev", [2, 8])
def test_sharded_sparse_matches_oracle(tmp_path, rng, metric, ndev):
    sp = _sparse_file(tmp_path, rng, metric=metric, wide=(7, 133))
    dense = sp.to_numpy()
    mesh = make_mesh(ndev)
    eng = ShardedSparseSearchEngine(sp, mesh)
    assert eng._has_ovf  # the planted wide rows must spill
    q = rng.standard_normal((5, 300)).astype(np.float32)
    q[0] = dense[7]  # target a wide row through the overflow path
    res = eng.search(q, k=10)
    _, oi = numpy_oracle(q, dense, 10, metric)
    assert np.array_equal(res.indices, oi)
    # single-chip parity (scores too, same f32 contraction order per row)
    single = SparseSearchEngine(sp, formulation="ell").search(q, k=10)
    np.testing.assert_array_equal(res.indices, single.indices)
    np.testing.assert_allclose(res.scores, single.scores, rtol=1e-6)


def test_sharded_sparse_tombstones_and_ids(tmp_path, rng):
    sp = _sparse_file(tmp_path, rng, n=300, tombstone=42, with_ids=True)
    dense = sp.to_numpy()
    mesh = make_mesh(8)
    eng = ShardedSparseSearchEngine(sp, mesh)
    q = dense[[42, 10]].astype(np.float32)
    res = eng.search(q, k=5)
    assert 42 not in res.indices
    mask = np.ones(300, bool)
    mask[42] = False
    _, oi = numpy_oracle(q, dense, 5, DistanceMetric.L2,
                         valid_mask=mask.astype(np.float32))
    assert np.array_equal(res.indices, oi)
    # stable IDs carried through the all-gather merge
    assert res.ids is not None
    live = res.indices >= 0
    assert np.array_equal(res.ids[live],
                          (res.indices[live] + 1000).astype(np.uint64))


def test_sharded_sparse_k_exceeds_corpus_and_guards(tmp_path, rng):
    sp = _sparse_file(tmp_path, rng, n=12)
    mesh = make_mesh(8)  # more shards than filled row blocks
    eng = ShardedSparseSearchEngine(sp, mesh)
    q = rng.standard_normal((2, 300)).astype(np.float32)
    res = eng.search(q, k=20)
    assert res.indices.shape == (2, 20)
    assert (res.indices[:, 12:] == -1).all()
    assert set(res.indices[0, :12]) == set(range(12))

    # dense space rejected
    b = Builder()
    b.add_vector_space("d", dim=8)
    b.add_vectors("d", np.zeros((4, 8), np.float32))
    p = tmp_path / "d.mvt"
    b.build().save(p)
    with pytest.raises(InvalidVectorTypeError):
        ShardedSparseSearchEngine(Reader.open(p).vector_space("d"), mesh)
