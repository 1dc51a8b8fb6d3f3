"""Multi-space Database facade: lazy engines, metadata predicates as
exact in-kernel filters, stable-ID results."""

import numpy as np
import pytest

from metrovector_tpu import Builder, Database
from metrovector_tpu.errors import MetadataColumnNotFoundError
from metrovector_tpu.format.constants import DistanceMetric
from metrovector_tpu.ops.distances import numpy_oracle


@pytest.fixture
def db_file(tmp_path, rng):
    b = Builder()
    b.add_vector_space("docs", dim=8)
    data = rng.standard_normal((50, 8)).astype(np.float32)
    b.add_vectors("docs", data, ids=np.arange(50, dtype=np.uint64) + 500)
    b.add_metadata_column("docs", "lang", ["en", "de"] * 25)
    b.add_metadata_column("docs", "price", list(range(50)))
    b.add_vector_space("imgs", dim=4)
    imgs = rng.standard_normal((10, 4)).astype(np.float32)
    b.add_vectors("imgs", imgs)
    p = tmp_path / "db.mvt"
    b.build().save(p)
    return p, data, imgs


def test_lazy_engines_and_search(db_file, rng):
    p, data, imgs = db_file
    db = Database.open(p)
    assert db.space_names == ["docs", "imgs"]
    q = rng.standard_normal((3, 8)).astype(np.float32)
    res = db.search("docs", q, k=4)
    _, oi = numpy_oracle(q, data, 4, DistanceMetric.L2)
    assert np.array_equal(res.indices, oi)
    assert np.array_equal(res.ids, oi.astype(np.uint64) + 500)
    r2 = db.search("imgs", imgs[:1], k=1)
    assert r2.indices[0, 0] == 0
    with pytest.raises(ValueError):
        db.engine()  # ambiguous: two spaces


def test_metadata_predicates(db_file, rng):
    p, data, _ = db_file
    db = Database.open(p)
    q = rng.standard_normal((2, 8)).astype(np.float32)
    res = db.search("docs", q, k=5, where=("lang", "==", "en"))
    assert (res.indices % 2 == 0).all()  # "en" rows are even
    mask = np.zeros(50, bool)
    mask[::2] = True
    _, oi = numpy_oracle(q, data, 5, DistanceMetric.L2,
                         valid_mask=mask.astype(np.float32))
    assert np.array_equal(res.indices, oi)

    # AND-combined predicates + numeric comparison
    res2 = db.search(
        "docs", q, k=3,
        where=[("lang", "==", "de"), ("price", "<", 20)],
    )
    got = res2.indices[res2.indices >= 0]
    assert ((got % 2 == 1) & (got < 20)).all()

    # "in" operator and composition with an explicit mask
    extra = np.zeros(50, bool)
    extra[:10] = True
    res3 = db.search("docs", q, k=3, where=("lang", "in", {"en"}),
                     filter_mask=extra)
    got3 = res3.indices[res3.indices >= 0]
    assert ((got3 % 2 == 0) & (got3 < 10)).all()

    with pytest.raises(MetadataColumnNotFoundError):
        db.column_mask("docs", "nope", "==", 1)
    with pytest.raises(ValueError):
        db.column_mask("docs", "lang", "~=", "en")


def test_index_reattachment(tmp_path, rng):
    """Persisted index sidecars reattach through the facade without
    retraining; search results match the standalone index APIs."""
    from metrovector_tpu import Builder, Database
    from metrovector_tpu.index.pq import encode_pq, train_pq

    data = rng.standard_normal((300, 16)).astype(np.float32)
    books = train_pq(data, m=4, ksub=16, iters=3)
    codes = encode_pq(data, books)
    from metrovector_tpu.index.pq import reconstruct_pq

    recon = reconstruct_pq(codes, books)
    rn = np.einsum("ij,ij->i", recon, recon).astype(np.float32)
    b = Builder()
    b.add_vector_space("v", dim=16)
    b.add_vectors("v", data)
    b.set_pq_index("v", books, codes, rn)
    p = tmp_path / "pq.mvt"
    b.build().save(p)
    db = Database.open(p)
    idx = db.pq_index("v", keep_vectors=True)
    assert np.array_equal(np.asarray(idx.codes)[: len(codes)], codes)
    # deep re-rank: m=4 PQ on unclustered gaussians is coarse, so a
    # shallow fetch can miss exact neighbors — the exactness claim here
    # is about reattachment + re-rank plumbing, not PQ recall
    res = idx.search(data[:3], k=4, rerank=200)
    _, oi = numpy_oracle(data[:3], data, 4, DistanceMetric.L2)
    assert np.array_equal(res.indices, oi)


def test_hbm_budget_lru_eviction(db_file, rng):
    """Round-3 verdict item: the facade must not accrete device arrays
    without bound. Budget admits one space at a time here, so touching
    the second evicts the first (LRU), and re-touching rebuilds it."""
    p, data, imgs = db_file
    one_space = Database.open(p)._estimate_nbytes("docs")
    db = Database.open(p, hbm_budget=one_space)
    db.search("docs", data[:1], k=3)
    assert set(db._engines) == {"docs"}
    assert 0 < db.resident_bytes <= one_space
    db.search("imgs", imgs[:1], k=3)  # imgs fits only after evicting docs
    assert set(db._engines) == {"imgs"}
    db.search("docs", data[:1], k=3)  # transparently rebuilt
    assert set(db._engines) == {"docs"}

    # LRU order: most recently searched survives
    big = Database.open(
        p,
        hbm_budget=one_space
        + Database.open(p)._estimate_nbytes("imgs"),
    )
    big.search("docs", data[:1], k=3)
    big.search("imgs", imgs[:1], k=3)
    big.search("docs", data[:1], k=3)  # touch docs -> imgs is now LRU
    assert list(big._engines) == ["imgs", "docs"]

    # explicit eviction
    assert big.evict("imgs") is True
    assert big.evict("imgs") is False
    assert list(big._engines) == ["docs"]


def test_hbm_budget_too_small_is_typed_error(db_file):
    from metrovector_tpu.errors import HBMBudgetExceededError, MvtError

    p, data, _ = db_file
    db = Database.open(p, hbm_budget=64)
    with pytest.raises(HBMBudgetExceededError) as ei:
        db.search("docs", data[:1], k=1)
    assert isinstance(ei.value, MvtError)
    assert isinstance(ei.value, MemoryError)
    assert ei.value.budget == 64 and ei.value.needed > 64
    assert db._engines == {}  # nothing leaked


def test_estimate_matches_actual_footprint(db_file, rng):
    p, data, _ = db_file
    db = Database.open(p)
    est = db._estimate_nbytes("docs")
    eng = db.engine("docs")
    assert est == eng.space.nbytes


def test_database_routes_sparse_spaces(tmp_path, rng):
    """A sparse space in a multi-space file serves through the facade:
    routed to SparseSearchEngine, metadata predicates become exact row
    masks, the memory budget counts its device bytes."""
    from metrovector_tpu import VectorType
    from metrovector_tpu.ops import numpy_oracle
    from metrovector_tpu.sparse import SparseSearchEngine

    b = Builder()
    b.add_vector_space("dense", dim=16)
    b.add_vectors("dense", rng.standard_normal((50, 16)).astype(np.float32))
    b.add_vector_space("sp", dim=64, vector_type=VectorType.SPARSE)
    rows = []
    for i in range(120):
        nz = int(rng.integers(2, 8))
        cols = rng.choice(64, size=nz, replace=False)
        rows.append((cols, rng.standard_normal(nz).astype(np.float32)))
    b.add_sparse_vectors("sp", rows)
    b.add_metadata_column("sp", "lang",
                          ["en" if i % 2 else "de" for i in range(120)])
    path = tmp_path / "mix.mvt"
    b.build().save(path)

    db = Database.open(path)
    eng = db.engine("sp")
    assert isinstance(eng, SparseSearchEngine)
    dense_rows = db.reader.vector_space("sp").to_numpy()
    q = rng.standard_normal((4, 64)).astype(np.float32)
    res = db.search("sp", q, k=5, where=("lang", "==", "en"))
    mask = np.asarray([i % 2 == 1 for i in range(120)])
    _, oi = numpy_oracle(q, dense_rows, 5, DistanceMetric.L2,
                         valid_mask=mask.astype(np.float32))
    assert np.array_equal(res.indices, oi)
    # budget accounting sees the sparse engine's bytes
    assert db.resident_bytes >= eng.nbytes > 0
    # pre-upload estimate mirrors the engine's actual ELL footprint
    assert db._estimate_nbytes("sp") == eng.nbytes


def test_sparse_estimate_tracks_coo_fallback(tmp_path, rng):
    """When the nnz/row skew makes the sparse engine's 'auto' pick COO,
    the budget estimate must follow it — the ELL figure over-charges 2×+
    and forces needless evictions (regression: advisor r3)."""
    from metrovector_tpu import VectorType
    from metrovector_tpu.sparse import SparseSearchEngine

    b = Builder()
    b.add_vector_space("sk", dim=512, vector_type=VectorType.SPARSE)
    rows = []
    for i in range(1000):
        # 990 rows with 1 entry, 10 rows with 100: ELL pads 1,990 entries
        # to ~8,920 (>3×) → engine picks COO
        nz = 100 if i % 100 == 0 else 1
        cols = rng.choice(512, size=nz, replace=False)
        rows.append((cols, rng.standard_normal(nz).astype(np.float32)))
    b.add_sparse_vectors("sk", rows)
    path = tmp_path / "skew.mvt"
    b.build().save(path)

    db = Database.open(path)
    est = db._estimate_nbytes("sk")
    eng = db.engine("sk")
    assert isinstance(eng, SparseSearchEngine)
    assert eng.formulation == "coo"
    assert est == eng.nbytes
