"""Randomized equivalence: for seeded random configurations (shape, k,
metric, dtype, tombstones, duplicate density, scan block sizes), the
blocked exact scan in one block and in many, and the NumPy oracle must
agree bit-for-rank. This is the property-based face of the
exactness contract (`ops/distances.py`); the reference's analog is its
per-module unit matrix, which never crosses implementations.
"""

import numpy as np
import pytest

from metrovector_tpu.format.constants import DistanceMetric
from metrovector_tpu.ops.distances import exact_topk, numpy_oracle


def _random_config(rng):
    n = int(rng.integers(64, 700))
    d = int(rng.choice([4, 8, 16, 24, 32]))
    k = int(rng.integers(1, min(n, 140)))
    metric = DistanceMetric(int(rng.choice([0, 1, 2])))
    dup = float(rng.choice([0.0, 0.0, 0.5, 0.9]))
    tomb = float(rng.choice([0.0, 0.1]))
    block_rows = int(rng.choice([64, 128, 200]))
    return n, d, k, metric, dup, tomb, block_rows


# The extra 5xxx seeds come from the deep-fuzz session that exposed the
# oracle's dgemm tie nondeterminism for duplicate rows (cosine/IP at high
# duplication; fixed by ranking at f32 granularity in numpy_oracle) —
# extra trials guarding the canonicalized tie contract.
@pytest.mark.parametrize(
    "seed",
    [1000 + t for t in range(12)] + [5012, 5013, 5018, 5021, 5036],
)
def test_fuzz_scan_matches_oracle(seed):
    rng = np.random.default_rng(seed)
    n, d, k, metric, dup, tomb, block_rows = _random_config(rng)
    db = rng.standard_normal((n, d)).astype(np.float32)
    if dup:
        src = rng.integers(0, max(1, int(n * (1 - dup))), n)
        db = db[np.sort(src)]
    q = rng.standard_normal((int(rng.integers(1, 20)), d)).astype(np.float32)
    if metric == DistanceMetric.COSINE:
        q = q / np.maximum(
            np.linalg.norm(q, axis=1, keepdims=True), 1e-30
        )
    norms = (db.astype(np.float64) ** 2).sum(1).astype(np.float32)
    mask = None
    if tomb:
        mask = (rng.random(n) > tomb).astype(np.float32)

    os_, oi = numpy_oracle(q, db, k, metric, valid_mask=mask)
    oi_norm = np.where(np.isneginf(os_), -1, oi)

    ps, pi = exact_topk(
        q, db, norms, np.int32(n), k, metric, valid_mask=mask,
        block_rows=block_rows,
    )
    cfg = (n, d, k, int(metric), dup, tomb, block_rows)
    assert np.array_equal(np.asarray(pi), oi_norm), f"blocked != oracle {cfg}"

    xs, xi = exact_topk(
        q, db, norms, n, k, metric, valid_mask=mask, block_rows=n
    )
    assert np.array_equal(np.asarray(xi), oi_norm), f"one block != oracle {cfg}"

    # scores agree where slots are filled
    filled = oi_norm >= 0
    np.testing.assert_allclose(
        np.asarray(ps)[filled], os_[filled], rtol=1e-5, atol=1e-5,
        err_msg=f"blocked scores diverged {cfg}",
    )


@pytest.mark.parametrize("trial", range(4))
def test_fuzz_int8_paths(trial):
    """Integer dot path (symmetric int8) vs a dequantized oracle."""
    rng = np.random.default_rng(2000 + trial)
    n = int(rng.integers(100, 500))
    d = int(rng.choice([8, 16, 32]))
    k = int(rng.integers(1, 40))
    block_rows = int(rng.choice([32, 64, 128]))
    codes = rng.integers(-128, 128, (n, d)).astype(np.int8)
    scale = 0.05
    deq = codes.astype(np.float32) * scale
    norms = (deq.astype(np.float64) ** 2).sum(1).astype(np.float32)
    q = rng.integers(-128, 128, (5, d)).astype(np.int8)
    qf = q.astype(np.float32) * scale
    _, oi = numpy_oracle(qf, deq, k, DistanceMetric.INNER_PRODUCT)
    s, i = exact_topk(
        q, codes, norms, np.int32(n), k, DistanceMetric.INNER_PRODUCT,
        scale=scale * scale, block_rows=block_rows,
    )
    assert np.array_equal(np.asarray(i), oi), (trial, block_rows)


@pytest.mark.parametrize("seed", [2000 + t for t in range(10)])
def test_fuzz_sparse_formulations(seed, tmp_path):
    """Randomized sparse configs: ELL+overflow, the CSR segment-sum scan
    and the dense oracle must agree bit-for-rank — shapes, nnz skew
    (including planted wide rows that force the overflow path and empty
    rows), metric and tombstones all drawn per seed. L2/IP only: exact
    cosine ties between proportional sparse rows legitimately round
    differently in the rsqrt epilogue (the sub-ulp contract)."""
    from metrovector_tpu import Builder, Reader, VectorType
    from metrovector_tpu.sparse import SparseSearchEngine

    rng = np.random.default_rng(seed)
    n = int(rng.integers(40, 400))
    dim = int(rng.integers(32, 500))
    k = int(rng.integers(1, 25))
    metric = DistanceMetric(int(rng.choice([0, 1])))  # L2, IP
    wide = set(
        rng.choice(n, size=int(rng.integers(0, 4)), replace=False).tolist()
    )
    rows = []
    for i in range(n):
        if i in wide:
            nz = int(rng.integers(dim // 2, dim))
        elif rng.random() < 0.05:
            nz = 0  # empty row
        else:
            nz = int(rng.integers(1, min(12, dim)))
        cols = rng.choice(dim, size=nz, replace=False)
        rows.append((cols, rng.standard_normal(nz).astype(np.float32)))
    b = Builder()
    b.add_vector_space("s", dim=dim, vector_type=VectorType.SPARSE,
                       metric=metric)
    b.add_sparse_vectors("s", rows)
    tombs = rng.choice(n, size=int(rng.integers(0, max(1, n // 10))),
                       replace=False)
    for t in tombs:
        b.delete_vector("s", int(t))
    path = tmp_path / "fz.mvt"
    b.build().save(path)
    sp = Reader.open(path).vector_space("s")
    dense = sp.to_numpy()
    mask = np.ones(n, bool)
    mask[tombs.astype(np.int64)] = False
    q = rng.standard_normal((int(rng.integers(1, 9)), dim)).astype(
        np.float32
    )
    _, oi = numpy_oracle(q, dense, min(k, n), metric,
                         valid_mask=mask.astype(np.float32))
    results = {}
    for f in ("ell", "coo"):
        res = SparseSearchEngine(sp, formulation=f).search(q, k=k)
        assert np.array_equal(res.indices[:, : oi.shape[1]], oi), (
            seed, f, metric,
        )
        results[f] = res
    np.testing.assert_array_equal(
        results["ell"].indices, results["coo"].indices
    )
