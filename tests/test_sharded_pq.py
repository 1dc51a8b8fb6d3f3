"""Sharded PQ search on the virtual 8-device CPU mesh: per-shard ADC +
shard-local exact re-ranking + all-gather merge must reproduce the single-device
PQ answers exactly (same codes, same algebra)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from metrovector_tpu import DistanceMetric
from metrovector_tpu.index.pq import PQIndex, encode_pq, reconstruct_pq, train_pq
from metrovector_tpu.ops import numpy_oracle
from metrovector_tpu.parallel import (
    make_mesh,
    replicate,
    shard_rows,
    sharded_pq_topk,
)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 2, reason="needs a multi-device (virtual) platform"
)


def _pq_case(rng, n=800, d=16, m=4, ksub=16):
    data = rng.standard_normal((n, d)).astype(np.float32)
    books = train_pq(data, m=m, ksub=ksub, iters=4)
    codes = encode_pq(data, books)
    recon = reconstruct_pq(codes, books)
    rnorms = np.einsum(
        "ij,ij->i", recon.astype(np.float64), recon.astype(np.float64)
    ).astype(np.float32)
    dnorms = np.einsum(
        "ij,ij->i", data.astype(np.float64), data.astype(np.float64)
    ).astype(np.float32)
    return data, books, codes, recon, rnorms, dnorms


@pytest.mark.parametrize("ndev", [2, 8, 4])
def test_sharded_pq_adc_matches_reconstruction_oracle(rng, ndev):
    data, books, codes, recon, rnorms, _ = _pq_case(rng)
    mesh = make_mesh(ndev)
    q = rng.standard_normal((5, 16)).astype(np.float32)
    s, i = sharded_pq_topk(
        replicate(q, mesh),
        shard_rows(codes, mesh),
        jnp.asarray(books),
        shard_rows(rnorms, mesh),
        len(data), 10, DistanceMetric.L2, mesh,
        exact_lut=True,
    )
    _, oi = numpy_oracle(q, recon, 10, DistanceMetric.L2)
    assert np.array_equal(np.asarray(i), oi)


def test_sharded_pq_rerank_matches_true_oracle(rng):
    """Shard-local re-rank with full fetch depth == exact oracle over the
    ORIGINAL vectors (every true neighbor is reranked by its own shard)."""
    data, books, codes, recon, rnorms, dnorms = _pq_case(rng, n=640)
    mesh = make_mesh(8)
    q = rng.standard_normal((4, 16)).astype(np.float32)
    s, i = sharded_pq_topk(
        replicate(q, mesh),
        shard_rows(codes, mesh),
        jnp.asarray(books),
        shard_rows(rnorms, mesh),
        len(data), 10, DistanceMetric.L2, mesh,
        db=shard_rows(data, mesh),
        db_norms=shard_rows(dnorms, mesh),
        rerank=640 // 8,  # full local depth: every row reranked
    )
    _, oi = numpy_oracle(q, data, 10, DistanceMetric.L2)
    assert np.array_equal(np.asarray(i), oi)


def test_sharded_pq_matches_single_device(rng):
    """Cross-check the whole sharded path against PQIndex on one device,
    including cosine pre-normalization."""
    data, books, codes, recon, rnorms, dnorms = _pq_case(rng, n=400)
    mesh = make_mesh(8)
    q = rng.standard_normal((4, 16)).astype(np.float32)
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    s, i = sharded_pq_topk(
        replicate(qn, mesh),
        shard_rows(codes, mesh),
        jnp.asarray(books),
        shard_rows(rnorms, mesh),
        len(data), 10, DistanceMetric.COSINE, mesh,
        exact_lut=True,
    )
    idx = PQIndex.build(
        data, DistanceMetric.COSINE, codebooks=books, codes=codes
    )
    single = idx.search(q, k=10, exact_lut=True)
    assert np.array_equal(np.asarray(i), single.indices)


def test_sharded_pq_approx_lut(rng):
    """bf16-LUT ADC (``exact_lut=False``) on the sharded path: candidates
    near the exact-LUT sharded ranking."""
    import jax.numpy as jnp

    from metrovector_tpu.index.pq import encode_pq, reconstruct_pq, train_pq
    from metrovector_tpu.parallel import (
        make_mesh,
        replicate,
        shard_rows,
        sharded_pq_topk,
    )

    mesh = make_mesh(8)
    n, d = 1024, 32
    db = rng.standard_normal((n, d)).astype(np.float32)
    books = train_pq(db, m=4, ksub=32, iters=3)
    codes = encode_pq(db, books)
    recon = reconstruct_pq(codes, books)
    rn = np.einsum("ij,ij->i", recon, recon).astype(np.float32)
    q = rng.standard_normal((5, d)).astype(np.float32)
    args = (
        replicate(q, mesh), shard_rows(codes, mesh), jnp.asarray(books),
        shard_rows(rn, mesh), n, 20, DistanceMetric.L2, mesh,
    )
    s_e, i_e = sharded_pq_topk(
        *args, exact_lut=True
    )
    s_q, i_q = sharded_pq_topk(
        *args, exact_lut=False
    )
    overlap = np.mean([
        len(set(np.asarray(i_e)[r]) & set(np.asarray(i_q)[r])) / 20
        for r in range(5)
    ])
    assert overlap >= 0.85, overlap


def test_sharded_packed4_matches_unsharded(rng):
    """Nibble-packed 4-bit codes shard row-wise exactly like byte codes;
    the 8-way sharded result must match the single-device search."""
    from metrovector_tpu.index.pq import PQIndex
    from metrovector_tpu.index.pq import adc_topk

    n, d, m, k = 1024, 32, 8, 7
    data = rng.standard_normal((n, d)).astype(np.float32)
    idx = PQIndex.build(data, DistanceMetric.L2, m=m, ksub=16, iters=3,
                        keep_vectors=False, pack4=True)
    mesh = make_mesh(8)
    q = rng.standard_normal((6, d)).astype(np.float32)
    s0, i0 = adc_topk(
        q, np.asarray(idx.codes), jnp.asarray(idx.codebooks),
        np.asarray(idx.recon_norms), np.int32(n), k, DistanceMetric.L2,
        packed4=True, block_rows=128, exact_lut=False,
    )
    s1, i1 = sharded_pq_topk(
        replicate(q, mesh),
        shard_rows(np.asarray(idx.codes), mesh),
        jnp.asarray(idx.codebooks),
        shard_rows(np.asarray(idx.recon_norms), mesh),
        n, k, DistanceMetric.L2, mesh,
        block_rows=128, packed4=True,
    )
    np.testing.assert_array_equal(np.asarray(i0), np.asarray(i1))
    np.testing.assert_allclose(np.asarray(s0), np.asarray(s1), rtol=1e-6)
