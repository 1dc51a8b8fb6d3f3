"""What only the GPU compiler decides: how the scan's dots lower, whether
'highest' stays out of TF32, the TopK tie order, and how far tensor-core
accumulation moves the 'high' dots. Marked ``gpu``: each test skips
unless JAX's default backend is a GPU (``chip_smoke.py`` runs them on the
card)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from metrovector_tpu import DistanceMetric
from metrovector_tpu.ops import exact_topk
from metrovector_tpu.ops.distances import block_dots

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("d", [96, 128])
def test_int8_dot_lowers_to_a_gemm(gpu, d):
    """The int8 dot with int32 accumulation is a GEMM (cuBLAS or a GEMM
    fusion), not an elementwise loop fusion."""
    q = jnp.zeros((256, d), jnp.int8)
    x = jnp.zeros((16384, d), jnp.int8)
    hlo = jax.jit(lambda a, b: block_dots(a, b)).lower(q, x).compile().as_text()
    assert "__cublas$gemm" in hlo or "gemm_fusion" in hlo, hlo[:2000]


def test_highest_is_exact_on_integer_data(gpu, rng):
    """'highest' keeps every f32 operand bit: corpus values carry 14
    significant bits (a TF32 dot keeps 11), and every exact dot fits f32,
    so scores must equal the f64 ones bit for bit."""
    n, d = 20000, 32
    db = (rng.integers(0, 16, (n, d))
          + rng.integers(0, 1024, (n, d)) / 1024.0).astype(np.float32)
    q = rng.integers(0, 16, (16, d)).astype(np.float32)
    s, i = exact_topk(q, db, np.zeros(n, np.float32), n, 10,
                      DistanceMetric.INNER_PRODUCT, block_rows=4096)
    want = q.astype(np.float64) @ db.astype(np.float64).T
    oi = np.argsort(-want, axis=1, kind="stable")[:, :10]
    np.testing.assert_array_equal(np.asarray(i), oi)
    np.testing.assert_array_equal(
        np.asarray(s, np.float64), np.take_along_axis(want, oi, 1)
    )


def test_topk_keeps_lowest_index_on_ties(gpu):
    """Equal scores: the lowest row index wins, within a block and across
    blocks."""
    db = np.ones((50000, 16), np.float32)
    norms = np.full(50000, 16.0, np.float32)
    q = np.ones((8, 16), np.float32)
    for br in (50000, 4096):
        _, i = exact_topk(q, db, norms, 50000, 32, DistanceMetric.L2,
                          block_rows=br)
        assert (np.asarray(i) == np.arange(32)).all(), br


def test_high_error_within_certificate(gpu, rng):
    """|'high' − exact| stays inside C(D)·‖q‖‖x‖ with C(D) = 2⁻¹⁴ + D·2⁻²²
    (the high_verified certificate) at GIST width, and 'highest' stays
    inside D·2⁻²³."""
    d = 960
    q = rng.standard_normal((64, d)).astype(np.float32)
    x = rng.standard_normal((8192, d)).astype(np.float32)
    ref = q.astype(np.float64) @ x.astype(np.float64).T
    scale = np.outer(np.linalg.norm(q, axis=1), np.linalg.norm(x, axis=1))
    high = np.asarray(jax.jit(lambda a, b: block_dots(a, b, "high"))(q, x))
    hi = np.asarray(jax.jit(lambda a, b: block_dots(a, b, "highest"))(q, x))
    c_d = 2.0 ** -14 + d * 2.0 ** -22
    assert (np.abs(high - ref) <= c_d * scale).all()
    assert (np.abs(hi - ref) <= d * 2.0 ** -23 * scale).all()


def test_verified_high_matches_highest_on_gpu(gpu, tmp_path, rng):
    from metrovector_tpu import Builder, SearchEngine

    data = rng.standard_normal((30000, 256)).astype(np.float32)
    b = Builder()
    b.add_vector_space("v", dim=256, metric=DistanceMetric.COSINE)
    b.add_vectors("v", data)
    path = tmp_path / "v.mvt"
    b.build().save(path)
    q = rng.standard_normal((32, 256)).astype(np.float32)
    ver = SearchEngine.open(path, precision="high_verified")
    hi = SearchEngine.open(path, precision="highest")
    np.testing.assert_array_equal(
        ver.search(q, k=10).indices, hi.search(q, k=10).indices
    )
    assert ver.verify_stats["certified"] + ver.verify_stats["fallbacks"] == 32
