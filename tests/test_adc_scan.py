"""The ADC top-k scan (``index.pq.adc_topk``) behind PQ, IVF-PQ's masked
scan and sharded PQ: parity with a NumPy ADC over the same codes and with
the f64 reconstruction oracle, padding/tombstone masking, the bf16
one-hot form, per-block 4-bit unpacking and IVF-PQ's per-bucket bias."""

import jax.numpy as jnp
import numpy as np
import pytest

from metrovector_tpu.format.constants import DistanceMetric
from metrovector_tpu.index.pq import (
    adc_topk,
    encode_pq,
    pack_codes4,
    reconstruct_pq,
    train_pq,
    unpack_codes4,
    unpack_codes4_block,
)
from metrovector_tpu.ops import numpy_oracle

METRICS = [DistanceMetric.L2, DistanceMetric.COSINE, DistanceMetric.INNER_PRODUCT]


def _fixture(rng, n=700, d=16, m=4, ksub=16):
    data = rng.standard_normal((n, d)).astype(np.float32)
    books = train_pq(data, m=m, ksub=ksub, iters=4)
    codes = encode_pq(data, books)
    recon = reconstruct_pq(codes, books)
    rnorms = np.einsum(
        "ij,ij->i", recon.astype(np.float64), recon.astype(np.float64)
    ).astype(np.float32)
    return data, books, codes, recon, rnorms


def numpy_adc(q, codes, books, rnorms, k, metric):
    """Independent f64 ADC over the codes: Σ_j q_j·C[j, code_j] from a
    per-query LUT, the metric epilogue, lowest-index tie order."""
    m, ksub, dsub = books.shape
    qs = q.astype(np.float64).reshape(len(q), m, dsub)
    lut = np.einsum("qmd,mkd->qmk", qs, books.astype(np.float64))
    dots = lut[:, np.arange(m)[None, :], codes.astype(np.int64)].sum(-1)
    if metric == DistanceMetric.L2:
        s = 2 * dots - rnorms.astype(np.float64)[None]
    elif metric == DistanceMetric.COSINE:
        s = dots / np.sqrt(np.maximum(rnorms, 1e-30))[None]
    else:
        s = dots
    order = np.argsort(-s, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(s, order, 1), order


def _prep(q, metric):
    if metric == DistanceMetric.COSINE:
        return q / np.linalg.norm(q, axis=1, keepdims=True)
    return q


@pytest.mark.parametrize("metric", METRICS)
def test_adc_matches_reconstruction_oracle(rng, metric):
    """exact-LUT ranking == f64 brute force over x̂, bit-for-rank."""
    _, books, codes, recon, rnorms = _fixture(rng)
    q = rng.standard_normal((9, 16)).astype(np.float32)
    _, i = adc_topk(
        _prep(q, metric), codes, books, rnorms, len(codes), 10, metric,
        exact_lut=True, block_rows=256,
    )
    _, oi = numpy_oracle(q, recon, 10, metric)
    np.testing.assert_array_equal(np.asarray(i), oi)


@pytest.mark.parametrize("packed4", [False, True])
def test_adc_matches_numpy_adc(rng, packed4):
    """The scan equals an f64 NumPy ADC over the same codes: ids exact,
    scores to f32 rounding — 8-bit (ksub=256) and nibble-packed 4-bit."""
    ksub = 16 if packed4 else 256
    _, books, codes, _, rnorms = _fixture(rng, n=900, d=32, m=8, ksub=ksub)
    q = rng.standard_normal((6, 32)).astype(np.float32)
    dev = pack_codes4(codes) if packed4 else codes
    s, i = adc_topk(q, dev, books, rnorms, len(codes), 12, DistanceMetric.L2,
                    exact_lut=True, packed4=packed4, block_rows=200)
    os_, oi = numpy_adc(q, codes, books, rnorms, 12, DistanceMetric.L2)
    np.testing.assert_array_equal(np.asarray(i), oi)
    np.testing.assert_allclose(np.asarray(s), os_, rtol=1e-5, atol=1e-4)


def test_adc_masks_padding_and_tombstones(rng):
    data, books, codes, recon, rnorms = _fixture(rng, n=300)
    # declare only 200 rows valid + tombstone rows 3 and 7
    valid = np.ones(300, np.float32)
    valid[3] = valid[7] = 0.0
    q = rng.standard_normal((4, 16)).astype(np.float32)
    s, i = adc_topk(
        q, codes, books, rnorms, 200, 290, DistanceMetric.L2,
        valid_mask=valid, exact_lut=True, block_rows=128,
    )
    i = np.asarray(i)
    live = i[i >= 0]
    assert live.max() < 200
    assert 3 not in live and 7 not in live
    # exactly 198 live rows → the rest of the 290 slots are -1 sentinels
    assert (i >= 0).sum(axis=1).tolist() == [198] * 4


def test_adc_bf16_lut_close(rng):
    data, books, codes, recon, rnorms = _fixture(rng, n=600)
    q = rng.standard_normal((5, 16)).astype(np.float32)
    se, ie = adc_topk(q, codes, books, rnorms, 600, 10, DistanceMetric.L2,
                      exact_lut=True, block_rows=256)
    sb, ib = adc_topk(q, codes, books, rnorms, 600, 10, DistanceMetric.L2,
                      exact_lut=False, block_rows=256)
    overlap = np.mean(
        [len(set(np.asarray(ie)[r]) & set(np.asarray(ib)[r])) / 10
         for r in range(5)]
    )
    assert overlap >= 0.8
    np.testing.assert_allclose(np.asarray(sb), np.asarray(se), rtol=0.02,
                               atol=0.1)


def test_near_duplicate_collisions(rng):
    """Exact on near-duplicate corpora with dense score ties."""
    base = rng.standard_normal((50, 16)).astype(np.float32)
    data = np.concatenate([base + 1e-3 * rng.standard_normal((50, 16))
                           for _ in range(12)]).astype(np.float32)
    books = train_pq(data, m=4, ksub=16, iters=4)
    codes = encode_pq(data, books)
    recon = reconstruct_pq(codes, books)
    rnorms = np.einsum(
        "ij,ij->i", recon.astype(np.float64), recon.astype(np.float64)
    ).astype(np.float32)
    q = base[:6] + 0.01 * rng.standard_normal((6, 16)).astype(np.float32)
    _, i = adc_topk(q, codes, books, rnorms, len(data), 40,
                    DistanceMetric.L2, exact_lut=True, block_rows=128)
    _, oi = numpy_oracle(q, recon, 40, DistanceMetric.L2)
    np.testing.assert_array_equal(np.asarray(i), oi)


def test_adc_odd_sizes(rng):
    """Non-multiple-of-block row counts and a single query."""
    data, books, codes, recon, rnorms = _fixture(rng, n=333)
    q = rng.standard_normal((1, 16)).astype(np.float32)
    _, i = adc_topk(q, codes, books, rnorms, 333, 5, DistanceMetric.L2,
                    exact_lut=True, block_rows=128)
    _, oi = numpy_oracle(q, recon, 5, DistanceMetric.L2)
    np.testing.assert_array_equal(np.asarray(i), oi)


@pytest.mark.parametrize("block_rows", [64, 250, None])
def test_adc_block_rows_independent(rng, block_rows):
    """Results do not depend on the scan tile (ragged tails included)."""
    data, books, codes, recon, rnorms = _fixture(rng, n=700)
    q = rng.standard_normal((3, 16)).astype(np.float32)
    s0, i0 = adc_topk(q, codes, books, rnorms, 700, 9, DistanceMetric.L2,
                      block_rows=700)
    s1, i1 = adc_topk(q, codes, books, rnorms, 700, 9, DistanceMetric.L2,
                      block_rows=block_rows)
    np.testing.assert_array_equal(np.asarray(i0), np.asarray(i1))
    np.testing.assert_allclose(np.asarray(s0), np.asarray(s1), rtol=1e-6)


@pytest.mark.parametrize("m", [4, 5])
def test_packed4_matches_unpacked(rng, m):
    """Nibble-packed 4-bit codes (packed4=True) must rank identically to
    the same codes unpacked, including odd m (padded high nibble) and a
    ragged tail block."""
    n, dsub = 700, 4
    d = m * dsub
    data = rng.standard_normal((n, d)).astype(np.float32)
    books = train_pq(data, m=m, ksub=16, iters=4)
    codes = encode_pq(data, books)
    assert codes.max() < 16
    packed = pack_codes4(codes)
    assert packed.shape == (n, (m + 1) // 2)
    np.testing.assert_array_equal(unpack_codes4(packed, m), codes)
    recon = reconstruct_pq(codes, books)
    rnorms = np.einsum(
        "ij,ij->i", recon.astype(np.float64), recon.astype(np.float64)
    ).astype(np.float32)
    q = rng.standard_normal((6, d)).astype(np.float32)
    s0, i0 = adc_topk(q, codes, books, rnorms, n, 10, DistanceMetric.L2,
                      exact_lut=True, block_rows=256)
    s1, i1 = adc_topk(q, packed, books, rnorms, n, 10, DistanceMetric.L2,
                      exact_lut=True, block_rows=256, packed4=True)
    np.testing.assert_array_equal(np.asarray(i0), np.asarray(i1))
    np.testing.assert_array_equal(np.asarray(s0), np.asarray(s1))
    _, oi = numpy_oracle(q, recon, 10, DistanceMetric.L2)
    np.testing.assert_array_equal(np.asarray(i1), oi)


@pytest.mark.parametrize("m", [3, 8, 7])
def test_unpack_codes4_block_matches_host(rng, m):
    """The in-scan nibble unpack of one block equals the host unpack."""
    codes = rng.integers(0, 16, (37, m)).astype(np.uint8)
    packed = pack_codes4(codes)
    got = np.asarray(unpack_codes4_block(jnp.asarray(packed), m))
    assert got.dtype == np.int32 and got.shape == (37, m)
    np.testing.assert_array_equal(got, codes)


def test_packed4_rejects_wide_ksub(rng):
    data, books, codes, recon, rnorms = _fixture(rng, ksub=32)
    q = rng.standard_normal((2, 16)).astype(np.float32)
    with pytest.raises(ValueError, match="ksub"):
        adc_topk(q, codes[:, :2], books, rnorms, len(codes), 5,
                 DistanceMetric.L2, packed4=True)


def test_code_width_mismatch_rejected(rng):
    data, books, codes, recon, rnorms = _fixture(rng, ksub=16)
    q = rng.standard_normal((2, 16)).astype(np.float32)
    with pytest.raises(ValueError, match="do not match"):
        adc_topk(q, codes, books, rnorms, len(codes), 5, DistanceMetric.L2,
                 packed4=True)  # [N, m] bytes are not [N, m/2] nibbles


@pytest.mark.parametrize("exact_lut", [True, False])
def test_group_bias_semantics(rng, exact_lut):
    """IVF-PQ's probing input: row n adds ``group_bias[q, group_ids[n]]``
    in f32; −inf buckets and negative group ids never surface; scores of
    surviving rows are the plain ADC scores plus their bucket's bias."""
    data, books, codes, recon, rnorms = _fixture(rng, n=400)
    q = rng.standard_normal((3, 16)).astype(np.float32)
    groups = rng.integers(0, 5, 400).astype(np.int32)
    groups[[0, 1, 2]] = -1  # tombstoned / unbucketed rows
    bias = rng.standard_normal((3, 5)).astype(np.float32) * 1e4
    bias[:, 2] = -np.inf  # bucket 2 not probed by anyone
    s, i = adc_topk(q, codes, books, rnorms, 400, 30, DistanceMetric.INNER_PRODUCT,
                    exact_lut=exact_lut, group_bias=bias, group_ids=groups,
                    block_rows=128)
    s, i = np.asarray(s), np.asarray(i)
    assert (groups[i] != 2).all() and not np.isin(i, [0, 1, 2]).any()
    # reference: plain ADC dots (host f64 LUT) + bias, masked
    dots = numpy_adc(q, codes, books, rnorms, 400,
                     DistanceMetric.INNER_PRODUCT)
    full = np.full((3, 400), -np.inf)
    np.put_along_axis(full, dots[1], dots[0], 1)
    ok = groups >= 0
    ref = np.where(ok[None], full + bias[:, np.maximum(groups, 0)], -np.inf)
    got = np.take_along_axis(ref, i, 1)
    rtol = 1e-6 if exact_lut else 1e-3
    np.testing.assert_allclose(s, got, rtol=rtol, atol=1e-2)


@pytest.mark.parametrize("metric", METRICS)
def test_ivfpq_scan_bias_matches_host(rng, metric):
    """IVF-PQ scan mode (the XLA per-bucket bias) ranks exactly like a
    host computation of q·c + q·r̂ over the probed buckets."""
    from metrovector_tpu.index.ivfpq import IVFPQIndex

    n, d = 600, 16
    centers = rng.standard_normal((6, d)).astype(np.float32) * 4
    db = centers[rng.integers(0, 6, n)] + 0.3 * rng.standard_normal(
        (n, d)
    ).astype(np.float32)
    idx = IVFPQIndex.build(db, metric, num_clusters=6, m=4, ksub=16, iters=3)
    q = db[:4] + 0.05 * rng.standard_normal((4, d)).astype(np.float32)
    res = idx.search(q, k=8, nprobe=2, mode="scan", exact_lut=True)
    # host reference over every bucketed row
    qn = _prep(q, metric).astype(np.float64)
    pc = np.asarray(idx.probe_centroids, np.float64)
    cdots = qn @ pc.T
    cn = (pc ** 2).sum(1)
    if metric == DistanceMetric.L2:
        cs = 2 * cdots - cn[None]
    elif metric == DistanceMetric.COSINE:
        cs = cdots / np.sqrt(np.maximum(cn, 1e-30))[None]
    else:
        cs = cdots
    probed = cs >= np.sort(cs, axis=1)[:, -2][:, None]
    books = np.asarray(idx.codebooks)
    codes = np.asarray(idx.codes_row)[:n]
    rnorms = np.asarray(idx.rnorms_row)[:n].astype(np.float64)
    rb = np.asarray(idx.row_bucket)[:n]
    m, ksub, dsub = books.shape
    lut = np.einsum("qmd,mkd->qmk", qn.reshape(4, m, dsub), books)
    rdots = lut[:, np.arange(m)[None, :], codes.astype(np.int64)].sum(-1)
    dots = rdots + cdots[:, np.maximum(rb, 0)]
    if metric == DistanceMetric.L2:
        s = 2 * dots - rnorms[None]
    elif metric == DistanceMetric.COSINE:
        s = dots / np.sqrt(np.maximum(rnorms, 1e-30))[None]
    else:
        s = dots
    live = (rb >= 0)[None] & np.take_along_axis(
        probed, np.maximum(rb, 0)[None].repeat(4, 0), 1
    )
    s = np.where(live, s, -np.inf)
    oi = np.argsort(-s, axis=1, kind="stable")[:, :8]
    np.testing.assert_array_equal(res.indices, oi)
