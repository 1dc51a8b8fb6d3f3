"""Online mutability: add/delete rows on a live DeviceSpace without
touching disk. Capacity-doubling keeps kernel shapes stable (appends
within capacity trigger no recompile); deletions are tombstones that can
never surface in results."""

import numpy as np
import pytest

from metrovector_tpu import Builder, Reader
from metrovector_tpu.engine import DeviceSpace, SearchEngine
from metrovector_tpu.errors import (
    IndexOutOfBoundsError,
    InvalidVectorTypeError,
)
from metrovector_tpu.format.constants import DataType, DistanceMetric
from metrovector_tpu.ops.distances import numpy_oracle


def _space(tmp_path, rng, n=40, d=8, ids=False, dtype=DataType.FLOAT32,
           metric=DistanceMetric.L2):
    data = rng.standard_normal((n, d)).astype(np.float32)
    if dtype == DataType.UINT8:
        data = rng.integers(0, 256, (n, d)).astype(np.float32)
    b = Builder()
    b.add_vector_space("e", dim=d, dtype=dtype, metric=metric)
    if dtype == DataType.UINT8:
        b._get_space("e").quantization = None  # auto-calibrate? use explicit
        b = Builder()
        b.add_vector_space(
            "e", dim=d, dtype=dtype, metric=metric
        ).with_quantization(scale=1.0, zero_point=0.0)
    if ids:
        b.add_vectors("e", data, ids=np.arange(n, dtype=np.uint64) * 2)
    else:
        b.add_vectors("e", data)
    p = tmp_path / "m.mvt"
    b.build().save(p)
    return Reader.open(p).vector_space("e"), data


def test_add_rows_then_search(tmp_path, rng):
    sp, data = _space(tmp_path, rng)
    dev = DeviceSpace.from_space(sp)
    new = rng.standard_normal((7, 8)).astype(np.float32)
    dev.add_rows(new)
    assert dev.num_valid == 47
    eng = SearchEngine(dev)
    allrows = np.concatenate([data, new])
    q = rng.standard_normal((5, 8)).astype(np.float32)
    res = eng.search(q, k=6)
    _, oi = numpy_oracle(q, allrows, 6, DistanceMetric.L2)
    assert np.array_equal(res.indices, oi)
    # appended rows are findable by their own vector
    res2 = eng.search(new[:1], k=1)
    assert res2.indices[0, 0] == 40


def test_add_rows_within_capacity_no_shape_change(tmp_path, rng):
    sp, data = _space(tmp_path, rng, n=40)
    dev = DeviceSpace.from_space(sp)
    cap0 = dev.padded_rows  # tile padding leaves headroom
    headroom = cap0 - dev.num_valid
    if headroom == 0:
        pytest.skip("no tile headroom at this shape")
    dev.add_rows(rng.standard_normal((headroom, 8)).astype(np.float32))
    assert dev.padded_rows == cap0  # no growth, no recompile
    dev.add_rows(rng.standard_normal((1, 8)).astype(np.float32))
    assert dev.padded_rows > cap0  # grew by the reserve factor


def test_add_rows_ids_discipline(tmp_path, rng):
    sp, data = _space(tmp_path, rng, ids=True)
    dev = DeviceSpace.from_space(sp)
    with pytest.raises(InvalidVectorTypeError):
        dev.add_rows(rng.standard_normal((2, 8)).astype(np.float32))
    with pytest.raises(InvalidVectorTypeError):  # colliding id
        dev.add_rows(
            rng.standard_normal((1, 8)).astype(np.float32),
            ids=np.asarray([0], np.uint64),
        )
    dev.add_rows(
        rng.standard_normal((2, 8)).astype(np.float32),
        ids=np.asarray([1001, 1003], np.uint64),
    )
    eng = SearchEngine(dev)
    res = eng.search(np.asarray(dev.data)[40:41, :8].astype(np.float32), k=1)
    assert res.ids[0, 0] == 1001

    sp2, _ = _space(tmp_path, rng)  # id-less space rejects ids
    dev2 = DeviceSpace.from_space(sp2)
    with pytest.raises(InvalidVectorTypeError):
        dev2.add_rows(
            rng.standard_normal((1, 8)).astype(np.float32),
            ids=np.asarray([5], np.uint64),
        )


def test_delete_rows_by_position_and_id(tmp_path, rng):
    sp, data = _space(tmp_path, rng, ids=True)
    dev = DeviceSpace.from_space(sp)
    dev.delete_rows(rows=[3])
    dev.delete_rows(ids=[10])  # id 10 == row 5 (ids are 2*i)
    eng = SearchEngine(dev)
    res = eng.search(data, k=2)
    assert not np.isin(res.indices, [3, 5]).any()
    mask = np.ones(40, np.float32)
    mask[[3, 5]] = 0
    _, oi = numpy_oracle(data, data, 2, DistanceMetric.L2, valid_mask=mask)
    assert np.array_equal(res.indices, oi)
    with pytest.raises(IndexOutOfBoundsError):
        dev.delete_rows(rows=[99])


def test_add_rows_uint8_quantized(tmp_path, rng):
    sp, data = _space(tmp_path, rng, dtype=DataType.UINT8)
    dev = DeviceSpace.from_space(sp)
    new = rng.integers(0, 256, (5, 8)).astype(np.float32)
    dev.add_rows(new)
    eng = SearchEngine(dev)
    allrows = np.concatenate([data, new])
    q = rng.integers(0, 256, (4, 8)).astype(np.float32)
    res = eng.search(q, k=5)
    _, oi = numpy_oracle(q, allrows, 5, DistanceMetric.L2)
    assert np.array_equal(res.indices, oi)


def test_add_rows_bf16_default_precision(tmp_path, rng):
    sp, data = _space(tmp_path, rng)
    dev = DeviceSpace.from_space(sp, precision="default")
    new = rng.standard_normal((3, 8)).astype(np.float32)
    dev.add_rows(new)
    eng = SearchEngine(dev)
    res = eng.search(new[:1], k=1)
    assert res.indices[0, 0] == 40


def test_pq_add_and_delete_rows(tmp_path, rng):
    from metrovector_tpu.index.pq import PQIndex

    data = rng.standard_normal((300, 16)).astype(np.float32)
    idx = PQIndex.build(
        data, DistanceMetric.L2, m=4, ksub=32, iters=4, keep_vectors=True
    )
    new = data[:20] + 0.01 * rng.standard_normal((20, 16)).astype(np.float32)
    idx.add_rows(new)
    assert idx.num_vectors == 320
    allrows = np.concatenate([data, new])
    q = new[:5]
    res = idx.search(q, k=3, rerank=60)
    _, oi = numpy_oracle(q, allrows, 3, DistanceMetric.L2)
    assert np.array_equal(res.indices, oi)
    # appended rows surface at the top for their own queries
    assert set(res.indices[:, 0]) <= set(range(300, 320)) | set(range(300))

    idx.delete_rows(range(300, 320))
    res2 = idx.search(q, k=3, rerank=60)
    assert not (np.asarray(res2.indices) >= 300).any()
    mask = np.ones(320, np.float32)
    mask[300:] = 0
    _, oi2 = numpy_oracle(q, allrows, 3, DistanceMetric.L2, valid_mask=mask)
    assert np.array_equal(res2.indices, oi2)
    with pytest.raises(Exception):
        idx.delete_rows([999])


def test_pq_add_rows_capacity_growth(tmp_path, rng):
    from metrovector_tpu.index.pq import PQIndex

    data = rng.standard_normal((256, 8)).astype(np.float32)
    idx = PQIndex.build(
        data, DistanceMetric.L2, m=4, ksub=16, iters=3, keep_vectors=False
    )
    cap0 = int(idx.codes.shape[0])
    idx.add_rows(rng.standard_normal((1, 8)).astype(np.float32))
    cap1 = int(idx.codes.shape[0])
    assert cap1 >= cap0 and idx.num_vectors == 257
    # second small append fits the grown capacity: shape unchanged
    idx.add_rows(rng.standard_normal((4, 8)).astype(np.float32))
    assert int(idx.codes.shape[0]) == cap1
    assert idx.num_vectors == 261


def test_ivfpq_add_and_delete_rows(tmp_path, rng):
    from metrovector_tpu.index.ivfpq import IVFPQIndex

    centers = rng.standard_normal((12, 16)).astype(np.float32) * 4
    data = centers[rng.integers(0, 12, 400)] + 0.3 * rng.standard_normal(
        (400, 16)
    ).astype(np.float32)
    idx = IVFPQIndex.build(
        data, DistanceMetric.L2, num_clusters=8, m=4, ksub=32, iters=4,
        keep_vectors=True,
    )
    new = centers[rng.integers(0, 12, 30)] + 0.3 * rng.standard_normal(
        (30, 16)
    ).astype(np.float32)
    idx.add_rows(new)
    assert idx.num_vectors == 430
    allrows = np.concatenate([data, new])
    q = new[:6] + 0.01 * rng.standard_normal((6, 16)).astype(np.float32)

    # probe and scan modes both see the appended rows and agree exactly
    # (the invariant; vs the float oracle IVF-PQ stays approximate at
    # finite rerank, so that comparison is a recall floor, not equality)
    npall = idx.num_buckets
    rp = idx.search(q, k=5, nprobe=npall, rerank=60, mode="probe")
    rs = idx.search(q, k=5, nprobe=npall, rerank=60, mode="scan",
                    exact_lut=True)
    np.testing.assert_array_equal(rp.indices, rs.indices)
    _, oi = numpy_oracle(q, allrows, 5, DistanceMetric.L2)
    overlap = np.mean([
        len(set(a) & set(b)) / 5 for a, b in zip(rp.indices, oi)
    ])
    assert overlap >= 0.9, overlap
    assert (rp.indices[:, 0] == oi[:, 0]).all()  # top hit exact

    # delete a mix of original and appended rows from both paths
    idx.delete_rows([10, 405])
    rp2 = idx.search(q, k=5, nprobe=npall, rerank=60, mode="probe")
    rs2 = idx.search(q, k=5, nprobe=npall, rerank=60, mode="scan",
                     exact_lut=True)
    assert not np.isin(rp2.indices, [10, 405]).any()
    np.testing.assert_array_equal(rp2.indices, rs2.indices)
    with pytest.raises(Exception):
        idx.delete_rows([430])


def test_delete_rows_unknown_id_typed_error(tmp_path, rng):
    from metrovector_tpu.errors import VectorIdNotFoundError

    sp, data = _space(tmp_path, rng, ids=True)
    dev = DeviceSpace.from_space(sp)
    with pytest.raises(VectorIdNotFoundError):
        dev.delete_rows(ids=[99999])
    # the error doubles as a KeyError for dict-style callers
    with pytest.raises(KeyError):
        dev.delete_rows(ids=[99999])


def test_ivfpq_mode_typo_rejected(rng):
    from metrovector_tpu.index.ivfpq import IVFPQIndex

    db = rng.standard_normal((200, 8)).astype(np.float32)
    idx = IVFPQIndex.build(
        db, DistanceMetric.L2, num_clusters=4, m=4, ksub=16, iters=2
    )
    with pytest.raises(ValueError):
        idx.search(db[:2], k=3, mode="Scan")


def test_hnsw_add_and_delete_rows(rng):
    from metrovector_tpu.index.hnsw import HNSWIndex

    centers = rng.standard_normal((8, 12)).astype(np.float32) * 5
    data = centers[rng.integers(0, 8, 300)] + 0.3 * rng.standard_normal(
        (300, 12)
    ).astype(np.float32)
    idx = HNSWIndex.build(data, DistanceMetric.L2, m=8, ef_construction=60)
    new = centers[rng.integers(0, 8, 40)] + 0.3 * rng.standard_normal(
        (40, 12)
    ).astype(np.float32)
    idx.add_rows(new)
    allrows = np.concatenate([data, new])
    assert idx.rows.shape[0] == 340

    # appended rows are reachable: querying an appended row finds itself
    i = idx.search(new[:10], k=1, ef=80).indices
    self_hits = (i[:, 0] >= 300).mean()
    assert self_hits >= 0.9, self_hits

    # recall after incremental insertion must match a from-scratch build
    # of the same corpus (the absolute number is data-dependent — tight
    # near-duplicate clusters are HNSW's known weak spot)
    q = allrows[rng.integers(0, 340, 20)]
    i = idx.search(q, k=5, ef=100).indices
    _, oi = numpy_oracle(q, allrows, 5, DistanceMetric.L2)
    recall = np.mean([len(set(a) & set(b)) / 5 for a, b in zip(i, oi)])
    full = HNSWIndex.build(
        allrows, DistanceMetric.L2, m=8, ef_construction=60
    )
    i_f = full.search(q, k=5, ef=100).indices
    recall_full = np.mean(
        [len(set(a) & set(b)) / 5 for a, b in zip(i_f, oi)]
    )
    assert recall >= recall_full - 0.05, (recall, recall_full)
    assert recall >= 0.6, recall

    idx.delete_rows([0, 320])
    i2 = idx.search(q, k=5, ef=100).indices
    assert not np.isin(i2, [0, 320]).any()
    with pytest.raises(Exception):
        idx.delete_rows([999])


def test_hnsw_add_to_empty_graph(rng):
    from metrovector_tpu.index.hnsw import HNSWIndex

    idx = HNSWIndex.build(
        np.zeros((0, 4), np.float32), DistanceMetric.L2, m=4
    )
    data = rng.standard_normal((30, 4)).astype(np.float32)
    idx.add_rows(data)
    i = idx.search(data[:5], k=1, ef=40).indices
    assert (i[:, 0] == np.arange(5)).all()


def test_hnsw_single_node_then_add(rng):
    """A 1-node graph must not be orphaned by add_rows (review finding
    r2: the edgeless entry froze to an empty layer and looked like an
    empty graph)."""
    from metrovector_tpu.index.hnsw import HNSWIndex

    v0 = rng.standard_normal((1, 4)).astype(np.float32)
    idx = HNSWIndex.build(v0, DistanceMetric.L2, m=4)
    idx.add_rows(rng.standard_normal((5, 4)).astype(np.float32))
    i = idx.search(v0, k=1, ef=20).indices
    assert i[0, 0] == 0  # the original node is reachable

    # empty append is a no-op, even on an empty-built index
    empty = HNSWIndex.build(np.zeros((0, 4), np.float32), DistanceMetric.L2)
    empty.add_rows(np.zeros((0, 4), np.float32))
    assert empty.rows.shape[0] == 0


def test_ivf_add_and_delete_rows(rng):
    from metrovector_tpu.index.ivf import IVFIndex
    from metrovector_tpu.ops import numpy_oracle

    data = rng.standard_normal((400, 16)).astype(np.float32)
    norms = (data.astype(np.float64) ** 2).sum(1).astype(np.float32)
    idx = IVFIndex.build(data, norms, DistanceMetric.L2, num_clusters=8)
    assert idx.num_vectors == 400

    new = rng.standard_normal((20, 16)).astype(np.float32)
    idx.add_rows(new)
    assert idx.num_vectors == 420
    allv = np.concatenate([data, new])

    # appended rows are findable and full-probe search stays oracle-exact
    res = idx.search(new[:3], k=1, nprobe=idx.num_buckets)
    assert res.indices[:, 0].tolist() == [400, 401, 402]
    q = rng.standard_normal((5, 16)).astype(np.float32)
    res = idx.search(q, k=10, nprobe=idx.num_buckets)
    _, oi = numpy_oracle(q, allv, 10, DistanceMetric.L2)
    assert np.array_equal(res.indices, oi)

    # deletes (by position) never surface again; ranks stay exact
    idx.delete_rows([0, 405])
    res = idx.search(allv[[0, 405]], k=1, nprobe=idx.num_buckets)
    assert 0 not in res.indices and 405 not in res.indices
    keep = np.ones(420, bool)
    keep[[0, 405]] = False
    _, oi = numpy_oracle(q, allv[keep], 10, DistanceMetric.L2)
    remap = np.arange(420)[keep]
    res = idx.search(q, k=10, nprobe=idx.num_buckets)
    assert np.array_equal(res.indices, remap[oi])

    with pytest.raises(IndexOutOfBoundsError):
        idx.delete_rows([420])


def test_ivf_delete_by_id(tmp_path, rng):
    from metrovector_tpu.index.ivf import IVFIndex
    from metrovector_tpu.errors import VectorIdNotFoundError

    data = rng.standard_normal((60, 8)).astype(np.float32)
    ids = np.arange(60, dtype=np.uint64) * 2
    b = Builder()
    b.add_vector_space("e", dim=8)
    b.add_vectors("e", data, ids=ids)
    p = tmp_path / "ivfid.mvt"
    b.build().save(p)
    sp = Reader.open(p).vector_space("e")
    idx = IVFIndex.from_space(sp, num_clusters=4)
    idx.delete_rows(ids=[10])  # id 10 == row 5
    res = idx.search(data[5:6], k=1, nprobe=idx.num_buckets)
    assert res.indices[0, 0] != 5
    with pytest.raises(VectorIdNotFoundError):
        idx.delete_rows(ids=[99999])


def test_ivf_append_overflow_allocates_buckets(rng):
    from metrovector_tpu.index.ivf import IVFIndex

    data = rng.standard_normal((64, 8)).astype(np.float32)
    norms = (data.astype(np.float64) ** 2).sum(1).astype(np.float32)
    idx = IVFIndex.build(data, norms, DistanceMetric.L2, num_clusters=4)
    nb0 = idx.num_buckets
    # force overflow: append far more rows than total remaining capacity
    cap_left = int(idx.bucket_rows * nb0 - idx.fill.sum())
    new = rng.standard_normal((cap_left + 30, 8)).astype(np.float32)
    idx.add_rows(new)
    assert idx.num_buckets > nb0
    assert idx.probe_centroids.shape[0] == idx.num_buckets
    assert len(idx.cells) == idx.num_buckets
    # all appended rows remain findable at full probe
    res = idx.search(new, k=1, nprobe=idx.num_buckets)
    assert (res.indices[:, 0] >= 64).all()


def test_ivfpq_incremental_append_no_layout_rebuild(rng):
    """Appends that fit capacity must not reallocate the bucket tensors
    (surgery, not rebuild) and must keep the scan/probe paths consistent."""
    from metrovector_tpu.index.ivfpq import IVFPQIndex

    data = rng.standard_normal((512, 16)).astype(np.float32)
    idx = IVFPQIndex.build(
        data, DistanceMetric.L2, num_clusters=4, m=4, ksub=16
    )
    nb0, fill0 = idx.num_buckets, idx.fill.sum()
    new = rng.standard_normal((8, 16)).astype(np.float32)
    idx.add_rows(new)
    assert idx.num_buckets == nb0  # no new buckets for a tiny append
    assert idx.fill.sum() == fill0 + 8
    assert idx.num_vectors == 520
    # both serving modes see the appended rows identically
    r_probe = idx.search(new[:2], k=3, nprobe=idx.num_buckets, mode="probe")
    r_scan = idx.search(new[:2], k=3, nprobe=idx.num_buckets, mode="scan")
    assert np.array_equal(r_probe.indices, r_scan.indices)
    assert r_probe.indices[0, 0] == 512

    # incremental delete drops the row from BOTH layouts
    idx.delete_rows([512])
    r_probe = idx.search(new[:1], k=3, nprobe=idx.num_buckets, mode="probe")
    r_scan = idx.search(new[:1], k=3, nprobe=idx.num_buckets, mode="scan")
    assert 512 not in r_probe.indices and 512 not in r_scan.indices

    # rebuild() compacts and preserves results
    before = idx.search(new[1:2], k=5, nprobe=idx.num_buckets, mode="probe")
    idx.rebuild()
    after = idx.search(new[1:2], k=5, nprobe=idx.num_buckets, mode="probe")
    assert np.array_equal(before.indices, after.indices)
