"""Streamed search must be bit-identical to fully-resident search regardless
of chunk size or chunk-boundary alignment (SURVEY.md §7 'deterministic
results independent of block arrival order')."""

import numpy as np
import pytest

from metrovector_tpu import Builder, DataType, DistanceMetric, Reader
from metrovector_tpu.engine import SearchEngine
from metrovector_tpu.ops import numpy_oracle
from metrovector_tpu.parallel import StreamingSearcher


@pytest.fixture
def big_space(tmp_path, rng):
    data = rng.standard_normal((2000, 32)).astype(np.float32)
    b = Builder()
    b.add_vector_space("v", dim=32)
    b.add_vectors("v", data)
    b.delete_vector("v", 1234)
    path = tmp_path / "big.mvt"
    b.build().save(path)
    return Reader.open(path).vector_space("v"), data


@pytest.mark.parametrize("chunk_rows", [256, 512, 1000])
def test_streaming_matches_resident(big_space, rng, chunk_rows):
    sp, data = big_space
    queries = rng.standard_normal((4, 32)).astype(np.float32)
    res_stream = StreamingSearcher(sp, chunk_rows=chunk_rows).search(queries, k=12)
    res_resident = SearchEngine(sp).search(queries, k=12)
    assert np.array_equal(res_stream.indices, res_resident.indices)
    # chunk and resident scans may tile the dot differently (last-ulp)
    np.testing.assert_allclose(
        res_stream.scores, res_resident.scores, rtol=1e-5, atol=1e-5
    )


def test_streaming_oracle_parity_with_tombstone(big_space, rng):
    sp, data = big_space
    queries = data[[1234, 7]]  # deleted row queried directly
    res = StreamingSearcher(sp, chunk_rows=512).search(queries, k=5)
    assert 1234 not in res.indices
    mask = np.ones(2000, np.float32)
    mask[1234] = 0
    _, oi = numpy_oracle(queries, data, 5, DistanceMetric.L2, valid_mask=mask)
    assert np.array_equal(res.indices, oi)


def test_streaming_k_exceeds_corpus(tmp_path, rng):
    data = rng.standard_normal((5, 8)).astype(np.float32)
    b = Builder()
    b.add_vector_space("v", dim=8)
    b.add_vectors("v", data)
    path = tmp_path / "tiny.mvt"
    b.build().save(path)
    sp = Reader.open(path).vector_space("v")
    res = StreamingSearcher(sp, chunk_rows=256).search(data[:2], k=9)
    assert res.indices.shape == (2, 9)
    assert (res.indices[:, 5:] == -1).all()
    assert res.indices[0, 0] == 0 and res.indices[1, 0] == 1


def test_streaming_int8(tmp_path, rng):
    x = rng.standard_normal((600, 16)).astype(np.float32)
    b = Builder()
    b.add_vector_space("q", dim=16, dtype=DataType.INT8,
                       metric=DistanceMetric.INNER_PRODUCT)
    b.add_vectors("q", x)
    path = tmp_path / "q.mvt"
    b.build().save(path)
    sp = Reader.open(path).vector_space("q")
    queries = rng.standard_normal((3, 16)).astype(np.float32)
    res_stream = StreamingSearcher(sp, chunk_rows=128).search(queries, k=8)
    res_resident = SearchEngine(sp).search(queries, k=8)
    assert np.array_equal(res_stream.indices, res_resident.indices)


# ------------------------------------------- multi-chip streamed search ---


def _mesh8():
    from metrovector_tpu.parallel import make_mesh

    return make_mesh(8)


def test_sharded_streaming_matches_resident_sharded(big_space, rng):
    """BASELINE '100M×768 f16 streamed + all-gather merge' config, scaled down:
    streamed-per-shard results must be bit-identical to the resident
    sharded search AND to the f64 oracle's ranks."""
    from metrovector_tpu.parallel import (
        ShardedDeviceSpace,
        ShardedStreamingSearcher,
    )

    sp, data = big_space
    mesh = _mesh8()
    queries = rng.standard_normal((4, 32)).astype(np.float32)
    res_stream = ShardedStreamingSearcher(
        sp, mesh=mesh, chunk_rows=64
    ).search(queries, k=12)
    res_resident = ShardedDeviceSpace(sp, mesh).search(
        queries, k=12
    )
    np.testing.assert_array_equal(res_stream.indices, res_resident.indices)
    np.testing.assert_array_equal(res_stream.scores, res_resident.scores)
    keep = np.ones(2000, bool)
    keep[1234] = False  # the fixture's tombstone
    _, oi = numpy_oracle(queries, np.where(keep[:, None], data, np.nan), 12,
                         DistanceMetric.L2)
    np.testing.assert_array_equal(res_stream.indices, oi)


@pytest.mark.parametrize("chunk_rows", [64, 96, 256])
def test_sharded_streaming_chunk_size_invariant(big_space, rng, chunk_rows):
    from metrovector_tpu.parallel import ShardedStreamingSearcher

    sp, _ = big_space
    queries = rng.standard_normal((3, 32)).astype(np.float32)
    res = ShardedStreamingSearcher(
        sp, mesh=_mesh8(), chunk_rows=chunk_rows
    ).search(queries, k=7)
    base = ShardedStreamingSearcher(
        sp, mesh=_mesh8(), chunk_rows=512
    ).search(queries, k=7)
    np.testing.assert_array_equal(res.indices, base.indices)


def test_sharded_streaming_bf16_storage(tmp_path, rng):
    """bf16-stored corpus streams at half the f32 upload bytes with no
    host-side conversion; ranks must match the bf16-resident engine."""
    data = rng.standard_normal((1024, 16)).astype(np.float32)
    b = Builder()
    b.add_vector_space("v", dim=16, dtype=DataType.BFLOAT16)
    b.add_vectors("v", data)
    p = tmp_path / "bf16.mvt"
    b.build().save(p)
    sp = Reader.open(p).vector_space("v")
    from metrovector_tpu.parallel import ShardedStreamingSearcher

    q = rng.standard_normal((3, 16)).astype(np.float32)
    res = ShardedStreamingSearcher(
        sp, mesh=_mesh8(), chunk_rows=128
    ).search(q, k=5)
    res_resident = SearchEngine(sp).search(q, k=5)
    np.testing.assert_array_equal(res.indices, res_resident.indices)


def test_sharded_streaming_uint8_offset(tmp_path, rng):
    data = rng.integers(0, 255, (640, 8)).astype(np.float32)
    b = Builder()
    b.add_vector_space("v", dim=8, dtype=DataType.UINT8)
    b.add_vectors("v", data)
    p = tmp_path / "u8.mvt"
    b.build().save(p)
    sp = Reader.open(p).vector_space("v")
    from metrovector_tpu.parallel import ShardedStreamingSearcher

    q = rng.integers(-20, 20, (3, 8)).astype(np.float32)
    res = ShardedStreamingSearcher(
        sp, mesh=_mesh8(), chunk_rows=64,
    ).search(q, k=6)
    res_resident = SearchEngine(sp).search(q, k=6)
    np.testing.assert_array_equal(res.indices, res_resident.indices)
    np.testing.assert_allclose(
        res.scores, res_resident.scores, rtol=1e-5, atol=1e-3
    )


def test_sharded_streaming_ids_and_small_corpus(tmp_path, rng):
    data = rng.standard_normal((40, 8)).astype(np.float32)
    ids = np.arange(40, dtype=np.uint64) * 5 + 3
    b = Builder()
    b.add_vector_space("v", dim=8)
    b.add_vectors("v", data, ids=ids)
    p = tmp_path / "tiny.mvt"
    b.build().save(p)
    sp = Reader.open(p).vector_space("v")
    from metrovector_tpu.parallel import ShardedStreamingSearcher

    res = ShardedStreamingSearcher(
        sp, mesh=_mesh8(), chunk_rows=8
    ).search(data[:2], k=50)  # k > corpus: sentinel tail
    assert (res.indices[:, 0] == [0, 1]).all()
    valid = res.indices >= 0
    assert np.array_equal(res.ids[valid], ids[res.indices[valid]])
    from metrovector_tpu.engine import SearchResult

    assert (res.ids[~valid] == SearchResult.ID_SENTINEL).all()


@pytest.mark.parametrize("dtype,metric", [
    (DataType.FLOAT16, DistanceMetric.L2),
    (DataType.UINT8, DistanceMetric.L2),       # offset-int8 path
    (DataType.UINT8, DistanceMetric.COSINE),   # host-dequant path
])
def test_streaming_native_prep_matches_fallback(tmp_path, rng, monkeypatch,
                                                dtype, metric):
    """The fused native chunk prep (codec.cpp mvt_prep_*) and the numpy
    twins must produce identical streamed results on every transform path
    — padding chunk, tombstone tail and stripped pad columns included."""
    from metrovector_tpu import native

    data = (
        rng.standard_normal((900, 20)).astype(np.float16).astype(np.float32)
        if dtype == DataType.FLOAT16
        else rng.integers(0, 256, (900, 20)).astype(np.float32)
    )
    b = Builder()
    b.add_vector_space("v", dim=20, dtype=dtype, metric=metric)
    b.add_vectors("v", data)
    b.delete_vector("v", 875)
    path = tmp_path / f"np_{int(dtype)}_{int(metric)}.mvt"
    b.build().save(path)
    sp = Reader.open(path).vector_space("v")
    queries = rng.standard_normal((3, 20)).astype(np.float32)

    res_native = StreamingSearcher(sp, chunk_rows=256).search(queries, k=7)
    monkeypatch.setattr(native, "prep_f16_to_f32", lambda *a, **k: None)
    monkeypatch.setattr(native, "prep_u8_dequant", lambda *a, **k: None)
    monkeypatch.setattr(native, "prep_u8_offset", lambda *a, **k: None)
    res_numpy = StreamingSearcher(sp, chunk_rows=256).search(queries, k=7)

    assert np.array_equal(res_native.indices, res_numpy.indices)
    assert np.array_equal(res_native.scores, res_numpy.scores)
    res_resident = SearchEngine(sp).search(queries, k=7)
    assert np.array_equal(res_native.indices, res_resident.indices)
