"""Metadata filters on the multi-chip and streamed search surfaces.

Same contract as the single-chip engine's ``filter_mask``
(``SearchEngine.search``): exact masked-oracle results, tombstone
composition, prepared-filter reuse — here across the mesh-sharded
resident path (``ShardedDeviceSpace``), host→device streaming
(``StreamingSearcher``) and sharded streaming
(``ShardedStreamingSearcher``). Runs on the virtual 8-device CPU mesh
(SURVEY.md §4 fake-mesh strategy)."""

import jax
import numpy as np
import pytest

from metrovector_tpu import Builder, DistanceMetric, Reader
from metrovector_tpu.engine import SearchEngine
from metrovector_tpu.errors import DimensionMismatchError
from metrovector_tpu.ops import numpy_oracle
from metrovector_tpu.parallel import (
    ShardedDeviceSpace,
    ShardedStreamingSearcher,
    StreamingSearcher,
    make_mesh,
)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 2, reason="needs a multi-device (virtual) platform"
)


@pytest.fixture
def space_file(tmp_path, rng):
    data = rng.standard_normal((600, 32)).astype(np.float32)
    b = Builder()
    b.add_vector_space("v", dim=32)
    b.add_vectors("v", data)
    b.delete_vector("v", 7)  # tombstone, must compose with user filters
    path = tmp_path / "f.mvt"
    b.build().save(path)
    return Reader.open(path).vector_space("v"), data


def _mask(rng, n, sel=0.5):
    m = rng.random(n) < sel
    m[:2] = [True, False]
    m[7] = True  # predicate passes the tombstoned row: tombstone must win
    return m


@pytest.mark.parametrize("ndev", [8, 2])
def test_sharded_space_filter_matches_masked_oracle(space_file, rng, ndev):
    sp, data = space_file
    ds = ShardedDeviceSpace(sp, make_mesh(ndev))
    queries = data[[7, 20, 100]]
    mask = _mask(rng, 600)
    res = ds.search(queries, k=6, filter_mask=mask)
    omask = mask.astype(np.float32).copy()
    omask[7] = 0.0  # tombstone composes
    _, oi = numpy_oracle(queries, data, 6, DistanceMetric.L2,
                         valid_mask=omask)
    assert np.array_equal(res.indices, oi)
    assert 7 not in res.indices


def test_sharded_space_prepared_filter_and_shape_error(space_file, rng):
    sp, data = space_file
    ds = ShardedDeviceSpace(sp, make_mesh(4))
    mask = _mask(rng, 600, sel=0.3)
    prep = ds.prepare_filter(mask)
    raw = ds.search(data[:3], k=5, filter_mask=mask)
    via_prep = ds.search(data[:3], k=5, filter_mask=prep)
    assert np.array_equal(raw.indices, via_prep.indices)
    with pytest.raises(DimensionMismatchError):
        ds.search(data[:1], k=3,
                  filter_mask=np.ones(599, bool))
    with pytest.raises(DimensionMismatchError):
        ds.prepare_filter(np.ones(601, bool))


@pytest.mark.parametrize("chunk_rows", [128, 512])
def test_streaming_filter_matches_filtered_resident(space_file, rng,
                                                    chunk_rows):
    sp, data = space_file
    queries = rng.standard_normal((3, 32)).astype(np.float32)
    mask = _mask(rng, 600)
    streamed = StreamingSearcher(sp, chunk_rows=chunk_rows).search(
        queries, k=8, filter_mask=mask
    )
    resident = SearchEngine(sp).search(
        queries, k=8, filter_mask=mask
    )
    assert np.array_equal(streamed.indices, resident.indices)
    assert 7 not in streamed.indices


def test_streaming_filter_shape_error(space_file):
    sp, data = space_file
    with pytest.raises(DimensionMismatchError):
        StreamingSearcher(sp, chunk_rows=256).search(
            data[:1], k=3, filter_mask=np.ones(599, bool)
        )


def test_sharded_streaming_filter_matches_resident_sharded(space_file, rng):
    sp, data = space_file
    mesh = make_mesh(4)
    queries = rng.standard_normal((3, 32)).astype(np.float32)
    mask = _mask(rng, 600)
    streamed = ShardedStreamingSearcher(
        sp, mesh=mesh, chunk_rows=64
    ).search(queries, k=8, filter_mask=mask)
    resident = ShardedDeviceSpace(sp, mesh).search(
        queries, k=8, filter_mask=mask
    )
    assert np.array_equal(streamed.indices, resident.indices)
    omask = mask.astype(np.float32).copy()
    omask[7] = 0.0
    _, oi = numpy_oracle(queries, data, 8, DistanceMetric.L2,
                         valid_mask=omask)
    assert np.array_equal(streamed.indices, oi)


def test_filter_fewer_than_k_passing_rows(space_file, rng):
    """Sentinel tail when the predicate passes fewer than k rows —
    uniform across sharded and streamed surfaces."""
    sp, data = space_file
    mask = np.zeros(600, bool)
    mask[[3, 9]] = True
    ds = ShardedDeviceSpace(sp, make_mesh(2))
    res = ds.search(data[:1], k=5, filter_mask=mask)
    assert set(res.indices[0][:2].tolist()) == {3, 9}
    assert (res.indices[0][2:] == -1).all()
    streamed = StreamingSearcher(sp, chunk_rows=200).search(
        data[:1], k=5, filter_mask=mask
    )
    assert np.array_equal(streamed.indices, res.indices)
