"""Multi-host scaffolding exercised single-host on the virtual mesh:
per-device shard assembly via make_array_from_single_device_arrays must
produce the same global search results as plain sharding."""

import jax
import numpy as np
import pytest

from metrovector_tpu import Builder, DistanceMetric, Reader
from metrovector_tpu.ops import numpy_oracle
from metrovector_tpu.parallel import make_mesh
from metrovector_tpu.parallel.distributed import (
    DistributedSearcher,
    global_mesh,
    initialize,
    load_space_sharded,
)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 2, reason="needs a multi-device (virtual) platform"
)


@pytest.fixture
def space(tmp_path, rng):
    data = rng.standard_normal((900, 24)).astype(np.float32)
    b = Builder()
    b.add_vector_space("v", dim=24)
    b.add_vectors("v", data)
    b.delete_vector("v", 77)
    path = tmp_path / "d.mvt"
    b.build().save(path)
    return Reader.open(path).vector_space("v"), data


def test_initialize_noop_single_process():
    initialize()  # must not raise on a single-process run


def test_global_mesh_covers_all_devices():
    mesh = global_mesh()
    assert mesh.devices.size == len(jax.devices())


def test_load_space_sharded_layout(space):
    sp, data = space
    mesh = make_mesh(8)
    dat, norms, mask, rowsums, per = load_space_sharded(sp, mesh)
    assert rowsums is None  # f32 space: no uint8 offset transform
    assert dat.shape[0] == per * 8
    assert norms.shape == (per * 8,)
    assert mask is not None  # tombstones present
    # every shard placed on its own device
    assert len({s.device for s in dat.addressable_shards}) == 8
    # global content round-trips
    np.testing.assert_array_equal(np.asarray(dat)[:900, :24], data)


def test_distributed_searcher_matches_oracle(space, rng):
    sp, data = space
    searcher = DistributedSearcher(sp, make_mesh(8))
    queries = rng.standard_normal((5, 24)).astype(np.float32)
    res = searcher.search(queries, k=7)
    mask = np.ones(900, np.float32)
    mask[77] = 0
    _, oi = numpy_oracle(queries, data, 7, DistanceMetric.L2, valid_mask=mask)
    assert np.array_equal(res.indices, oi)
    assert 77 not in res.indices
