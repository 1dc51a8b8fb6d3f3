"""Multi-chip sharded search on the virtual 8-device CPU mesh: the global
top-k over row-sharded corpora must equal the single-device answer exactly
(SURVEY.md §4 'multi-chip paths testable single-host via fake-mesh')."""

import jax
import numpy as np
import pytest

from metrovector_tpu import Builder, DistanceMetric, Reader
from metrovector_tpu.ops import numpy_oracle
from metrovector_tpu.parallel import (
    ShardedDeviceSpace,
    make_mesh,
    replicate,
    shard_rows,
    sharded_topk,
)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 2, reason="needs a multi-device (virtual) platform"
)


def _case(rng, n=1000, d=32, q=6):
    db = rng.standard_normal((n, d)).astype(np.float32)
    queries = rng.standard_normal((q, d)).astype(np.float32)
    norms = (db.astype(np.float64) ** 2).sum(1).astype(np.float32)
    return queries, db, norms


@pytest.mark.parametrize("metric", [DistanceMetric.L2, DistanceMetric.INNER_PRODUCT])
@pytest.mark.parametrize(
    "ndev,block_rows", [(2, None), (8, None), (4, 64)],
    ids=["2", "8", "4-block64"],
)
def test_sharded_matches_oracle(rng, metric, ndev, block_rows):
    """``block_rows=64`` scans each 256-row shard in four blocks."""
    queries, db, norms = _case(rng)
    mesh = make_mesh(ndev)
    db_s = shard_rows(db, mesh)
    norms_s = shard_rows(norms, mesh)
    q_r = replicate(queries, mesh)
    s, i = sharded_topk(
        q_r, db_s, norms_s, db.shape[0], 10, metric, mesh,
        block_rows=block_rows,
    )
    _, oi = numpy_oracle(queries, db, 10, metric)
    assert np.array_equal(np.asarray(i), oi)


def test_sharded_uneven_rows(rng):
    """Row count not divisible by the mesh: trailing shard is mostly padding
    and its fake rows must never appear in results."""
    queries, db, norms = _case(rng, n=777, q=4)
    mesh = make_mesh(8)
    s, i = sharded_topk(
        replicate(queries, mesh),
        shard_rows(db, mesh),
        shard_rows(norms, mesh),
        777, 10, DistanceMetric.L2, mesh,
    )
    i = np.asarray(i)
    assert i.max() < 777
    _, oi = numpy_oracle(queries, db, 10, DistanceMetric.L2)
    assert np.array_equal(i, oi)


def test_sharded_device_space_end_to_end(tmp_path, rng):
    data = rng.standard_normal((300, 24)).astype(np.float32)
    b = Builder()
    b.add_vector_space("v", dim=24)
    b.add_vectors("v", data)
    b.delete_vector("v", 5)
    path = tmp_path / "s.mvt"
    b.build().save(path)

    sp = Reader.open(path).vector_space("v")
    mesh = make_mesh(8)
    ds = ShardedDeviceSpace(sp, mesh)
    queries = data[[5, 17, 200]]
    res = ds.search(queries, k=4)
    # deleted row 5 is excluded even when queried by itself
    assert 5 not in res.indices
    assert res.indices[1, 0] == 17 and res.indices[2, 0] == 200
    mask = np.ones(300, np.float32)
    mask[5] = 0
    _, oi = numpy_oracle(queries, data, 4, DistanceMetric.L2, valid_mask=mask)
    assert np.array_equal(res.indices, oi)


def test_shard_placement(rng):
    """Data really is distributed: each device holds 1/ndev of the rows."""
    _, db, _ = _case(rng, n=800)
    mesh = make_mesh(8)
    db_s = shard_rows(db, mesh)
    shard_shapes = {tuple(s.data.shape) for s in db_s.addressable_shards}
    # 800/8 = 100 rows/shard, rounded up to the 8-row sublane tile → 104
    assert shard_shapes == {(104, 32)}


def test_dim_sharded_matches_oracle(rng):
    """Dimension-sharded ("tensor parallel") search: partial dots complete
    via psum over the mesh; exact global results."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from metrovector_tpu.parallel.sharded_search import dim_sharded_topk

    queries, db, norms = _case(rng, n=300, d=512, q=4)
    mesh = make_mesh(8)
    put = lambda a: jax.device_put(a, NamedSharding(mesh, P(None, "shard")))
    s, i = dim_sharded_topk(
        put(queries), put(db), replicate(norms, mesh), 300, 7,
        DistanceMetric.L2, mesh,
    )
    _, oi = numpy_oracle(queries, db, 7, DistanceMetric.L2)
    assert np.array_equal(np.asarray(i), oi)


def test_dim_sharded_tombstones(rng):
    from jax.sharding import NamedSharding, PartitionSpec as P

    from metrovector_tpu.parallel.sharded_search import dim_sharded_topk

    queries, db, norms = _case(rng, n=200, d=256, q=2)
    mesh = make_mesh(4)
    put = lambda a: jax.device_put(a, NamedSharding(mesh, P(None, "shard")))
    mask = np.ones(200, np.float32)
    _, base = dim_sharded_topk(
        put(queries), put(db), replicate(norms, mesh), 200, 1,
        DistanceMetric.INNER_PRODUCT, mesh,
    )
    mask[np.asarray(base).ravel()] = 0.0
    _, i2 = dim_sharded_topk(
        put(queries), put(db), replicate(norms, mesh), 200, 5,
        DistanceMetric.INNER_PRODUCT, mesh,
        valid_mask=replicate(mask, mesh),
    )
    assert not np.intersect1d(np.asarray(i2), np.asarray(base)).size


# ------------------------------------------------------------------------
# Round 2: the remaining SURVEY §5 parallelism mappings — query-batch
# sharding (no collective) and the composed 2-D (query × shard) grid.


def test_query_sharded_matches_oracle(rng):
    from metrovector_tpu.parallel import make_mesh, query_sharded_topk, replicate
    from jax.sharding import NamedSharding, PartitionSpec as P
    import jax

    mesh = make_mesh(8, axis="query")
    n, d, k = 600, 24, 7
    db = rng.standard_normal((n, d)).astype(np.float32)
    norms = (db.astype(np.float64) ** 2).sum(1).astype(np.float32)
    q = rng.standard_normal((32, d)).astype(np.float32)  # 4 per device
    q_sharded = jax.device_put(q, NamedSharding(mesh, P("query", None)))
    s, i = query_sharded_topk(
        q_sharded, replicate(db, mesh), replicate(norms, mesh),
        n, k, DistanceMetric.L2, mesh,
    )
    _, oi = numpy_oracle(q, db, k, DistanceMetric.L2)
    assert np.array_equal(np.asarray(i), oi)


def test_grid_sharded_matches_oracle(rng):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from metrovector_tpu.parallel import (
        grid_sharded_topk,
        make_mesh_2d,
        shard_rows,
    )

    mesh = make_mesh_2d(2, 4)  # 2-way query × 4-way rows on 8 CPU devices
    n, d, k = 512, 16, 5
    db = rng.standard_normal((n, d)).astype(np.float32)
    norms = (db.astype(np.float64) ** 2).sum(1).astype(np.float32)
    q = rng.standard_normal((16, d)).astype(np.float32)
    mask = (rng.random(n) > 0.05).astype(np.float32)
    db_s = shard_rows(db, mesh, axis="shard")
    norms_s = shard_rows(norms, mesh, axis="shard")
    mask_s = shard_rows(mask, mesh, axis="shard", pad_value=0)
    q_s = jax.device_put(q, NamedSharding(mesh, P("query", None)))
    s, i = grid_sharded_topk(
        q_s, db_s, norms_s, n, k, DistanceMetric.L2, mesh,
        valid_mask=mask_s,
    )
    _, oi = numpy_oracle(q, db, k, DistanceMetric.L2, valid_mask=mask)
    assert np.array_equal(np.asarray(i), oi)


def test_grid_sharded_multi_block(rng):
    """Query-major 4 × 2 grid, each 128-row shard scanned in two
    64-row blocks."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from metrovector_tpu.parallel import (
        grid_sharded_topk,
        make_mesh_2d,
        shard_rows,
    )

    mesh = make_mesh_2d(4, 2)
    n, d, k = 256, 8, 3
    db = rng.standard_normal((n, d)).astype(np.float32)
    norms = (db.astype(np.float64) ** 2).sum(1).astype(np.float32)
    q = rng.standard_normal((8, d)).astype(np.float32)
    q_s = jax.device_put(q, NamedSharding(mesh, P("query", None)))
    s, i = grid_sharded_topk(
        q_s, shard_rows(db, mesh, axis="shard"),
        shard_rows(norms, mesh, axis="shard"),
        n, k, DistanceMetric.L2, mesh,
        block_rows=64,
    )
    _, oi = numpy_oracle(q, db, k, DistanceMetric.L2)
    assert np.array_equal(np.asarray(i), oi)


def test_query_and_grid_sharded_int8_uint8(rng):
    """The new mappings must carry the quantized paths too: symmetric int8
    (integer dots, combined scale) and the affine-uint8 offset bias."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from metrovector_tpu.parallel import (
        grid_sharded_topk,
        make_mesh,
        make_mesh_2d,
        query_sharded_topk,
        replicate,
        shard_rows,
    )

    # symmetric int8, query-sharded
    n, d, k = 384, 16, 5
    codes = rng.integers(-128, 128, (n, d)).astype(np.int8)
    scale = 0.05
    deq = codes.astype(np.float32) * scale
    norms = (deq.astype(np.float64) ** 2).sum(1).astype(np.float32)
    q = rng.integers(-128, 128, (16, d)).astype(np.int8)
    qf = q.astype(np.float32) * scale
    _, oi = numpy_oracle(qf, deq, k, DistanceMetric.INNER_PRODUCT)
    mesh = make_mesh(8, axis="query")
    qs = jax.device_put(q, NamedSharding(mesh, P("query", None)))
    # scale is the COMBINED dequant factor on raw integer dots (sq·sx,
    # the exact_topk contract) — here queries and corpus share one scale
    s, i = query_sharded_topk(
        qs, replicate(codes, mesh), replicate(norms, mesh), n, k,
        DistanceMetric.INNER_PRODUCT, mesh,
        scale=scale * scale,
    )
    assert np.array_equal(np.asarray(i), oi)

    # affine uint8 offset bias, 2-D grid
    u8 = rng.integers(0, 256, (n, d)).astype(np.float32)
    un = np.einsum("ij,ij->i", u8, u8, dtype=np.float64).astype(np.float32)
    shifted = (u8.astype(np.int16) - 128).astype(np.int8)
    rowsums = shifted.sum(1, dtype=np.int32).astype(np.float32)
    qi = rng.integers(0, 256, (8, d)).astype(np.float32)
    _, oi2 = numpy_oracle(qi, u8, k, DistanceMetric.L2)
    mesh2 = make_mesh_2d(2, 4)
    s2, i2 = grid_sharded_topk(
        jax.device_put(
            (qi - 128).astype(np.int8),
            NamedSharding(mesh2, P("query", None)),
        ),
        shard_rows(shifted, mesh2, axis="shard"),
        shard_rows(un, mesh2, axis="shard"),
        n, k, DistanceMetric.L2, mesh2,
        block_rows=64,
        scale=1.0, bias_row=shard_rows(rowsums, mesh2, axis="shard"),
        bias_scale=128.0,
    )
    assert np.array_equal(np.asarray(i2), oi2)


def test_bias_applies_on_every_sharded_mapping(rng):
    """Every sharded mapping applies the offset-uint8 bias (silently
    dropping it once produced wrong rankings): row-, query- and
    grid-sharded all rank like the oracle on the uint8 values, and the
    row-sharded affine dequant-on-read matches the oracle on the
    dequantized corpus."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from metrovector_tpu.parallel import (
        grid_sharded_topk,
        make_mesh,
        make_mesh_2d,
        query_sharded_topk,
        replicate,
        shard_rows,
        sharded_topk,
    )

    n, d, k = 128, 8, 3
    u8 = rng.integers(0, 256, (n, d)).astype(np.float32)
    un = np.einsum("ij,ij->i", u8, u8, dtype=np.float64).astype(np.float32)
    db = (u8.astype(np.int16) - 128).astype(np.int8)
    bias = db.astype(np.int32).sum(1).astype(np.float32)
    qf = rng.integers(0, 256, (8, d)).astype(np.float32)
    q = (qf - 128).astype(np.int8)
    _, oi = numpy_oracle(qf, u8, k, DistanceMetric.L2)
    kw = dict(scale=1.0, bias_scale=128.0)

    mesh = make_mesh(8)
    _, i = sharded_topk(
        replicate(q, mesh), shard_rows(db, mesh), shard_rows(un, mesh),
        n, k, DistanceMetric.L2, mesh, bias_row=shard_rows(bias, mesh), **kw,
    )
    assert np.array_equal(np.asarray(i), oi)
    meshq = make_mesh(8, axis="query")
    _, i = query_sharded_topk(
        jax.device_put(q, NamedSharding(meshq, P("query", None))),
        replicate(db, meshq), replicate(un, meshq), n, k,
        DistanceMetric.L2, meshq, bias_row=replicate(bias, meshq), **kw,
    )
    assert np.array_equal(np.asarray(i), oi)
    mesh2 = make_mesh_2d(2, 4)
    _, i = grid_sharded_topk(
        jax.device_put(q, NamedSharding(mesh2, P("query", None))),
        shard_rows(db, mesh2, axis="shard"),
        shard_rows(un, mesh2, axis="shard"), n, k,
        DistanceMetric.L2, mesh2,
        bias_row=shard_rows(bias, mesh2, axis="shard"), **kw,
    )
    assert np.array_equal(np.asarray(i), oi)

    # affine dequant-on-read: x = (c' + 128 − zp)·s with float queries
    zp, sc = 3.0, 0.5
    deq = (u8 - zp) * sc
    dn = np.einsum("ij,ij->i", deq, deq, dtype=np.float64).astype(np.float32)
    qd = rng.standard_normal((8, d)).astype(np.float32)
    _, oid = numpy_oracle(qd, deq, k, DistanceMetric.L2)
    _, i = sharded_topk(
        replicate(qd, mesh), shard_rows(db, mesh), shard_rows(dn, mesh),
        n, k, DistanceMetric.L2, mesh, dequant=(128.0 - zp, sc),
    )
    assert np.array_equal(np.asarray(i), oid)
