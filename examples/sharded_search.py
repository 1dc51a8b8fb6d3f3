"""Multi-chip sharded search on a device mesh.

No reference analog exists — the reference has no distributed machinery at
all (SURVEY.md §5). Runs on real multi-chip hardware or a virtual CPU mesh:

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python examples/sharded_search.py
"""

import os
import tempfile

import numpy as np

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import metrovector_tpu as mvt
from metrovector_tpu.parallel import ShardedDeviceSpace, StreamingSearcher, make_mesh


def main():
    import jax

    ndev = len(jax.devices())
    print(f"devices: {ndev} x {jax.devices()[0].platform}")

    rng = np.random.default_rng(0)
    data = rng.standard_normal((100_000, 64)).astype(np.float32)
    b = mvt.Builder()
    b.add_vector_space("corpus", dim=64)
    b.add_vectors("corpus", data)
    path = os.path.join(tempfile.mkdtemp(), "corpus.mvt")
    b.build().save(path)

    space = mvt.Reader.open(path).vector_space("corpus")

    # ---- row-sharded over all devices, global top-k via all-gather merge --------
    mesh = make_mesh(ndev)
    sharded = ShardedDeviceSpace(space, mesh)
    queries = data[:4] + 0.05 * rng.standard_normal((4, 64)).astype(np.float32)
    res = sharded.search(queries, k=5)
    print("sharded top-1 per query:", res.indices[:, 0], "(expect 0..3)")
    shard_rows = sharded.data.shape[0] // ndev
    print(f"each device holds {shard_rows:,} rows "
          f"({shard_rows * 64 * 4 / 1e6:.1f} MB)")

    # ---- host streaming (corpora larger than device memory) -------------
    stream = StreamingSearcher(space, chunk_rows=16_384)
    res2 = stream.search(queries, k=5)
    assert np.array_equal(res.indices, res2.indices)
    print("streamed result identical to sharded result")

    # ---- 2-D (query × shard) grid: DP over query batches composed with
    # row sharding — throughput scaling for large query streams ----------
    if ndev >= 4 and ndev % 2 == 0:
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P

        from metrovector_tpu.parallel import (
            grid_sharded_topk,
            make_mesh_2d,
            shard_rows as shard_rows_fn,
        )

        mesh2 = make_mesh_2d(2, ndev // 2)
        norms = np.einsum("ij,ij->i", data, data, dtype=np.float64).astype(
            np.float32
        )
        big_batch = np.repeat(queries, 4, axis=0)  # 16 queries, 8/DP group
        s2, i2 = grid_sharded_topk(
            jax.device_put(
                big_batch, NamedSharding(mesh2, P("query", None))
            ),
            shard_rows_fn(data, mesh2, axis="shard"),
            shard_rows_fn(norms, mesh2, axis="shard"),
            data.shape[0], 5, mvt.DistanceMetric.L2, mesh2,
        )
        assert np.array_equal(np.asarray(i2)[::4], res.indices)
        print("2-D query×shard grid matches the 1-D result")


if __name__ == "__main__":
    main()
