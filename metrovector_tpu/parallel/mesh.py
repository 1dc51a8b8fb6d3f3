"""Device mesh and corpus-sharding helpers.

The reference has no distributed machinery at all (SURVEY.md §5
"Distributed communication backend: none") — its scale story is mmap paging
on one host. The scale axis is the corpus: rows are sharded
across chips over a 1-D mesh ("data parallel over DB rows", SURVEY.md §5
parallelism mapping), queries are replicated, and per-shard top-k
candidates merge across devices with an ``all_gather`` (k is tiny, so the
collective is a few KB regardless of corpus size).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

SHARD_AXIS = "shard"


def make_mesh(n_devices: int | None = None, axis: str = SHARD_AXIS) -> Mesh:
    """A 1-D mesh over the first ``n_devices`` local devices."""
    devs = jax.devices()
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(
                f"requested {n_devices} devices, only {len(devs)} available"
            )
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


def rows_per_shard(padded_rows: int, n_shards: int, sublane: int) -> int:
    """Rows each shard owns: ``padded_rows`` rounded up so every shard gets
    the same tile-aligned count."""
    per = -(-padded_rows // n_shards)
    return -(-per // sublane) * sublane


def shard_rows(
    arr: np.ndarray | jax.Array,
    mesh: Mesh,
    axis: str = SHARD_AXIS,
    sublane: int = 8,
    pad_value=0,
) -> jax.Array:
    """Pad the leading (row) axis to ``n_shards × rows_per_shard`` and place
    the array row-sharded on the mesh. Padding rows are masked out of search
    by the per-shard ``num_valid`` logic, not by their values."""
    n_shards = mesh.shape[axis]
    rows = arr.shape[0]
    per = rows_per_shard(rows, n_shards, sublane)
    total = per * n_shards
    if total != rows:
        pad_width = ((0, total - rows),) + ((0, 0),) * (arr.ndim - 1)
        arr = np.pad(np.asarray(arr), pad_width, constant_values=pad_value)
    spec = P(axis, *([None] * (arr.ndim - 1)))
    return jax.device_put(arr, NamedSharding(mesh, spec))


def replicate(arr, mesh: Mesh) -> jax.Array:
    """Place an array fully replicated on every device of the mesh."""
    return jax.device_put(
        arr, NamedSharding(mesh, P(*([None] * np.asarray(arr).ndim)))
    )


QUERY_AXIS = "query"


def make_mesh_2d(
    n_query: int,
    n_shard: int,
    query_axis: str = QUERY_AXIS,
    shard_axis: str = SHARD_AXIS,
) -> Mesh:
    """A 2-D ``(query, shard)`` mesh: corpus rows shard over ``shard_axis``
    (each row group replicated across the query axis), query batches shard
    over ``query_axis`` — the full DP×"corpus-parallel" product mapping
    (SURVEY.md §5). ``n_query · n_shard`` devices are used."""
    devs = jax.devices()
    need = n_query * n_shard
    if need > len(devs):
        raise ValueError(f"requested {need} devices, only {len(devs)} available")
    grid = np.asarray(devs[:need]).reshape(n_query, n_shard)
    return Mesh(grid, (query_axis, shard_axis))
