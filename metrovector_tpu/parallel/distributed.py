"""Multi-host scaffolding: process initialization and per-host shard
loading.

The reference has no multi-node story at all (SURVEY.md §5). The design:
``jax.distributed`` coordinates processes across hosts, the corpus is
row-sharded over the **global** mesh, and each host mmaps the same MVT file
but touches only the byte range of its own rows — the zero-copy open is
per-host, the page cache only faults in local shards, and device arrays are
assembled with ``jax.make_array_from_single_device_arrays`` so no host ever
materializes the full corpus.

Single-host multi-device works through the same code path (every local
device is "its own host slice"), which is how the tests exercise it on the
virtual CPU mesh.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..format.constants import sublane_multiple
from ..vectors.space import VectorSpace
from .mesh import SHARD_AXIS, rows_per_shard


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Join (or bootstrap) a multi-process JAX cluster. Thin wrapper over
    ``jax.distributed.initialize`` — on single-process runs (no coordinator
    given and no cluster env) this is a no-op."""
    if coordinator_address is None and num_processes is None:
        try:  # cluster auto-detection (from the cluster's environment)
            jax.distributed.initialize()
        except Exception:
            return  # single-process: nothing to join
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def global_mesh(axis: str = SHARD_AXIS) -> Mesh:
    """A 1-D mesh over every device in the cluster (all hosts)."""
    return Mesh(np.asarray(jax.devices()), (axis,))


def load_space_sharded(
    space: VectorSpace,
    mesh: Mesh | None = None,
    axis: str = SHARD_AXIS,
    uint8_offset: bool = False,
):
    """Load one space row-sharded over a (possibly multi-host) mesh,
    touching only locally-owned rows.

    Returns ``(data, norms, valid_mask_or_None, rowsums_or_None,
    rows_per_shard)`` as global jax arrays sharded ``P(axis, …)``. Each
    addressable device receives its slice via ``device_put`` of a *view*
    of the mmap — rows owned by remote hosts are never read on this host.

    ``uint8_offset=True`` applies the uint8 offset transform per local
    slice (re-center codes to int8 ``c' = c − 128`` and compute the
    per-row code sums the kernel's affine correction needs — see
    ``DeviceSpace.from_space``), so the f32 corpus never materializes on
    any host.
    """
    if mesh is None:
        mesh = global_mesh(axis)
    n_shards = mesh.shape[axis]
    sub = sublane_multiple(space.dtype)
    per = rows_per_shard(space.padded_rows, n_shards, sub)
    total = per * n_shards

    block = space.padded_array()
    norms = np.asarray(space.norms(), dtype=np.float32)
    host_mask = space.tombstone_mask()
    mask_full = None
    if host_mask is not None:
        mask_full = np.ones(space.padded_rows, dtype=np.float32)
        mask_full[: space.num_vectors] = (~host_mask).astype(np.float32)

    # Device order along the mesh axis defines row ownership.
    devices = list(mesh.devices.reshape(-1))

    dim, nvalid = space.dim, space.num_vectors

    def _recenter(piece: np.ndarray, lo: int) -> np.ndarray:
        shifted = piece.astype(np.int16) - 128
        shifted[:, dim:] = 0
        local_valid = int(np.clip(nvalid - lo, 0, shifted.shape[0]))
        shifted[local_valid:, :] = 0
        return shifted

    def assemble(host_array, spec, transform=None):
        tail = (
            transform(np.asarray(host_array[0:0]), 0)
            if transform is not None
            else host_array[0:0]
        ).shape[1:]
        shape_global = (total,) + tail
        shards = []
        for di, dev in enumerate(devices):
            if dev.process_index != jax.process_index():
                continue
            lo = di * per
            hi = min(lo + per, host_array.shape[0])
            piece = np.asarray(host_array[lo:hi])
            if transform is not None:
                piece = transform(piece, lo)
            if piece.shape[0] < per:  # trailing padding rows
                pw = ((0, per - piece.shape[0]),) + ((0, 0),) * (
                    piece.ndim - 1
                )
                piece = np.pad(piece, pw)
            shards.append(jax.device_put(piece, dev))
        sharding = NamedSharding(mesh, spec)
        return jax.make_array_from_single_device_arrays(
            shape_global, sharding, shards
        )

    if uint8_offset:
        data = assemble(
            block, P(axis, None),
            transform=lambda p, lo: _recenter(p, lo).astype(np.int8),
        )
        rowsums_g = assemble(
            block, P(axis),
            transform=lambda p, lo: _recenter(p, lo)[:, :dim]
            .sum(axis=1, dtype=np.int32)
            .astype(np.float32),
        )
    else:
        data = assemble(block, P(axis, None))
        rowsums_g = None
    norms_g = assemble(norms, P(axis))
    mask_g = assemble(mask_full, P(axis)) if mask_full is not None else None
    return data, norms_g, mask_g, rowsums_g, per


class DistributedSearcher:
    """Global exact search over a multi-host row-sharded corpus.

    Same SPMD layout as :func:`.sharded_search.sharded_topk` — per-shard
    top-k scan, ``all_gather`` candidate merge across devices and hosts —
    but built on per-host shard loading, so a 1B-row corpus on 64 hosts
    costs each host 1/64th of the file I/O and device memory."""

    def __init__(self, space: VectorSpace, mesh: Mesh | None = None,
                 axis: str = SHARD_AXIS):
        from ..format.constants import DataType

        if mesh is None:
            mesh = global_mesh(axis)
        self.mesh = mesh
        self.axis = axis
        self.space_meta = space.info
        self.metric = space.metric
        self.dim = space.dim
        self.num_valid = space.num_vectors
        q = space.quantization
        self.scale = q.scale if q else 1.0
        self.zero_point = q.zero_point if q else 0.0
        self.dtype = DataType(space.dtype)
        host_ids = space.ids()
        self.host_ids = None if host_ids is None else np.asarray(host_ids)
        (
            self.data, self.norms, self.valid_mask, self.rowsums,
            self.rows_per_shard,
        ) = load_space_sharded(
            space, mesh, axis,
            uint8_offset=self.dtype == DataType.UINT8,
        )

    def search(self, queries, k: int = 10):
        from .sharded_search import search_row_sharded

        return search_row_sharded(self, queries, k, self.valid_mask)
