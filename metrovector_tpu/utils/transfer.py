"""Host→device transfer helpers.

A bounded transfer size keeps peak pinned-host-buffer use flat:
:func:`put_chunked` uploads row slices of a bounded byte size into a
preallocated device buffer (donated, updated in place), producing an array
identical to a direct ``device_put``.

Reference analog: none — the reference never moves bytes off the host
(mmap only, ``src/reader.rs:45-79`` in thegenem0/metrovector).
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np

#: chunking engages only for arrays strictly larger than this
DEFAULT_THRESHOLD_BYTES = 512 << 20
#: row-slice target size once chunking engages
DEFAULT_CHUNK_BYTES = 256 << 20


def _env_chunk_bytes() -> int | None:
    """``MVT_PUT_CHUNK_BYTES``: piece size in bytes, ``0``/``off`` to
    disable chunking entirely. None = unset (use defaults)."""
    raw = os.environ.get("MVT_PUT_CHUNK_BYTES")
    if raw is None:
        return None
    if raw.strip().lower() in ("0", "off", "no", "false"):
        return 0
    return int(raw)


def _write_rows(buf, piece, start):
    """Donated in-place row-slice write (jitted lazily below)."""
    import jax.lax

    return jax.lax.dynamic_update_slice_in_dim(buf, piece, start, axis=0)


_write_rows_jit = None


def put_chunked(
    arr: np.ndarray,
    device: Any | None = None,
    max_bytes: int | None = None,
) -> Any:
    """``jax.device_put`` in bounded row slices into a preallocated device
    buffer (donated in-place slice writes).

    Bit-identical to a direct ``device_put``; the transient device
    footprint is the array plus ONE chunk (≤256 MB) — the destination
    buffer is allocated once and each uploaded slice is written into it
    with buffer donation, so no second full-size copy ever exists (the
    earlier concat formulation transiently held ~2× and could blow an
    ``hbm_budget`` that admitted the steady-state size — advisor r4).
    Arrays at or below the engage threshold (512 MB, or ``max_bytes`` /
    ``$MVT_PUT_CHUNK_BYTES`` when given) upload directly. Scalars and
    0-/1-row arrays upload directly regardless."""
    import contextlib

    import jax
    import jax.numpy as jnp

    put = (lambda x: jax.device_put(x, device)) if device is not None \
        else jax.device_put

    env = _env_chunk_bytes()
    if env == 0:
        return put(arr)
    chunk_bytes = max_bytes if max_bytes is not None else (
        env if env is not None else DEFAULT_CHUNK_BYTES
    )
    threshold = chunk_bytes if (max_bytes is not None or env is not None) \
        else DEFAULT_THRESHOLD_BYTES

    nbytes = getattr(arr, "nbytes", 0)
    ndim = getattr(arr, "ndim", 0)
    if ndim < 1 or arr.shape[0] <= 1 or nbytes <= threshold:
        return put(arr)
    row_bytes = max(1, nbytes // arr.shape[0])
    rows_per = max(1, chunk_bytes // row_bytes)
    if rows_per >= arr.shape[0]:
        return put(arr)

    global _write_rows_jit
    if _write_rows_jit is None:
        _write_rows_jit = jax.jit(_write_rows, donate_argnums=(0,))
    ctx = jax.default_device(device) if device is not None \
        else contextlib.nullcontext()
    with ctx:
        buf = jnp.zeros(arr.shape, dtype=arr.dtype)
        for s0 in range(0, arr.shape[0], rows_per):
            piece = put(np.ascontiguousarray(arr[s0 : s0 + rows_per]))
            jax.block_until_ready(piece)
            # a ragged tail compiles one extra shape; starts stay traced
            buf = _write_rows_jit(buf, piece, jnp.int32(s0))
        jax.block_until_ready(buf)
    return buf
