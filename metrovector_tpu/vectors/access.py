"""Batch access planning.

Parity with the reference ``AccessPattern`` (``src/vectors/access.rs`` in
thegenem0/metrovector): sort + dedup requested indices and group them into
block-local runs of ``VECTORS_PER_BLOCK`` (``src/vectors/access.rs:29-56``,
constant at ``:34``). Dedup semantics match the reference: requesting
``[0, 2, 1, 2, 0]`` yields 3 vectors (test at
``src/vectors/vector_space.rs:400-414``).

On the accelerator the analog of this locality planner is the scan's block grid; this
host-side version remains useful for mmap-page locality when plucking sparse
row sets out of a cold file.
"""

from __future__ import annotations

import numpy as np

VECTORS_PER_BLOCK = 1024


class AccessPattern:
    """A sorted, deduplicated access plan grouped into 1024-row blocks."""

    def __init__(self, indices):
        idx = np.unique(np.asarray(indices, dtype=np.int64))
        self._indices = idx
        # Split the sorted unique indices wherever the 1024-block changes.
        if idx.size:
            blocks = idx // VECTORS_PER_BLOCK
            cuts = np.flatnonzero(np.diff(blocks)) + 1
            self._groups = [g for g in np.split(idx, cuts)]
        else:
            self._groups = []

    @property
    def indices(self) -> np.ndarray:
        """Sorted unique indices."""
        return self._indices

    @property
    def groups(self) -> list[np.ndarray]:
        """Runs of indices sharing a 1024-row block, in ascending order."""
        return self._groups

    @property
    def num_blocks(self) -> int:
        return len(self._groups)

    def __len__(self) -> int:
        return int(self._indices.size)

    def __repr__(self) -> str:
        return f"AccessPattern(n={len(self)}, blocks={self.num_blocks})"
