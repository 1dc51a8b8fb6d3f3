"""Compute ops: distance scoring and the exact top-k scan."""

from .distances import (
    distances_np,
    exact_topk,
    numpy_oracle,
    scores_to_distances,
)

__all__ = [
    "distances_np",
    "exact_topk",
    "numpy_oracle",
    "scores_to_distances",
]
