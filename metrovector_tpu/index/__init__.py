"""Index structures over MVT spaces (SURVEY.md §2: the reference declares a
Flat/IVF/HNSW index union plus PQ quantization extensions in its schema but
implements none of them — here every member is functional: Flat is the
fused exact engine; IVF, IVF-PQ and PQ run as device matmuls and scans; HNSW runs host-side
(graph traversal is chains of tiny dependent gathers) with persisted graphs)."""

from .hnsw import HNSWIndex
from .ivf import IVFIndex, train_kmeans
from .ivfpq import IVFPQIndex, train_ivfpq
from .pq import PQIndex, encode_pq, reconstruct_pq, train_pq

__all__ = [
    "HNSWIndex",
    "IVFIndex",
    "IVFPQIndex",
    "PQIndex",
    "encode_pq",
    "reconstruct_pq",
    "train_ivfpq",
    "train_kmeans",
    "train_pq",
]
