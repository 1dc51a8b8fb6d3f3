"""Compressed search: PQ and IVF-PQ with exact re-ranking.

No counterpart exists in the reference — its extensions schema declares PQ
codebook tables (``schema/extensions.fbs`` in thegenem0/metrovector) that
no code ever writes. This example shows the implemented pipeline:

1. train PQ codebooks on the corpus (matmul k-means per subspace),
2. persist codes + codebooks in the MVT file alongside the dense rows,
3. reopen and search three ways — exact, PQ-ADC + re-rank, IVF-PQ probe —
   and compare recall and working-set size.

Run:  python examples/quantized_search.py
"""

import os
import tempfile

import numpy as np

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import metrovector_tpu as mvt
from metrovector_tpu.index import IVFPQIndex, PQIndex, encode_pq, train_pq
from metrovector_tpu.ops import numpy_oracle


def recall(indices, oracle, k):
    return np.mean(
        [len(set(indices[i]) & set(oracle[i])) / k for i in range(len(indices))]
    )


def main():
    rng = np.random.default_rng(11)
    n, d, k = 20_000, 16, 10
    centers = rng.standard_normal((64, d)).astype(np.float32)
    # Noise ~ the center spacing (moderate dim, so clusters genuinely
    # overlap): each query's true top-10 spans several coarse cells and
    # the nprobe sweep below has something to trade off.
    data = (
        centers[rng.integers(0, 64, n)]
        + 2.0 * rng.standard_normal((n, d)).astype(np.float32)
    )
    queries = (
        centers[rng.integers(0, 64, 16)]
        + 2.0 * rng.standard_normal((16, d)).astype(np.float32)
    )

    # Train + persist: dense rows AND the PQ sidecar live in one file.
    books = train_pq(data, m=4, ksub=256, iters=6)
    codes = encode_pq(data, books)
    b = mvt.Builder()
    b.add_vector_space("emb", dim=d, metric=mvt.DistanceMetric.L2)
    b.add_vectors("emb", data)
    b.set_pq_index("emb", books, codes)
    path = os.path.join(tempfile.mkdtemp(), "quantized.mvt")
    b.build().save(path)
    print(f"file: {os.path.getsize(path) / 1e6:.1f} MB "
          f"(dense {data.nbytes / 1e6:.1f} MB + codes {codes.nbytes / 1e6:.1f} MB)")

    _, oracle = numpy_oracle(queries, data, k, mvt.DistanceMetric.L2)

    # 1. Exact engine — the recall-1.0 baseline.
    eng = mvt.SearchEngine.open(path)
    res = eng.search(queries, k=k)
    print(f"exact          recall@{k}: {recall(res.indices, oracle, k):.3f}  "
          f"working set {data.nbytes / 1e6:6.1f} MB")

    # 2. PQ: codes only on device (32x smaller), ADC + exact re-rank.
    sp = mvt.Reader.open(path).vector_space("emb")
    pq = PQIndex.from_space(sp)  # reuses the persisted codebooks/codes
    res = pq.search(queries, k=k, rerank=8 * k)
    print(f"pq m=4 rr=80   recall@{k}: {recall(res.indices, oracle, k):.3f}  "
          f"working set {pq.codes.nbytes / 1e6 + pq.recon_norms.nbytes / 1e6:6.1f} MB (codes)")

    # 3. IVF-PQ: probe a few coarse cells, residual ADC inside them.
    #    mode="auto" picks the formulation by batch size — bucket traversal
    #    for latency batches, the gather-free masked dense scan for batch
    #    serving (same nprobe semantics, full-scan throughput).
    ivfpq = IVFPQIndex.from_space(sp, num_clusters=64, m=4, ksub=64, iters=6)
    for nprobe in (2, 8, 32):
        res = ivfpq.search(queries, k=k, nprobe=nprobe, rerank=8 * k)
        res_scan = ivfpq.search(
            queries, k=k, nprobe=nprobe, rerank=8 * k,
            mode="scan", exact_lut=True,
        )
        agree = (res.indices == res_scan.indices).mean()
        print(f"ivfpq nprobe={nprobe:<3} recall@{k}: "
              f"{recall(res.indices, oracle, k):.3f}  "
              f"(scan mode agrees: {agree:.0%})")


if __name__ == "__main__":
    main()
