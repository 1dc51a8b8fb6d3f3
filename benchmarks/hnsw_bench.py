"""HNSW build/search benchmark (host-side — HNSW deliberately does not
run on the accelerator; see index/hnsw.py docstring).

Measures native-path build throughput, single-query latency percentiles,
and the recall@10 vs ef curve against an exact oracle, on iid gaussian
data (the hardest case for graph indexes — no cluster structure to
exploit). Usage::

    python benchmarks/hnsw_bench.py [--n 1000000] [--d 64] [--m 16] \
        [--ef-c 100]

Reference analog: none — the reference declares the HNSW schema and
stores a TODO stub (``src/builder.rs:459``).
"""

import argparse
import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import jax
import numpy as np

# HNSW is host-side; keep jax off the accelerator (the config update is
# the reliable pin).
jax.config.update("jax_platforms", "cpu")

from metrovector_tpu.format.constants import DistanceMetric
from metrovector_tpu.index.hnsw import HNSWIndex


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--d", type=int, default=64)
    ap.add_argument("--m", type=int, default=16)
    ap.add_argument("--ef-c", type=int, default=100)
    ap.add_argument("--queries", type=int, default=500)
    ap.add_argument("--clustered", action="store_true",
                    help="clustered corpus (realistic embedding structure) "
                         "instead of iid gaussian (the hardest case)")
    ap.add_argument("--selection", default="heuristic",
                    choices=["heuristic", "closest"],
                    help="neighbor selection strategy")
    args = ap.parse_args()

    rng = np.random.default_rng(0)
    if args.clustered:
        n_c = 1024
        centers = rng.standard_normal((n_c, args.d)).astype(np.float32) * 4
        data = (
            centers[rng.integers(0, n_c, args.n)]
            + rng.standard_normal((args.n, args.d)).astype(np.float32)
        )
    else:
        data = rng.standard_normal((args.n, args.d)).astype(np.float32)
    print(
        f"n={args.n} d={args.d} m={args.m} ef_construction={args.ef_c} "
        f"clustered={args.clustered} selection={args.selection}"
    )

    t0 = time.perf_counter()
    idx = HNSWIndex.build(
        data, DistanceMetric.L2, m=args.m, ef_construction=args.ef_c,
        selection=args.selection,
    )
    t1 = time.perf_counter()
    native = idx._native_handle() is not None
    print(
        f"build: {t1 - t0:.1f}s ({args.n / (t1 - t0):.0f} rows/s), "
        f"native={native}, layers={len(idx.layers)}"
    )

    if args.clustered:
        # in-distribution queries: perturbed corpus rows (gaussian
        # queries sit near the origin, far from every cluster — a
        # pathological off-distribution set, not a recall benchmark)
        q = (
            data[rng.integers(0, args.n, args.queries)]
            + 0.3 * rng.standard_normal((args.queries, args.d))
        ).astype(np.float32)
    else:
        q = rng.standard_normal((args.queries, args.d)).astype(np.float32)
    # exact oracle in blocks (f64-free is fine: gating is set overlap)
    norms = np.einsum("ij,ij->i", data, data).astype(np.float32)
    oi = np.empty((args.queries, 10), np.int64)
    for s in range(0, args.queries, 50):
        block = 2.0 * q[s : s + 50] @ data.T - norms[None, :]
        oi[s : s + 50] = np.argsort(-block, axis=1, kind="stable")[:, :10]

    for ef in (16, 32, 64, 128, 256):
        lat = []
        hits = 0
        for i in range(args.queries):
            t = time.perf_counter()
            res = idx.search(q[i : i + 1], k=10, ef=ef)
            lat.append(time.perf_counter() - t)
        # separate recall pass (batched — latency loop above is 1-query)
        res = idx.search(q, k=10, ef=ef)
        for i in range(args.queries):
            hits += len(set(res.indices[i]) & set(oi[i]))
        lat_ms = np.sort(np.asarray(lat)) * 1e3
        p50 = lat_ms[len(lat_ms) // 2]
        p99 = lat_ms[int(len(lat_ms) * 0.99)]
        print(
            f"ef={ef:4d}: recall@10={hits / (args.queries * 10):.3f} "
            f"p50={p50:.3f} ms p99={p99:.3f} ms"
        )


if __name__ == "__main__":
    main()
