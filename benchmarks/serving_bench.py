"""Serving-path benchmark: MicroBatcher QPS under concurrent single-query
closed-loop clients on the SIFT1M-scale workload (1M x 128 f32, L2, k=10).

Unlike bench.py (pre-batched queries — the throughput ceiling), this
measures the *request coalescing* path: N client threads each submit ONE
query at a time and wait for its result, i.e. the shape a service actually
receives. The batcher coalesces them onto the bucket ladder; pipeline=True
additionally keeps one batch in flight so the readback of batch i hides
under batch i+1's compute. Runs on a GPU only.

Prints the device line, then one JSON line per mode:
  {"mode": "pipelined"|"plain", "qps": ..., "p50_ms": ..., "p99_ms": ...,
   "occupancy": ..., "batches": ..., "requests": ...}

The "filtered" mode measures per-request predicate serving (round-5):
each client carries one of MVT_SB_PREDICATES prepared metadata filters
(selectivity ~1/P each) and requests coalesce by predicate group —
the datapoint is how much QPS survives 2-4 live predicates splitting
every drain window into per-group launches.

Env knobs: MVT_SB_N (corpus rows, default 1_000_000), MVT_SB_THREADS
(default 64), MVT_SB_SECONDS (timed window per mode, default 8),
MVT_SB_MODES ("pipelined,plain"; also "filtered"), MVT_SB_MAX_BATCH
(default 256), MVT_SB_PREDICATES (filtered mode, default 4).
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main() -> None:
    from metrovector_tpu.engine import DeviceSpace, SearchEngine
    from metrovector_tpu.format.constants import DataType, DistanceMetric
    from metrovector_tpu.serving import MicroBatcher
    from metrovector_tpu.utils import enable_compilation_cache
    from metrovector_tpu.utils.device import card_info, require_gpu
    from metrovector_tpu.utils.transfer import put_chunked

    dev = require_gpu()
    card = card_info()
    print(f"device: {json.dumps(dev)} card: {card}", flush=True)
    log(f"compilation cache: {enable_compilation_cache()}")
    n = int(os.environ.get("MVT_SB_N", 1_000_000))
    threads = int(os.environ.get("MVT_SB_THREADS", 64))
    seconds = float(os.environ.get("MVT_SB_SECONDS", 8))
    modes = os.environ.get("MVT_SB_MODES", "pipelined,plain").split(",")
    max_batch = int(os.environ.get("MVT_SB_MAX_BATCH", 256))
    d, k = 128, 10
    log(f"n={n} threads={threads} window={seconds}s "
        f"max_batch={max_batch}")

    rng = np.random.default_rng(7)
    data = rng.integers(0, 256, size=(n, d)).astype(np.float32)
    norms = np.einsum("ij,ij->i", data, data, dtype=np.float64).astype(np.float32)
    sp = DeviceSpace(
        data=put_chunked(data),
        norms=put_chunked(norms),
        num_valid=n,
        dim=d,
        metric=DistanceMetric.L2,
        dtype=DataType.FLOAT32,
        name="serving-bench",
    )
    eng = SearchEngine(sp)

    # Warm the ladder shapes once so the timed window measures execution,
    # not compilation.
    ladder = []
    b = 1
    while b < max_batch:
        ladder.append(b)
        b *= 2
    ladder.append(max_batch)
    t0 = time.perf_counter()
    for s in ladder:  # every rung: a straggler drain may hit any bucket
        q = rng.integers(0, 256, (s, d)).astype(np.float32)
        np.asarray(eng.search(q, k=k).indices)
        log(f"warm batch {s}: done at +{time.perf_counter() - t0:.1f}s")

    queries = rng.integers(0, 256, (4096, d)).astype(np.float32)
    n_pred = int(os.environ.get("MVT_SB_PREDICATES", 4))
    prepared = None
    if any(m.strip() == "filtered" for m in modes):
        # P disjoint ~1/P-selectivity predicates (a tenant/shard column),
        # prepared once — the recommended per-request serving shape
        labels = rng.integers(0, n_pred, n)
        prepared = [eng.prepare_filter(labels == p) for p in range(n_pred)]
        # the masked scan is a distinct executable per rung: warm it
        for sz in ladder:
            q = rng.integers(0, 256, (sz, d)).astype(np.float32)
            np.asarray(
                eng.search(q, k=k, filter_mask=prepared[0]).indices
            )
        log(f"warm filtered ladder: done at "
            f"+{time.perf_counter() - t0:.1f}s")

    for mode in modes:
        mode = mode.strip()
        pipelined = mode == "pipelined"
        mb = MicroBatcher(
            eng, k=k, max_batch=max_batch, max_wait_ms=1.0,
            pipeline=pipelined,
        )
        stop = threading.Event()
        counts = [0] * threads
        lats: list[list[float]] = [[] for _ in range(threads)]

        def client(i: int):
            j = i
            fm = prepared[i % n_pred] if mode == "filtered" else None
            while not stop.is_set():
                t = time.monotonic()
                mb.submit(
                    queries[j % len(queries)], filter_mask=fm
                ).result(timeout=120)
                lats[i].append((time.monotonic() - t) * 1e3)
                counts[i] += 1
                j += threads

        ts = [threading.Thread(target=client, args=(i,)) for i in range(threads)]
        for t in ts:
            t.start()
        time.sleep(min(2.0, seconds / 2))  # ramp: reach steady coalescing
        base = sum(counts)
        t0 = time.monotonic()
        time.sleep(seconds)
        done = sum(counts) - base
        dt = time.monotonic() - t0
        stop.set()
        for t in ts:
            t.join()
        mb.close(timeout=120)
        s = mb.stats()
        lat = sorted(x for li in lats for x in li)
        out = {
            "mode": mode,
            "qps": round(done / dt, 1),
            "p50_ms": round(lat[len(lat) // 2], 2) if lat else None,
            "p99_ms": round(lat[min(len(lat) - 1, int(len(lat) * 0.99))], 2)
            if lat else None,
            "occupancy": round(s.occupancy, 3),
            "batches": s.batches,
            "windows": s.windows,
            "requests": s.requests,
            "threads": threads,
            "device": dev,
            "card": card,
        }
        if mode == "filtered":
            out["predicates"] = n_pred
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
