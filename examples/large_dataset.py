"""Large-dataset generation + throughput measurement harness.

Python analog of the reference's benchmark harness
``examples/large_dataset.rs`` (CLI-configurable synthetic generator,
chunked builds, sequential/random read throughput, open latency —
``large_dataset.rs:24-372`` in thegenem0/metrovector), extended with the
numbers that matter on the accelerator: host→device upload bandwidth and
search QPS.

Run:  python examples/large_dataset.py --vectors 100000 --dimensions 256
"""

import argparse
import os
import tempfile
import time

import numpy as np

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import metrovector_tpu as mvt
from metrovector_tpu.utils import PhaseTimer


def _resolve_shape(args) -> tuple[int, int]:
    """The reference's GB-targeted sizing (``large_dataset.rs:24-85``):
    with ``--size`` given and vectors/dimensions unset, derive them from
    the byte target (default dim 768, the common sentence-transformer
    width)."""
    n, d = args.vectors, args.dimensions
    if args.size is None:
        return n or 100_000, d or 256
    s = args.size.lower().removesuffix("gb")
    try:
        target_gb = float(s)
    except ValueError:
        target_gb = 2.5  # the reference's default
    target_bytes = int(target_gb * 1024**3)
    if not n and not d:
        d = 768
        n = target_bytes // (d * 4)
    elif not n:
        n = target_bytes // (d * 4)
    elif not d:
        d = target_bytes // (n * 4)
    return n, d


def _page_size_analysis(file_size: int) -> None:
    """OS page-size impact of the mmap (``large_dataset.rs:347-372``)."""
    print(f"  file size on disk: {file_size / 1024**3:.2f} GB")
    try:
        page = os.sysconf("SC_PAGESIZE")
    except (ValueError, OSError):
        page = 4096  # the reference's non-unix assumption
    print(f"  OS page size: {page // 1024} KB")
    print(f"  pages needed: {-(-file_size // page)}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--vectors", type=int, default=0)
    ap.add_argument("--dimensions", type=int, default=0)
    ap.add_argument("--size", default=None, metavar="GB",
                    help="target file size, e.g. '2.5' or '2.5GB' "
                         "(derives --vectors/--dimensions when unset)")
    ap.add_argument("--chunk", type=int, default=10_000,
                    help="build chunk size (reference default 10k rows)")
    ap.add_argument("--queries", type=int, default=64)
    ap.add_argument("--path", default=None)
    args = ap.parse_args()
    args.vectors, args.dimensions = _resolve_shape(args)

    timer = PhaseTimer()
    rng = np.random.default_rng(0)
    path = args.path or os.path.join(tempfile.mkdtemp(), "large.mvt")

    # -- chunked build (reference large_dataset.rs:120-163) -----------------
    with timer.phase("generate+build"):
        b = mvt.Builder()
        b.add_vector_space("vectors", dim=args.dimensions)
        for start in range(0, args.vectors, args.chunk):
            n = min(args.chunk, args.vectors - start)
            b.add_vectors(
                "vectors", rng.standard_normal((n, args.dimensions)).astype(np.float32)
            )
        built = b.build()
    with timer.phase("save"):
        built.save(path)
    size = os.path.getsize(path)
    print(f"file: {path}  {size / 1e6:,.1f} MB")
    _page_size_analysis(size)

    # -- open latency (reference :197-200; claim ~10 ms any size) -----------
    with timer.phase("open"):
        r = mvt.Reader.open(path)
    space = r.vector_space("vectors")

    # -- sequential read throughput (reference :302-345) --------------------
    n_seq = min(args.vectors, 200_000)
    checksum = 0.0  # anti-DCE, like the reference's running checksum
    t0 = time.perf_counter()
    for chunk in space.stream_vectors(0, 4096):
        for v in chunk[: len(chunk)]:
            checksum += float(v.as_numpy()[0])
        if chunk[-1].index >= n_seq - 1:
            break
    dt = time.perf_counter() - t0
    print(f"sequential (row views): {n_seq / dt:,.0f} vectors/s  (checksum {checksum:.1f})")

    # bulk zero-copy path: what sequential access actually costs on MVT
    t0 = time.perf_counter()
    total = float(space.to_numpy()[:n_seq].sum(dtype=np.float64))
    dt = time.perf_counter() - t0
    print(f"sequential (bulk view): {n_seq / dt:,.0f} vectors/s  (sum {total:.1f})")

    # -- random access throughput (reference :263-300) ----------------------
    idx = rng.integers(0, args.vectors, 50_000)
    t0 = time.perf_counter()
    acc = 0.0
    for i in idx:
        acc += float(space.get_vector(int(i)).as_numpy()[0])
    dt = time.perf_counter() - t0
    print(f"random access: {len(idx) / dt:,.0f} vectors/s")

    # -- device upload + search ---------------------------------------------
    import jax

    with timer.phase("device upload"):
        engine = mvt.SearchEngine(space)
        jax.block_until_ready(engine.space.data)
    queries = rng.standard_normal((args.queries, args.dimensions)).astype(np.float32)
    with timer.phase("search warmup"):
        engine.search(queries, k=10)
    t0 = time.perf_counter()
    res = engine.search(queries, k=10)
    dt = time.perf_counter() - t0
    print(f"fused search: {args.queries} queries in {dt * 1e3:.1f} ms "
          f"-> {args.queries / dt:,.0f} QPS")

    print("\n" + timer.report())


if __name__ == "__main__":
    main()
