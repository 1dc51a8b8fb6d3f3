"""Full benchmark suite over the repo's target configurations (BASELINE.json):

  sim10k    similarity_search example scale: 10k x 128 f32, L2 top-10
  sift1m    SIFT1M-scale: 1M x 128 f32, L2 exact top-100
  sift1m-u8 SIFT1M as uint8 codes (offset-int8 integer dot), L2 top-10
  sift1m-pq4  4-bit plain PQ (m=32/ksub=16, same 16 B/row) + re-rank
  gist1m    GIST1M-scale: 1M x 960 f32, cosine top-10 (wide-dim tiling)
  deep10m   DEEP10M-scale: 10M x 96 int8, quantized dot top-10
  deep100m-pq  100M x 96 PQ-coded corpus on one chip (1.2 GB codes)
  stream    streamed search: f16 corpus streamed from host memory

Each config prints one JSON line with QPS, p50 batch latency, and a recall
gate versus a float64 NumPy oracle on a query subsample. Pipelined-launch
timing (see bench.py docstring for the methodology rationale).

Usage: python benchmarks/suite.py [config ...]   (default: all that fit)
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

# Runnable as `python benchmarks/suite.py` without installing the package.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from metrovector_tpu.utils.transfer import put_chunked  # noqa: E402


def log(*a):
    print(*a, file=sys.stderr, flush=True)



def _measure(run, make_queries, iters=20):
    import jax

    qs = [jax.device_put(make_queries()) for _ in range(iters)]
    jax.block_until_ready(qs)
    _ = np.asarray(run(qs[0])[1])  # warm
    t0 = time.perf_counter()
    outs = [run(q) for q in qs]
    _ = np.asarray(outs[-1][1])
    return (time.perf_counter() - t0) / iters


def _recall(indices, oracle_idx, k):
    return float(
        np.mean(
            [
                len(set(indices[r]) & set(oracle_idx[r])) / k
                for r in range(indices.shape[0])
            ]
        )
    )


def _report(name, qps, p50_ms, recall, extra=""):
    row = {
        "config": name,
        "qps": round(qps, 1),
        "p50_ms": round(p50_ms, 2),
        "recall": round(recall, 4),
        "notes": extra,
    }
    print(json.dumps(row), flush=True)


def bench_sim10k():
    """The reference's similarity_search workload at example scale."""
    import jax

    from metrovector_tpu import Builder, DistanceMetric, Reader
    from metrovector_tpu.engine import SearchEngine
    from metrovector_tpu.ops import numpy_oracle

    rng = np.random.default_rng(0)
    data = rng.standard_normal((10_000, 128)).astype(np.float32)
    import tempfile, os

    path = os.path.join(tempfile.mkdtemp(), "sim.mvt")
    b = Builder()
    b.add_vector_space("v", dim=128)
    b.add_vectors("v", data)
    b.build().save(path)
    eng = SearchEngine.open(path)
    queries = rng.standard_normal((64, 128)).astype(np.float32)
    res = eng.search(queries, k=10)
    _, oi = numpy_oracle(queries, data, 10, DistanceMetric.L2)
    recall = _recall(res.indices, oi, 10)
    t0 = time.perf_counter()
    for _ in range(10):
        res = eng.search(queries, k=10)
    dt = (time.perf_counter() - t0) / 10
    _report("sim10k(64q,k=10)", 64 / dt, dt * 1e3, recall,
            "end-to-end engine.search incl host round-trip")


def bench_sift1m():
    import jax

    from metrovector_tpu.format.constants import DistanceMetric
    from metrovector_tpu.ops import exact_topk

    rng = np.random.default_rng(1)
    n, d, k, qb = 1_000_000, 128, 100, 128
    db = rng.integers(0, 256, (n, d)).astype(np.float32)
    norms = np.einsum("ij,ij->i", db, db, dtype=np.float64).astype(np.float32)
    db_d, norms_d = put_chunked(db), jax.device_put(norms)
    jax.block_until_ready((db_d, norms_d))

    def run(q):
        return exact_topk(q, db_d, norms_d, np.int32(n), k, DistanceMetric.L2)

    qcheck = rng.integers(0, 256, (8, d)).astype(np.float32)
    got = np.asarray(run(jax.device_put(qcheck))[1])
    d2 = norms.astype(np.float64)[None] - 2 * (qcheck.astype(np.float64) @ db.T.astype(np.float64))
    oi = np.argsort(d2, 1, kind="stable")[:, :k]
    recall = _recall(got, oi, k)
    dt = _measure(run, lambda: rng.integers(0, 256, (qb, d)).astype(np.float32),
                  iters=20)
    _report(f"sift1m(n={n},k=100,{qb}q)", qb / dt, dt * 1e3, recall,
            "f32 HIGHEST precision")


def bench_sift1m_u8():
    import jax

    from metrovector_tpu.format.constants import DistanceMetric
    from metrovector_tpu.ops import exact_topk

    rng = np.random.default_rng(2)
    n, d, k, qb = 1_000_000, 128, 10, 256
    u8 = rng.integers(0, 256, (n, d)).astype(np.uint8)
    norms = (u8.astype(np.float64) ** 2).sum(1).astype(np.float32)
    shifted = (u8.astype(np.int16) - 128).astype(np.int8)
    rowsums = shifted.sum(1, dtype=np.int32).astype(np.float32)
    db_d = jax.device_put(shifted)
    norms_d = jax.device_put(norms)
    bias_d = jax.device_put(rowsums)
    jax.block_until_ready((db_d, norms_d, bias_d))

    def run(q):
        return exact_topk(q, db_d, norms_d, np.int32(n), k, DistanceMetric.L2,
                          scale=1.0, bias_row=bias_d, bias_scale=128.0)

    qint = rng.integers(0, 256, (8, d)).astype(np.float32)
    got = np.asarray(run(jax.device_put((qint - 128).astype(np.int8)))[1])
    d2 = norms.astype(np.float64)[None] - 2 * (qint.astype(np.float64) @ u8.T.astype(np.float64))
    oi = np.argsort(d2, 1, kind="stable")[:, :k]
    recall = _recall(got, oi, k)
    dt = _measure(
        run,
        lambda: (rng.integers(0, 256, (qb, d)).astype(np.float32) - 128).astype(np.int8),
        iters=20,
    )
    _report(f"sift1m-u8(n={n},k=10,{qb}q)", qb / dt, dt * 1e3, recall,
            "offset-int8 integer dot, integer-exact")


def bench_gist1m():
    import jax

    from metrovector_tpu.format.constants import DistanceMetric
    from metrovector_tpu.ops import exact_topk

    rng = np.random.default_rng(3)
    n, d, k, qb = 1_000_000, 960, 10, 64
    pd = 1024  # padded to the 128-lane boundary
    db = np.zeros((n, pd), np.float32)
    db[:, :d] = rng.standard_normal((n, d)).astype(np.float32)
    norms = np.einsum("ij,ij->i", db, db, dtype=np.float64).astype(np.float32)
    db_d = put_chunked(db)
    norms_d = jax.device_put(norms)
    jax.block_until_ready((db_d, norms_d))

    def mk():
        q = np.zeros((qb, pd), np.float32)
        q[:, :d] = rng.standard_normal((qb, d)).astype(np.float32)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        return q

    def run(q):
        return exact_topk(q, db_d, norms_d, np.int32(n), k,
                          DistanceMetric.COSINE)

    qc = mk()[:8]
    got = np.asarray(run(jax.device_put(qc))[1])
    sim = (qc.astype(np.float64) @ db.T.astype(np.float64)) / np.sqrt(
        np.maximum(norms.astype(np.float64), 1e-30)
    )[None]
    oi = np.argsort(-sim, 1, kind="stable")[:, :k]
    recall = _recall(got, oi, k)
    dt = _measure(run, mk, iters=20)
    _report(f"gist1m(n={n},960d,cos,k=10,{qb}q)", qb / dt, dt * 1e3, recall,
            "3.9 GB f32 corpus, wide-dim tiling")


    qb2 = 256

    def mk2():
        q = np.zeros((qb2, pd), np.float32)
        q[:, :d] = rng.standard_normal((qb2, d)).astype(np.float32)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        return q

    # 'high': three bf16 dots per block instead of one f32 HIGHEST dot.
    # Recall-gated — the mode is sub-ulp-exact, not bit-exact, on float
    # data.
    def run3(q):
        return exact_topk(q, db_d, norms_d, np.int32(n), k,
                          DistanceMetric.COSINE, precision="high")

    got3 = np.asarray(run3(jax.device_put(qc))[1])
    recall3 = _recall(got3, oi, k)
    dt3 = _measure(run3, mk2, iters=15)
    _report(
        f"gist1m(n={n},960d,cos,k=10,{qb2}q,high)",
        qb2 / dt3, dt3 * 1e3, recall3, "'high' precision (three bf16 dots)",
    )

    # Verified-'high': the 'high' scan over-fetches k+margin and
    # a microscopic exact (f32 HIGHEST) pass rescores just those
    # candidates — recall 1.000 at ≈'high' throughput. This is the
    # device work of SearchEngine(precision="high_verified"); the
    # host-side certification (a [qb] compare against the fetch
    # boundary + eps) costs ~µs and its sub-ulp fallback fires ~never
    # (engine tests plant the degenerate ties).
    from metrovector_tpu.ops.distances import rescore_topk

    margin = 8

    def run4(q):
        _, cand = exact_topk(q, db_d, norms_d, np.int32(n), k + margin,
                             DistanceMetric.COSINE, precision="high")
        return rescore_topk(q, db_d, norms_d, cand, k,
                            DistanceMetric.COSINE)

    got4 = np.asarray(run4(jax.device_put(qc))[1])
    recall4 = _recall(got4, oi, k)
    dt4 = _measure(run4, mk2, iters=15)
    _report(
        f"gist1m(n={n},960d,cos,k=10,{qb2}q,high_verified)",
        qb2 / dt4, dt4 * 1e3, recall4,
        f"'high' scan fetch k+{margin} + exact f32 rescore "
        "(engine precision=high_verified)",
    )


def bench_deep10m():
    import jax

    from metrovector_tpu.format.constants import DistanceMetric
    from metrovector_tpu.ops import exact_topk

    rng = np.random.default_rng(4)
    n, d, k, qb = 10_000_000, 96, 10, 128
    pd = 128
    codes = np.zeros((n, pd), np.int8)
    codes[:, :d] = rng.integers(-128, 128, (n, d)).astype(np.int8)
    sc = 0.02
    norms = ((codes.astype(np.float32) * sc) ** 2).sum(1)
    db_d, norms_d = put_chunked(codes), jax.device_put(norms)
    jax.block_until_ready((db_d, norms_d))

    def mk():
        q = np.zeros((qb, pd), np.int8)
        q[:, :d] = rng.integers(-128, 128, (qb, d)).astype(np.int8)
        return q

    def run(q):
        return exact_topk(q, db_d, norms_d, np.int32(n), k,
                          DistanceMetric.INNER_PRODUCT, scale=sc * sc)

    qc = mk()[:4]
    got = np.asarray(run(jax.device_put(qc))[1])
    dots = qc[:, :d].astype(np.float64) @ codes[:, :d].T.astype(np.float64)
    oi = np.argsort(-dots, 1, kind="stable")[:, :k]
    recall = _recall(got, oi, k)
    dt = _measure(run, mk, iters=10)
    _report(f"deep10m(n={n},96d,int8 dot,k=10,{qb}q)", qb / dt, dt * 1e3,
            recall, "0.96 GB int8 corpus, integer dot")


def bench_stream():
    import tempfile, os

    from metrovector_tpu import Builder, DataType, Reader
    from metrovector_tpu.format.constants import DistanceMetric
    from metrovector_tpu.ops import numpy_oracle
    from metrovector_tpu.parallel import StreamingSearcher

    rng = np.random.default_rng(5)
    n, d, qb = 1_000_000, 768, 16
    data = rng.standard_normal((n, d)).astype(np.float16)
    b = Builder()
    b.add_vector_space("s", dim=d, dtype=DataType.FLOAT16)
    b.add_vectors("s", data)
    path = os.path.join(tempfile.mkdtemp(), "stream.mvt")
    b.build().save(path)
    sp = Reader.open(path).vector_space("s")
    searcher = StreamingSearcher(sp, chunk_rows=262_144)
    queries = rng.standard_normal((qb, d)).astype(np.float32)
    searcher.search(queries, k=10)  # warm compile (same batch shape!)
    t0 = time.perf_counter()
    res = searcher.search(queries, k=10)
    dt = time.perf_counter() - t0
    # Recall gate vs a NumPy f64 oracle on a corpus subsample containing
    # each query's streamed winners plus 50k random rows.
    sub_rows = np.unique(
        np.concatenate([res.indices[:4].ravel(), rng.integers(0, n, 50_000)])
    )
    sub = data[sub_rows].astype(np.float32)
    _, oi = numpy_oracle(queries[:4], sub, 10, DistanceMetric.L2)
    remapped = sub_rows[oi]
    recall = _recall(res.indices[:4], remapped, 10)
    # Overlap-efficiency diagnostic (device-side number for the streamed
    # config): device compute time for the same scan with the corpus
    # resident. streamed_wall / resident_device ≈ how much the upload
    # pipeline inflates the scan on this host.

    import jax

    from metrovector_tpu.ops import exact_topk

    block32 = data.astype(np.float32)
    norms32 = np.einsum(
        "ij,ij->i", block32, block32, dtype=np.float64
    ).astype(np.float32)
    db_d = jax.device_put(block32)
    nm_d = jax.device_put(norms32)
    jax.block_until_ready((db_d, nm_d))
    qd = jax.device_put(queries)
    _ = np.asarray(
        exact_topk(qd, db_d, nm_d, np.int32(n), 10, DistanceMetric.L2)[1]
    )
    t0 = time.perf_counter()
    outs = [
        exact_topk(qd, db_d, nm_d, np.int32(n), 10, DistanceMetric.L2)
        for _ in range(5)
    ]
    _ = np.asarray(outs[-1][1])
    dev = (time.perf_counter() - t0) / 5
    overlap_note = (
        f"; resident device scan {dev * 1e3:.1f} ms -> streamed wall is "
        f"{dt / dev:.0f}x device compute (host-bound upload)"
    )
    _report(
        f"stream(n={n},768d f16,k=10,{qb}q)", qb / dt, dt * 1e3, recall,
        f"{data.nbytes / 1e9:.1f} GB corpus streamed host->device in 384 MB "
        "chunks"
        + overlap_note,
    )


def _clustered_u8_corpus(rng, n, d, ncenters=4096, spread=12.0):
    """SIFT-like structured corpus: u8-valued rows around cluster centers.
    PQ/IVF-PQ recall on *uniform* random data is meaningless (there is no
    structure for a quantizer to exploit); real embedding corpora are
    strongly clustered, which this emulates."""
    centers = rng.integers(0, 256, (ncenters, d)).astype(np.float32)
    rows = centers[rng.integers(0, ncenters, n)]
    rows += rng.normal(0.0, spread, (n, d)).astype(np.float32)
    return np.clip(np.rint(rows), 0, 255).astype(np.float32)


def bench_sift1m_pq():
    """PQ ADC + exact re-rank: 16 B/row codes (32x memory compression)."""
    import jax
    import jax.numpy as jnp

    from metrovector_tpu.format.constants import DistanceMetric
    from metrovector_tpu.index.pq import PQIndex, _rerank
    from metrovector_tpu.index.pq import adc_topk

    rng = np.random.default_rng(6)
    n, d, k, rr = 1_000_000, 128, 10, 100
    qb = 256
    ksub = 256
    db = _clustered_u8_corpus(rng, n, d)
    log(f"training PQ m=16 ksub={ksub} ...")
    idx = PQIndex.build(
        db, DistanceMetric.L2, m=16, ksub=ksub,
        iters=4, keep_vectors=True,
    )
    books = jnp.asarray(idx.codebooks)
    nvalid = jnp.int32(n)

    def run(q):
        _, cand = adc_topk(
            q, idx.codes, books, idx.recon_norms, nvalid, rr,
            DistanceMetric.L2, exact_lut=False,
        )
        return _rerank(q, idx.db, idx.db_norms, cand, k, DistanceMetric.L2)

    def mkq(nq):
        base = db[rng.integers(0, n, nq)]
        return np.clip(base + rng.normal(0, 8, base.shape), 0, 255).astype(np.float32)

    qc = mkq(8)
    got = np.asarray(run(jax.device_put(qc))[1])
    d2 = (db.astype(np.float64) ** 2).sum(1)[None] - 2 * (
        qc.astype(np.float64) @ db.T.astype(np.float64)
    )
    oi = np.argsort(d2, 1, kind="stable")[:, :k]
    recall = _recall(got, oi, k)
    dt = _measure(run, lambda: mkq(qb), iters=20)
    _report(f"sift1m-pq(n={n},m=16,rerank={rr},k=10,{qb}q)", qb / dt, dt * 1e3,
            recall, "bf16 LUT-matmul ADC + f32 exact re-rank, 16 B/row codes")


def bench_sift1m_pq4():
    """4-bit plain PQ: m=32/ksub=16 — the SAME 16 B/row as the classic
    m=16/ksub=256 config, nibble-packed. Measured at rerank 100 and at the recall-1.0 operating point (rerank 400,
    per ``IVFPQIndex.recommended_rerank``-style guidance)."""
    import jax
    import jax.numpy as jnp

    from metrovector_tpu.format.constants import DistanceMetric
    from metrovector_tpu.index.pq import PQIndex, _rerank
    from metrovector_tpu.index.pq import adc_topk

    rng = np.random.default_rng(6)
    n, d, k = 1_000_000, 128, 10
    qb = 256
    ksub = 16
    db = _clustered_u8_corpus(rng, n, d)
    log(f"training PQ m=32 ksub={ksub} (pack4) ...")
    idx = PQIndex.build(
        db, DistanceMetric.L2, m=32, ksub=ksub,
        iters=4, keep_vectors=True, pack4=True,
    )
    books = jnp.asarray(idx.codebooks)
    nvalid = jnp.int32(n)

    def runner(rr):
        def run(q):
            _, cand = adc_topk(
                q, idx.codes, books, idx.recon_norms, nvalid, rr,
                DistanceMetric.L2, exact_lut=False, packed4=True,
            )
            return _rerank(q, idx.db, idx.db_norms, cand, k,
                           DistanceMetric.L2)
        return run

    def mkq(nq):
        base = db[rng.integers(0, n, nq)]
        return np.clip(base + rng.normal(0, 8, base.shape), 0, 255).astype(np.float32)

    qc = mkq(8)
    d2 = (db.astype(np.float64) ** 2).sum(1)[None] - 2 * (
        qc.astype(np.float64) @ db.T.astype(np.float64)
    )
    oi = np.argsort(d2, 1, kind="stable")[:, :k]
    for rr in (100, 400):
        run = runner(rr)
        got = np.asarray(run(jax.device_put(qc))[1])
        recall = _recall(got, oi, k)
        dt = _measure(run, lambda: mkq(qb), iters=20)
        _report(
            f"sift1m-pq4(n={n},m=32,ksub=16,rerank={rr},k=10,{qb}q)",
            qb / dt, dt * 1e3, recall,
            "4-bit nibble-packed ADC + f32 exact re-rank, 16 B/row codes",
        )

    # Filtered 4-bit PQ: a metadata predicate rides the ADC scan's
    # validity plane (PQIndex.search(filter_mask=...) — the candidates the
    # re-rank sees are all filter-passing), at the recall-1.0 operating
    # point. Oracle is masked-f64 over the ORIGINAL vectors, so recall
    # includes quantization loss within the filtered subset.
    rr = 400
    for sel in (0.5, 0.01):
        fmask = rng.random(n) < sel
        eff = idx._effective_mask(idx.prepare_filter(fmask))
        jax.block_until_ready(eff)

        def runf(q, eff=eff):
            _, cand = adc_topk(
                q, idx.codes, books, idx.recon_norms, nvalid, rr,
                DistanceMetric.L2, valid_mask=eff, exact_lut=False,
                packed4=True,
            )
            return _rerank(q, idx.db, idx.db_norms, cand, k,
                           DistanceMetric.L2)

        got = np.asarray(runf(jax.device_put(qc))[1])
        d2f = d2.copy()
        d2f[:, ~fmask] = np.inf
        oif = np.argsort(d2f, 1, kind="stable")[:, :k]
        recall = _recall(got, oif, k)
        dt = _measure(runf, lambda: mkq(qb), iters=20)
        _report(
            f"sift1m-pq4-filtered(n={n},rerank={rr},k=10,{qb}q,sel={sel})",
            qb / dt, dt * 1e3, recall,
            "metadata predicate in the ADC scan mask + filtered re-rank",
        )


def bench_sift1m_ivfpq():
    """IVF-PQ, both probing formulations.

    The classic probe walks the probed buckets with per-query LUT
    gathers; the gather-free **masked scan** runs dense ADC over the
    corpus with a per-(query, bucket) additive bias (q·centroid on probed
    buckets, −inf elsewhere) and serves exact nprobe semantics at
    full-scan throughput. Traversal remains the small-batch/latency
    option (``mode="auto"`` routes)."""
    import jax

    from metrovector_tpu.format.constants import DistanceMetric
    from metrovector_tpu.index.ivfpq import IVFPQIndex

    rng = np.random.default_rng(7)
    n, d, k, rr = 1_000_000, 128, 10, 100
    ncl, nprobe = (1024, 16)
    ksub = 256
    db = _clustered_u8_corpus(rng, n, d)
    log(f"training IVF-PQ C={ncl} m=16 ksub={ksub} ...")
    idx = IVFPQIndex.build(
        db, DistanceMetric.L2, num_clusters=ncl, m=16, ksub=ksub,
        iters=4, keep_vectors=True,
    )

    def mkq(nq):
        base = db[rng.integers(0, n, nq)]
        return np.clip(base + rng.normal(0, 8, base.shape), 0, 255).astype(np.float32)

    qc = mkq(8)
    d2 = (db.astype(np.float64) ** 2).sum(1)[None] - 2 * (
        qc.astype(np.float64) @ db.T.astype(np.float64)
    )
    oi = np.argsort(d2, 1, kind="stable")[:, :k]

    from metrovector_tpu.index.ivfpq import _ivfpq_search
    from metrovector_tpu.index.pq import _rerank
    import jax.numpy as jnp

    books = jnp.asarray(idx.codebooks)

    for mode, qb, rr in (
        ("scan", 256, rr),
        ("scan-recall1", 256, 400),
        ("probe", 8, rr),
    ):
        # Device-level calls so _measure's pipelined launches stay async
        # (idx.search reads back per call — fine for serving, wrong for
        # device-throughput measurement).
        if mode.startswith("scan"):
            def run(q, rr=rr):
                _, cand = idx._masked_scan(q, rr, nprobe)
                return _rerank(q, idx.db, idx.db_norms, cand, k,
                               DistanceMetric.L2)
        else:
            def run(q, rr=rr):
                _, cand = _ivfpq_search(
                    q, idx.probe_centroids, idx.buckets, idx.bucket_ids,
                    idx.bucket_norms, books,
                    k=rr, nprobe=nprobe, metric=DistanceMetric.L2,
                )
                return _rerank(q, idx.db, idx.db_norms, cand, k,
                               DistanceMetric.L2)

        import jax as _jax

        got = np.asarray(run(_jax.device_put(qc))[1])
        recall = _recall(got, oi, k)
        dt = _measure(run, lambda: mkq(qb), iters=15)
        _report(
            f"sift1m-ivfpq[{mode}](n={n},C={ncl},nprobe={nprobe},"
            f"rerank={rr},k=10,{qb}q)",
            qb / dt, dt * 1e3, recall,
            "gather-free masked-scan ADC" if mode.startswith("scan")
            else "bucket-traversal probe (latency/small-batch path)",
        )


def bench_sift1m_ivfpq4():
    """IVF-PQ with 4-bit nibble-packed residual codes (m=32, ksub=16 —
    the same 16 B/row as the 8-bit m=16/ksub=256 config): the masked
    scan unpacks the nibbles per block, with the gather-free bucket
    bias."""
    import jax
    import jax.numpy as jnp

    from metrovector_tpu.format.constants import DistanceMetric
    from metrovector_tpu.index.ivfpq import IVFPQIndex
    from metrovector_tpu.index.pq import _rerank

    rng = np.random.default_rng(7)
    n, d, k = 1_000_000, 128, 10
    ncl, nprobe = (1024, 16)
    m = 32
    db = _clustered_u8_corpus(rng, n, d)
    log(f"training IVF-PQ4 C={ncl} m={m} ksub=16 ...")
    idx = IVFPQIndex.build(
        db, DistanceMetric.L2, num_clusters=ncl, m=m, ksub=16,
        iters=4, keep_vectors=True, pack4=True,
    )
    assert idx.packed4

    def mkq(nq):
        base = db[rng.integers(0, n, nq)]
        return np.clip(
            base + rng.normal(0, 8, base.shape), 0, 255
        ).astype(np.float32)

    qc = mkq(8)
    d2 = (db.astype(np.float64) ** 2).sum(1)[None] - 2 * (
        qc.astype(np.float64) @ db.T.astype(np.float64)
    )
    oi = np.argsort(d2, 1, kind="stable")[:, :k]
    qb = 256

    for label, rr in (("scan", 100), ("scan-recall1", 400)):
        def run(q, rr=rr):
            _, cand = idx._masked_scan(q, rr, nprobe)
            return _rerank(q, idx.db, idx.db_norms, cand, k,
                           DistanceMetric.L2)

        got = np.asarray(run(jax.device_put(qc))[1])
        recall = _recall(got, oi, k)
        dt = _measure(run, lambda: mkq(qb), iters=15)
        _report(
            f"sift1m-ivfpq4[{label}](n={n},C={ncl},m={m},ksub=16,"
            f"nprobe={nprobe},rerank={rr},k=10,{qb}q)",
            qb / dt, dt * 1e3, recall,
            f"{m // 2} B/row nibble-packed residual codes; 4-bit ADC "
            "masked scan",
        )


def bench_deep100m_pq():
    """Capacity headline: 100M-row PQ-coded corpus resident on ONE chip
    (12 B/row → 1.2 GB codes + 0.4 GB norms; the same corpus as f32 would
    be 38 GB and as int8 still 9.6 GB). Throughput of the ADC scan over
    all 100M rows per query batch.

    Correctness gate: queries are exact reconstructions of planted rows —
    ADC scores are maximized by the row whose reconstruction equals the
    query, so each planted row must surface in its query's top-10."""
    import jax
    import jax.numpy as jnp

    from metrovector_tpu.format.constants import DistanceMetric
    from metrovector_tpu.index.pq import reconstruct_pq
    from metrovector_tpu.index.pq import adc_topk

    rng = np.random.default_rng(8)
    n = 100_000_000
    m, ksub, dsub, k, qb = 12, 256, 8, 10, 256
    d = m * dsub
    log(f"synthesizing {n / 1e6:.0f}M codes ({n * m / 1e9:.1f} GB) ...")
    codes = rng.integers(0, 256, (n, m), dtype=np.uint8)
    books = (rng.standard_normal((m, ksub, dsub)) * 0.5).astype(np.float32)
    b_norms = np.einsum("mkd,mkd->mk", books.astype(np.float64),
                        books.astype(np.float64))
    # ‖x̂‖² = Σ_j ‖C[j, code_j]‖² — computed by table lookup, no decode.
    rnorms = b_norms[np.arange(m)[None, :], codes.astype(np.int64)].sum(1)
    rnorms = rnorms.astype(np.float32)
    codes_d = jax.device_put(codes)
    rnorms_d = jax.device_put(rnorms)
    books_d = jax.device_put(books)
    jax.block_until_ready((codes_d, rnorms_d, books_d))
    nv = jnp.int32(n)

    def run(q):
        return adc_topk(
            q, codes_d, books_d, rnorms_d, nv, k, DistanceMetric.L2,
            exact_lut=False,
        )

    planted = rng.integers(0, n, 8)
    qc = reconstruct_pq(codes[planted], books)
    got = np.asarray(run(jax.device_put(qc))[1])
    hits = sum(planted[r] in got[r] for r in range(8))
    recall = hits / 8.0

    def mkq():
        rows = rng.integers(0, n, qb)
        return reconstruct_pq(codes[rows], books) + 0.05 * rng.standard_normal(
            (qb, d)
        ).astype(np.float32)

    dt = _measure(run, mkq, iters=8)
    _report(
        f"deep100m-pq(n={n},m=12,k=10,{qb}q)", qb / dt, dt * 1e3, recall,
        f"{n * m / 1e9:.1f} GB codes on one chip; planted-row gate",
    )


def bench_deep100m_pq4():
    """The 4-bit PQ capacity headline: m=24, ksub=16, nibble-packed — the
    SAME 12 B/row as the classic m=12/ksub=256 config."""
    import jax
    import jax.numpy as jnp

    from metrovector_tpu.format.constants import DistanceMetric
    from metrovector_tpu.index.pq import pack_codes4, reconstruct_pq
    from metrovector_tpu.index.pq import adc_topk

    rng = np.random.default_rng(8)
    n = 100_000_000
    m, ksub, dsub, k, qb = 24, 16, 4, 10, 256
    d = m * dsub
    log(f"synthesizing {n / 1e6:.0f}M 4-bit codes ({n * m / 2 / 1e9:.1f} GB packed) ...")
    codes = rng.integers(0, ksub, (n, m), dtype=np.uint8)
    books = (rng.standard_normal((m, ksub, dsub)) * 0.5).astype(np.float32)
    b_norms = np.einsum("mkd,mkd->mk", books.astype(np.float64),
                        books.astype(np.float64)).astype(np.float32)
    rnorms = np.empty(n, np.float32)
    step = 10_000_000
    for s in range(0, n, step):
        blk = codes[s : s + step].astype(np.int64)
        rnorms[s : s + step] = b_norms[np.arange(m)[None, :], blk].sum(1)
    packed_d = jax.device_put(pack_codes4(codes))
    rnorms_d = jax.device_put(rnorms)
    books_d = jax.device_put(books)
    jax.block_until_ready((packed_d, rnorms_d, books_d))
    nv = jnp.int32(n)

    def run(q):
        return adc_topk(
            q, packed_d, books_d, rnorms_d, nv, k, DistanceMetric.L2,
            exact_lut=False, packed4=True,
        )

    planted = rng.integers(0, n, 8)
    qc = reconstruct_pq(codes[planted], books)
    got = np.asarray(run(jax.device_put(qc))[1])
    recall = sum(planted[r] in got[r] for r in range(8)) / 8.0

    def mkq():
        rows = rng.integers(0, n, qb)
        return reconstruct_pq(codes[rows], books) + 0.05 * rng.standard_normal(
            (qb, d)
        ).astype(np.float32)

    dt = _measure(run, mkq, iters=8)
    _report(
        f"deep100m-pq4(n={n},m=24,ksub=16,k=10,{qb}q)", qb / dt, dt * 1e3,
        recall,
        f"{n * m / 2 / 1e9:.1f} GB nibble-packed codes on one chip; "
        "planted-row gate; 4-bit ADC",
    )


def bench_sift1m_filtered():
    """Filtered exact search (the vector-DB 'search within predicate'
    flow): the metadata row mask rides the scan's validity plane, so
    the filter costs one fused select — measured at 50% and 1%
    selectivity against a masked oracle. Reference analog: none (the
    reference has no filtering; its tombstone schema is the closest
    concept, `schema/types.fbs:35-39`)."""
    import jax

    from metrovector_tpu.format.constants import DistanceMetric
    from metrovector_tpu.ops import exact_topk

    rng = np.random.default_rng(11)
    n, d, k, qb = 1_000_000, 128, 10, 256
    db = rng.integers(0, 256, (n, d)).astype(np.float32)
    norms = np.einsum("ij,ij->i", db, db, dtype=np.float64).astype(np.float32)
    db_d, norms_d = jax.device_put(db), jax.device_put(norms)
    jax.block_until_ready((db_d, norms_d))

    for sel in (0.5, 0.01):
        mask = (rng.random(n) < sel).astype(np.float32)
        mask_d = jax.device_put(mask)  # = SearchEngine.prepare_filter
        jax.block_until_ready(mask_d)

        def run(q):
            return exact_topk(q, db_d, norms_d, np.int32(n), k,
                              DistanceMetric.L2, valid_mask=mask_d)

        qc = rng.integers(0, 256, (8, d)).astype(np.float32)
        got = np.asarray(run(jax.device_put(qc))[1])
        d2 = norms.astype(np.float64)[None] - 2 * (
            qc.astype(np.float64) @ db.T.astype(np.float64)
        )
        d2[:, mask == 0] = np.inf
        oi = np.argsort(d2, 1, kind="stable")[:, :k]
        recall = _recall(got, oi, k)
        dt = _measure(
            run,
            lambda: rng.integers(0, 256, (qb, d)).astype(np.float32),
            iters=20,
        )
        _report(
            f"sift1m-filtered(n={n},k={k},{qb}q,sel={sel})",
            qb / dt, dt * 1e3, recall,
            "metadata predicate as in-scan mask (prepared filter)",
        )


def bench_sparse1m():
    """Exact search over a SPARSE (CSR) corpus — SPLADE-scale: 1M rows,
    30k-dim vocabulary, ~48 nnz/row, inner product. The reference
    declares VectorType::Sparse but cannot encode or search it
    (`schema/types.fbs:14-17`, SURVEY.md §2 quirks)."""
    import jax

    from metrovector_tpu.format.constants import DistanceMetric
    from metrovector_tpu.sparse import _sparse_topk

    rng = np.random.default_rng(12)
    n = 1_000_000
    d, nnz_row, k, qb = 30_522, 48, 10, 256
    nnz = n * nnz_row
    cols = rng.integers(0, d, nnz).astype(np.int32)
    rows = np.repeat(np.arange(n, dtype=np.int32), nnz_row)
    vals = np.abs(rng.standard_normal(nnz)).astype(np.float32)
    # squared norms per row (exact segment sums on host)
    norms = np.add.reduceat(vals * vals, np.arange(0, nnz, nnz_row))
    norms = norms.astype(np.float32)

    nnz_chunk = 1 << 20
    pad = (-nnz) % nnz_chunk
    cols_p = np.pad(cols, (0, pad))
    rows_p = np.pad(rows, (0, pad), constant_values=n)
    vals_p = np.pad(vals, (0, pad))
    dev = jax.device_put
    cols_d, rows_d, vals_d, norms_d = (
        dev(cols_p), dev(rows_p), dev(vals_p), dev(norms)
    )
    jax.block_until_ready((cols_d, rows_d, vals_d, norms_d))

    def mk():
        # dense queries over the sparse vocabulary (the SPLADE serving
        # shape: query expansion is dense-ish, corpus is sparse)
        q = np.zeros((qb, d), np.float32)
        qc = rng.integers(0, d, (qb, 256))
        q[np.arange(qb)[:, None], qc] = np.abs(
            rng.standard_normal((qb, 256))
        ).astype(np.float32)
        return q

    def run(q):
        return _sparse_topk(q, cols_d, rows_d, vals_d, norms_d, None, k,
                            DistanceMetric.INNER_PRODUCT, n, nnz_chunk)

    qc = mk()[:4]
    got = np.asarray(run(jax.device_put(qc))[1])
    # host oracle: per-entry contributions reduced per row, f64
    contrib = qc.astype(np.float64)[:, cols] * vals.astype(np.float64)[None]
    dots = np.add.reduceat(contrib, np.arange(0, nnz, nnz_row), axis=1)
    oi = np.argsort(-dots.astype(np.float32), 1, kind="stable")[:, :k]
    recall = _recall(got, oi, k)
    dt = _measure(run, mk, iters=10)
    _report(
        f"sparse1m(n={n},d={d},nnz/row={nnz_row},k={k},{qb}q,coo)",
        qb / dt, dt * 1e3, recall,
        f"{nnz * 12 / 1e9:.2f} GB CSR on device; segment-sum scan",
    )

    # Scatter-free ELL formulation (the serving default): fixed-width
    # rows, embedding-style gather from queriesT, regular reduction.
    from metrovector_tpu.sparse import _ELL_ROW_PAD, _sparse_topk_ell

    del cols_d, rows_d, vals_d
    n_pad = -(-n // _ELL_ROW_PAD) * _ELL_ROW_PAD
    cols_ell = np.zeros((n_pad, nnz_row), np.int32)
    vals_ell = np.zeros((n_pad, nnz_row), np.float32)
    cols_ell[:n] = cols.reshape(n, nnz_row)
    vals_ell[:n] = vals.reshape(n, nnz_row)
    norms_pad = np.zeros(n_pad, np.float32)
    norms_pad[:n] = norms
    empty_i = np.zeros(256, np.int32)
    empty_f = np.zeros(256, np.float32)
    ce, ve, npd = dev(cols_ell), dev(vals_ell), dev(norms_pad)
    ei, ef = dev(empty_i), dev(empty_f)
    jax.block_until_ready((ce, ve, npd))
    b = _ELL_ROW_PAD
    while b > 1024 and b * nnz_row * qb * 4 > 400e6:
        b //= 2

    def run_ell(q):
        return _sparse_topk_ell(
            q, ce, ve, ei, ei, ef, npd, None, k,
            DistanceMetric.INNER_PRODUCT, n, b, 256, False,
        )

    got = np.asarray(run_ell(jax.device_put(qc))[1])
    recall = _recall(got, oi, k)
    dt = _measure(run_ell, mk, iters=10)
    _report(
        f"sparse1m(n={n},d={d},nnz/row={nnz_row},k={k},{qb}q,ell)",
        qb / dt, dt * 1e3, recall,
        f"{nnz * 8 / 1e9:.2f} GB ELL on device; scatter-free",
    )


CONFIGS = {
    "sim10k": bench_sim10k,
    "sift1m": bench_sift1m,
    "sift1m-u8": bench_sift1m_u8,
    "sift1m-pq": bench_sift1m_pq,
    "sift1m-pq4": bench_sift1m_pq4,
    "sift1m-ivfpq": bench_sift1m_ivfpq,
    "sift1m-ivfpq4": bench_sift1m_ivfpq4,
    "deep100m-pq": bench_deep100m_pq,
    "deep100m-pq4": bench_deep100m_pq4,
    "gist1m": bench_gist1m,
    "deep10m": bench_deep10m,
    "sift1m-filtered": bench_sift1m_filtered,
    "sparse1m": bench_sparse1m,
    "stream": bench_stream,
}


def main():
    from metrovector_tpu.utils import enable_compilation_cache
    from metrovector_tpu.utils.device import card_info, require_gpu

    dev = require_gpu()
    print(f"device: {json.dumps(dev)} card: {card_info()}", flush=True)
    log(f"compilation cache: {enable_compilation_cache()}")
    names = sys.argv[1:] or list(CONFIGS)
    for name in names:
        log(f"=== {name} ===")
        try:
            CONFIGS[name]()
        except Exception as exc:  # keep the suite running
            log(f"{name} failed: {exc}")
            _report(name, 0.0, 0.0, 0.0, f"FAILED: {exc}")


if __name__ == "__main__":
    main()
