"""Smoke run of the search system on one GPU, at full width, through the
public API (``Builder`` → ``save`` → ``Reader.open`` →
``validate_with_checksum`` → ``Database`` / ``SearchEngine`` /
``MicroBatcher``), with every result checked against an independent
float64 NumPy reference computed on the host in chunks.

Phases (all data generated from ``--seed``):

1. the ``gpu``-marked tests, in a child process, before this process
   touches the card (one JAX process per card);
2. SIFT1M-shaped exact search: 1M × 128 integer-valued f32, L2, k=10,
   batches of 256, through ``Database`` — plain and with a ``where=``
   predicate of selectivity 0.5; ids exact, ties included;
3. GIST1M-shaped precision ladder: 1M × 960 f32, cosine, k=10, at
   ``highest`` / ``high_verified`` (ids exact up to f32-resolution ties)
   and ``high`` / ``default`` (recall floors);
4. DEEP10M-shaped int8 (10M × 96, inner product) and SIFT1M-shaped uint8
   (1M × 128, L2, the offset-bias path); ids exact;
5. compressed search on a 1M × 128 clustered corpus: 8-bit PQ, 4-bit PQ
   and IVF-PQ (1024 lists, nprobe 16, scan mode) — ADC ids equal a NumPy
   ADC over the same codes, recall after rerank against the exact oracle;
6. serving and streaming: 64 concurrent single queries through
   ``Database.batcher`` equal the batched call bit for bit, and
   ``StreamingSearcher`` over phase 2's file (4 chunks) equals the resident
   engine.

``--devices 4`` runs only the four-card path: ``ShardedDeviceSpace``
row-sharded and ``grid_sharded_topk`` on a 2 × 2 mesh over 4M × 128 f32,
each compared with the oracle and with the one-card engine.

Each phase prints one line with its sizes, compile+first-run and run wall
times, the card's name and power limit, and the device's peak bytes in
use. Any failed check exits non-zero. The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
The script refuses to run (non-zero exit, no result) without a GPU or
outside a checkout of the repository.

Usage: ``python chip_smoke.py [--seed 0] [--devices 1|4]``
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA_DIR = os.path.join(ROOT, ".smoke_data")
K = 10
ORACLE_Q = 32  # queries checked against the f64 reference per phase
BATCH = 256


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


# ----------------------------------------------------------- reference ---


def host_topk(queries, rows_fn, n, k, metric, mask=None, chunk=131072):
    """Exact top-k in float64 on the host: ``rows_fn(lo, hi)`` returns rows
    ``lo:hi`` as float64; scores follow the engine's greater-is-better
    convention (L2: 2q·x − ‖x‖², IP: q·x, cosine: q̂·x/‖x‖); ties go to the
    lowest row index. Returns (scores [Q, k] f64, ids [Q, k])."""
    q = np.asarray(queries, np.float64)
    if metric == "cosine":
        q = q / np.linalg.norm(q, axis=1, keepdims=True)
    cand_s, cand_i = [], []
    for lo in range(0, n, chunk):
        hi = min(n, lo + chunk)
        x = rows_fn(lo, hi)
        s = q @ x.T
        if metric == "l2":
            s = 2.0 * s - np.einsum("ij,ij->i", x, x)[None]
        elif metric == "cosine":
            s = s / np.sqrt(np.maximum(np.einsum("ij,ij->i", x, x), 1e-300))[None]
        if mask is not None:
            s = np.where(mask[lo:hi][None], s, -np.inf)
        kk = min(k, hi - lo)
        kth = -np.partition(-s, kk - 1, axis=1)[:, kk - 1:kk]
        for r in range(len(q)):
            sel = np.nonzero(s[r] >= kth[r])[0]
            cand_s.append((r, s[r, sel]))
            cand_i.append((r, sel + lo))
    out_s = np.full((len(q), k), -np.inf)
    out_i = np.full((len(q), k), -1, np.int64)
    per_s = [[] for _ in range(len(q))]
    per_i = [[] for _ in range(len(q))]
    for (r, s), (_, i) in zip(cand_s, cand_i):
        per_s[r].append(s)
        per_i[r].append(i)
    for r in range(len(q)):
        s = np.concatenate(per_s[r])
        i = np.concatenate(per_i[r])
        order = np.lexsort((i, -s))[:k]
        out_s[r, : len(order)] = s[order]
        out_i[r, : len(order)] = i[order]
    return out_s, out_i


def compare_ids(got, want_ids, score_of, tol):
    """Ids must equal the reference's; a differing position is accepted
    only when the two rows' float64 scores lie within ``tol`` (an
    f32-resolution tie). Returns the number of such ties."""
    got = np.asarray(got)
    ties = 0
    for r in range(want_ids.shape[0]):
        for c in range(want_ids.shape[1]):
            a, b = int(got[r, c]), int(want_ids[r, c])
            if a == b:
                continue
            check(a >= 0, f"query {r} rank {c}: unfilled slot, want row {b}")
            gap = abs(score_of(r, a) - score_of(r, b))
            check(gap <= tol, f"query {r} rank {c}: row {a} vs {b}, "
                              f"score gap {gap:.3e} > tolerance {tol:.3e}")
            ties += 1
    return ties


def recall_at(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.mean([len(set(got[r]) & set(want[r])) / want.shape[1]
                          for r in range(want.shape[0])]))


# ---------------------------------------------------------- reporting ---


class Phase:
    """Times one phase and prints its line: sizes, compile+first-run and
    run wall seconds, card, peak device bytes."""

    def __init__(self, num, name, card, sizes):
        self.num, self.name, self.card, self.sizes = num, name, card, sizes
        self.compile_s = 0.0
        self.run_s = 0.0
        self.notes = {}

    def twice(self, label, fn):
        """Call ``fn`` (which returns host arrays) twice: the first call
        pays the compile, the second is the run time. Both are kept per
        ``label`` and summed over the phase."""
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        out = fn()
        t2 = time.perf_counter()
        self.compile_s += t1 - t0
        self.run_s += t2 - t1
        self.notes.setdefault("calls", {})[label] = {
            "compile_s": t1 - t0, "run_s": t2 - t1}
        return out

    def done(self):
        import jax

        stats = jax.devices()[0].memory_stats() or {}
        fields = {
            "phase": self.num, "name": self.name, "sizes": self.sizes,
            "compile_s": self.compile_s, "run_s": self.run_s,
            "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
            "card": self.card, **self.notes,
        }
        print("phase " + json.dumps(fields), flush=True)


def build_file(path, name, data, metric, dtype=None, quant=None,
               columns=None):
    """Builder → save → Reader.open → validate_with_checksum."""
    from metrovector_tpu import Builder, DataType, Reader

    b = Builder()
    h = b.add_vector_space(name, dim=data.shape[1], metric=metric,
                           dtype=dtype or DataType.FLOAT32)
    if quant is not None:
        h.with_quantization(*quant)
    b.add_vectors(name, data)
    for col, values in (columns or {}).items():
        b.add_metadata_column(name, col, values)
    b.build().save(path)
    r = Reader.open(path)
    r.validate_with_checksum()
    return r


# ------------------------------------------------------------ phases ---


def phase_gpu_tests(card):
    """Phase 1: the gpu-marked tests in a child process (before this
    process opens the card)."""
    t0 = time.perf_counter()
    env = dict(os.environ, JAX_PLATFORMS="cuda")
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "-m", "gpu", "tests", "-q",
         "-o", "addopts=", "-p", "no:cacheprovider", "-rs"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600,
    )
    tail = out.stdout.strip().splitlines()[-1] if out.stdout.strip() else ""
    print("phase " + json.dumps({
        "phase": 1, "name": "gpu-marked tests", "summary": tail,
        "wall_s": time.perf_counter() - t0, "card": card,
    }), flush=True)
    check(out.returncode == 0, f"gpu tests failed:\n{out.stdout[-4000:]}"
                               f"\n{out.stderr[-2000:]}")
    check("passed" in tail and "skipped" not in tail,
          f"gpu tests did not all run: {tail}")


def phase_sift_exact(card, rng):
    """Phase 2: 1M × 128 integer-valued f32, L2, through Database."""
    from metrovector_tpu import Database, DistanceMetric

    n, d = 1_000_000, 128
    data = rng.integers(0, 256, (n, d)).astype(np.float32)
    half = (np.arange(n) % 2).astype(np.int64)  # selectivity 0.5
    path = os.path.join(DATA_DIR, "sift.mvt")
    build_file(path, "sift", data, DistanceMetric.L2,
               columns={"half": half})
    db = Database.open(path)
    ph = Phase(2, "sift1m exact", card,
               {"rows": n, "dim": d, "k": K, "batch": BATCH,
                "metric": "l2", "precision": "highest"})
    queries = rng.integers(0, 256, (BATCH, d)).astype(np.float32)
    res = ph.twice("plain", lambda: db.search("sift", queries, k=K))
    resf = ph.twice("where", lambda: db.search("sift", queries, k=K,
                                      where=("half", "==", 0)))
    rows = lambda lo, hi: data[lo:hi].astype(np.float64)  # noqa: E731
    _, oi = host_topk(queries[:ORACLE_Q], rows, n, K, "l2")
    check(np.array_equal(res.indices[:ORACLE_Q], oi),
          "sift1m: ids differ from the f64 reference")
    _, oif = host_topk(queries[:ORACLE_Q], rows, n, K, "l2", mask=half == 0)
    check(np.array_equal(resf.indices[:ORACLE_Q], oif),
          "sift1m where=: ids differ from the masked f64 reference")
    ph.notes["ids_exact"] = True
    ph.done()
    return path, data, db, queries


def phase_gist_ladder(card, rng):
    """Phase 3: 1M × 960 f32 cosine at every precision."""
    from metrovector_tpu import DistanceMetric, SearchEngine

    n, d = 1_000_000, 960
    data = rng.standard_normal((n, d), dtype=np.float32)
    path = os.path.join(DATA_DIR, "gist.mvt")
    reader = build_file(path, "gist", data, DistanceMetric.COSINE)
    queries = rng.standard_normal((BATCH, d), dtype=np.float32)
    rows = lambda lo, hi: data[lo:hi].astype(np.float64)  # noqa: E731
    os_, oi = host_topk(queries[:ORACLE_Q], rows, n, K, "cosine",
                        chunk=65536)
    qn = queries[:ORACLE_Q].astype(np.float64)
    qn /= np.linalg.norm(qn, axis=1, keepdims=True)

    def score_of(r, i):
        x = data[i].astype(np.float64)
        return float(qn[r] @ x / np.linalg.norm(x))

    floors = {"high": 0.99, "default": 0.9}
    ph = Phase(3, "gist1m precision ladder", card,
               {"rows": n, "dim": d, "k": K, "batch": BATCH,
                "metric": "cosine"})
    for prec in ("highest", "high_verified", "high", "default"):
        eng = SearchEngine(reader.vector_space("gist"), precision=prec)
        res = ph.twice(prec, lambda: eng.search(queries, k=K))
        got = res.indices[:ORACLE_Q]
        if prec in floors:
            rec = recall_at(got, oi)
            ph.notes[f"recall@10_{prec}"] = rec
            ph.notes[f"recall_floor_{prec}"] = floors[prec]
            check(rec >= floors[prec],
                  f"gist1m {prec}: recall {rec:.4f} < {floors[prec]}")
        else:
            ties = compare_ids(got, oi, score_of, tol=2.0 ** -20)
            ph.notes[f"f32_ties_{prec}"] = ties
        if prec == "high_verified":
            ph.notes["verify_stats"] = dict(eng.verify_stats)
        del eng
    ph.done()
    del data, reader


def phase_quantized(card, rng):
    """Phase 4: DEEP10M-shaped int8 (IP) and SIFT1M-shaped uint8 (L2)."""
    from metrovector_tpu import DataType, DistanceMetric, SearchEngine

    n, d = 10_000_000, 96
    codes = rng.integers(-127, 128, (n, d), dtype=np.int8)
    path = os.path.join(DATA_DIR, "deep.mvt")
    reader = build_file(path, "deep", codes, DistanceMetric.INNER_PRODUCT,
                        dtype=DataType.INT8, quant=(1.0, 0.0))
    queries = rng.integers(-127, 128, (BATCH, d)).astype(np.float32)
    queries[0, 0] = 127.0  # the batch's max |q| is 127: exact quantization
    ph = Phase(4, "deep10m int8 + sift1m uint8", card,
               {"int8": {"rows": n, "dim": d, "metric": "ip"},
                "uint8": {"rows": 1_000_000, "dim": 128, "metric": "l2"},
                "k": K, "batch": BATCH})
    eng = SearchEngine(reader.vector_space("deep"))
    res = ph.twice("int8", lambda: eng.search(queries, k=K))
    rows = lambda lo, hi: codes[lo:hi].astype(np.float64)  # noqa: E731
    _, oi = host_topk(queries[:ORACLE_Q], rows, n, K, "ip", chunk=500_000)
    check(np.array_equal(res.indices[:ORACLE_Q], oi),
          "deep10m int8: ids differ from the f64 reference")
    del eng, reader, codes

    n8, d8 = 1_000_000, 128
    u8 = rng.integers(0, 256, (n8, d8), dtype=np.uint8)
    path8 = os.path.join(DATA_DIR, "sift_u8.mvt")
    reader8 = build_file(path8, "u8", u8, DistanceMetric.L2,
                         dtype=DataType.UINT8, quant=(1.0, 0.0))
    q8 = rng.integers(0, 255, (BATCH, d8)).astype(np.float32)
    eng8 = SearchEngine(reader8.vector_space("u8"))
    res8 = ph.twice("uint8", lambda: eng8.search(q8, k=K))
    rows8 = lambda lo, hi: u8[lo:hi].astype(np.float64)  # noqa: E731
    _, oi8 = host_topk(q8[:ORACLE_Q], rows8, n8, K, "l2")
    check(np.array_equal(res8.indices[:ORACLE_Q], oi8),
          "sift1m uint8: ids differ from the f64 reference")
    ph.notes["ids_exact"] = True
    ph.done()


def numpy_adc(q, codes, books, rnorms, bias=None):
    """f64 ADC scores [Q, N] of ``q`` over PQ ``codes`` (L2 convention),
    plus an optional per-row additive ``bias`` [Q, N] (IVF-PQ's q·c)."""
    m, _, dsub = books.shape
    lut = np.einsum("qmd,mkd->qmk",
                    q.astype(np.float64).reshape(len(q), m, dsub),
                    books.astype(np.float64))
    dots = np.zeros((len(q), codes.shape[0]))
    for j in range(m):
        dots += lut[:, j, codes[:, j].astype(np.int64)]
    if bias is not None:
        dots = dots + bias
    return 2.0 * dots - rnorms.astype(np.float64)[None]


def topk_rows(scores, k):
    """Lowest-index-first top-k of a dense f64 score matrix."""
    return np.stack([np.lexsort((np.arange(s.size), -s))[:k] for s in scores])


def phase_compressed(card, rng):
    """Phase 5: PQ 8-bit, PQ 4-bit, IVF-PQ scan on a clustered corpus."""
    from metrovector_tpu import DistanceMetric
    from metrovector_tpu.index.ivfpq import IVFPQIndex
    from metrovector_tpu.index.pq import PQIndex, unpack_codes4

    n, d = 1_000_000, 128
    centers = rng.standard_normal((4096, d), dtype=np.float32) * 3.0
    data = centers[rng.integers(0, 4096, n)] + rng.standard_normal(
        (n, d), dtype=np.float32)
    queries = data[rng.integers(0, n, BATCH)] + 0.5 * rng.standard_normal(
        (BATCH, d), dtype=np.float32)
    rows = lambda lo, hi: data[lo:hi].astype(np.float64)  # noqa: E731
    _, exact_i = host_topk(queries[:ORACLE_Q], rows, n, K, "l2")
    qo = queries[:ORACLE_Q]
    ph = Phase(5, "compressed search", card,
               {"rows": n, "dim": d, "k": K, "batch": BATCH, "metric": "l2",
                "pq8": "m=16 ksub=256", "pq4": "m=32 ksub=16 packed",
                "ivfpq": "1024 lists nprobe=16 m=16 ksub=256 scan"})
    tol = 2.0 ** -18
    for label, m, ksub, pack in (("pq8", 16, 256, False),
                                 ("pq4", 32, 16, True)):
        t0 = time.perf_counter()
        idx = PQIndex.build(data, DistanceMetric.L2, m=m, ksub=ksub,
                            iters=10, pack4=pack)
        ph.notes[f"{label}_build_s"] = time.perf_counter() - t0
        adc = ph.twice(f"{label}_adc", lambda: idx.search(queries, k=K,
                                                         exact_lut=True))
        codes = np.asarray(idx.codes)[:n]
        if pack:
            codes = unpack_codes4(codes, m)
        s64 = numpy_adc(qo, codes, idx.codebooks, np.asarray(idx.recon_norms)[:n])
        oi = topk_rows(s64, K)
        ph.notes[f"{label}_adc_f32_ties"] = compare_ids(
            adc.indices[:ORACLE_Q], oi, lambda r, i: s64[r, i],
            tol * np.abs(s64).max())
        rr = ph.twice(f"{label}_rerank400",
                      lambda: idx.search(queries, k=K, rerank=400))
        ph.notes[f"{label}_recall@10_rerank400"] = recall_at(
            rr.indices[:ORACLE_Q], exact_i)
        del idx
    t0 = time.perf_counter()
    ivf = IVFPQIndex.build(data, DistanceMetric.L2, num_clusters=1024, m=16,
                           ksub=256, iters=10)
    ph.notes["ivfpq_build_s"] = time.perf_counter() - t0
    res = ph.twice("ivfpq_adc", lambda: ivf.search(
        queries, k=K, nprobe=16, mode="scan", exact_lut=True))
    pc = np.asarray(ivf.probe_centroids, np.float64)
    cdots = qo.astype(np.float64) @ pc.T
    cs = 2 * cdots - (pc ** 2).sum(1)[None]
    probed = cs >= -np.partition(-cs, 15, axis=1)[:, 15:16]
    rb = np.asarray(ivf.row_bucket)[:n]
    bias = np.where(
        (rb >= 0)[None] & np.take_along_axis(
            probed, np.maximum(rb, 0)[None].repeat(len(qo), 0), 1),
        cdots[:, np.maximum(rb, 0)], -np.inf)
    s64 = numpy_adc(qo, np.asarray(ivf.codes_row)[:n], ivf.codebooks,
                    np.asarray(ivf.rnorms_row)[:n], bias)
    oi = topk_rows(s64, K)
    finite = np.abs(s64[np.isfinite(s64)]).max()
    ph.notes["ivfpq_adc_f32_ties"] = compare_ids(
        res.indices[:ORACLE_Q], oi, lambda r, i: s64[r, i], tol * finite)
    rr = ph.twice("ivfpq_rerank400", lambda: ivf.search(
        queries, k=K, nprobe=16, mode="scan", rerank=400))
    ph.notes["ivfpq_recall@10_rerank400"] = recall_at(
        rr.indices[:ORACLE_Q], exact_i)
    ph.done()


def phase_serving_streaming(card, path, db, queries):
    """Phase 6: MicroBatcher vs the batched call; streaming vs resident."""
    from metrovector_tpu import Reader
    from metrovector_tpu.parallel import StreamingSearcher

    q64 = queries[:64]
    ph = Phase(6, "serving + streaming", card,
               {"rows": 1_000_000, "dim": 128, "k": K, "clients": 64,
                "stream_chunk_rows": 262144})
    direct = db.search("sift", q64, k=K)

    def serve():
        results = [None] * 64
        with db.batcher("sift", k=K, max_batch=64, max_wait_ms=50.0) as mb:
            def client(i):
                results[i] = mb.submit(q64[i]).result(timeout=300)
            ts = [threading.Thread(target=client, args=(i,))
                  for i in range(64)]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
            ph.notes["batcher_batches"] = mb.stats().batches
        return results

    served = ph.twice("batcher_64_clients", serve)
    for i, r in enumerate(served):
        check(np.array_equal(r.indices[0], direct.indices[i])
              and np.array_equal(r.scores[0], direct.scores[i]),
              f"batcher query {i} differs from the batched call")
    sp = Reader.open(path).vector_space("sift")
    searcher = StreamingSearcher(sp, chunk_rows=262144)
    ph.notes["stream_chunks"] = -(-sp.padded_rows // searcher.chunk_rows)
    check(ph.notes["stream_chunks"] >= 4, "streaming used fewer than 4 chunks")
    streamed = ph.twice("streaming", lambda: searcher.search(queries, k=K))
    resident = db.engine("sift").search(queries, k=K)
    check(np.array_equal(streamed.indices, resident.indices)
          and np.array_equal(streamed.scores, resident.scores),
          "streamed search differs from the resident engine")
    ph.notes["bit_identical"] = True
    ph.done()


def phase_four_cards(card, rng):
    """--devices 4: row-sharded and 2 × 2 grid-sharded search over
    4M × 128, against the oracle and the one-card engine."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from metrovector_tpu import DistanceMetric, SearchEngine
    from metrovector_tpu.engine import DeviceSpace
    from metrovector_tpu.parallel import (
        ShardedDeviceSpace, grid_sharded_topk, make_mesh, make_mesh_2d,
        shard_rows,
    )

    check(len(jax.devices()) == 4, f"need 4 GPUs, found {len(jax.devices())}")
    n, d = 4_000_000, 128
    data = rng.integers(0, 256, (n, d)).astype(np.float32)
    path = os.path.join(DATA_DIR, "sift4m.mvt")
    sp = build_file(path, "sift", data, DistanceMetric.L2).vector_space("sift")
    queries = rng.integers(0, 256, (BATCH, d)).astype(np.float32)
    rows = lambda lo, hi: data[lo:hi].astype(np.float64)  # noqa: E731
    _, oi = host_topk(queries[:ORACLE_Q], rows, n, K, "l2")
    ph = Phase(7, "four-card sharded search", card,
               {"rows": n, "dim": d, "k": K, "batch": BATCH, "metric": "l2",
                "row_mesh": 4, "grid_mesh": "2x2"})

    ds = ShardedDeviceSpace(sp, make_mesh(4))
    placed = {s.device.id: s.data.shape for s in ds.data.addressable_shards}
    ph.notes["row_shards"] = {str(k): list(v) for k, v in placed.items()}
    check(len(placed) == 4, f"row shards on {len(placed)} cards, want 4")
    rs = ph.twice("row_sharded", lambda: ds.search(queries, k=K))
    check(np.array_equal(rs.indices[:ORACLE_Q], oi),
          "row-sharded ids differ from the f64 reference")

    mesh2 = make_mesh_2d(2, 2)
    norms = np.einsum("ij,ij->i", data, data, dtype=np.float64).astype(
        np.float32)
    db_s = shard_rows(data, mesh2, axis="shard")
    nm_s = shard_rows(norms, mesh2, axis="shard")
    q_s = jax.device_put(queries, NamedSharding(mesh2, P("query", None)))
    placed2 = {s.device.id for s in db_s.addressable_shards}
    check(len(placed2) == 4, f"grid blocks on {len(placed2)} cards, want 4")
    gs = ph.twice("grid_2x2", lambda: tuple(np.asarray(a) for a in grid_sharded_topk(
        q_s, db_s, nm_s, n, K, DistanceMetric.L2, mesh2)))
    check(np.array_equal(gs[1][:ORACLE_Q], oi),
          "grid-sharded ids differ from the f64 reference")

    one = SearchEngine(DeviceSpace.from_space(sp, device=jax.devices()[0]))
    single = ph.twice("one_card", lambda: one.search(queries, k=K))
    check(np.array_equal(single.indices, rs.indices)
          and np.array_equal(single.indices, gs[1]),
          "sharded ids differ from the one-card engine")
    check(np.array_equal(single.scores, rs.scores),
          "row-sharded scores differ from the one-card engine")
    ph.notes["ids_exact"] = True
    ph.done()


# -------------------------------------------------------------- main ---


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--devices", type=int, choices=(1, 4), default=1)
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(ROOT, "metrovector_tpu")):
        log("chip_smoke: run from a checkout of the repository "
            "(metrovector_tpu/ not found next to this script)")
        return 2
    sys.path.insert(0, ROOT)
    from metrovector_tpu.utils.device import UNKNOWN_CARD, card_info

    platforms = os.environ.get("JAX_PLATFORMS", "")
    if platforms and not any(p in platforms for p in ("cuda", "gpu")):
        log(f"chip_smoke: JAX_PLATFORMS={platforms!r} excludes the GPU")
        return 2
    card = card_info()
    if card == UNKNOWN_CARD:
        log("chip_smoke: no GPU found (nvidia-smi cannot read a card)")
        return 2

    os.makedirs(DATA_DIR, exist_ok=True)
    try:
        if args.devices == 1:
            phase_gpu_tests(card)
        from metrovector_tpu.utils import enable_compilation_cache
        from metrovector_tpu.utils.device import require_gpu

        dev = require_gpu()
        log(f"compilation cache: {enable_compilation_cache()}")
        rng = np.random.default_rng(args.seed)
        if args.devices == 4:
            phase_four_cards(card, rng)
        else:
            path, _, db, queries = phase_sift_exact(card, rng)
            phase_gist_ladder(card, rng)
            phase_quantized(card, rng)
            phase_compressed(card, rng)
            phase_serving_streaming(card, path, db, queries)
    except SmokeFailure as exc:
        log(f"chip_smoke: FAILED: {exc}")
        return 1
    finally:
        shutil.rmtree(DATA_DIR, ignore_errors=True)
    print(card)
    print(json.dumps({"ok": True, "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
