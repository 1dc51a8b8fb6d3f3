"""Micro-batching serving front-end: many concurrent single-query callers,
one batched device launch.

The exact-search scan reaches its throughput on *batched* queries (the
scoring matmul ``[Q, dim] @ [dim, N]`` reads the corpus once per batch, so
a large Q amortizes the corpus read), but a service receives requests one
at a time on many threads. :class:`MicroBatcher` bridges the two shapes:

* callers :meth:`~MicroBatcher.submit` individual queries (or small query
  groups) from any thread and receive a ``concurrent.futures.Future``;
* a single worker thread drains the queue, coalescing requests until either
  ``max_batch`` query rows are gathered or ``max_wait_ms`` has elapsed since
  the oldest queued request — the standard latency/throughput knob pair;
* the coalesced rows are padded up to a fixed **bucket ladder** of batch
  sizes (powers of two by default) so the device sees only ``O(log
  max_batch)`` distinct query shapes and every request after warmup hits a
  cached executable — an XLA-specific requirement with no analog in the
  reference's eager scan (each novel shape is a fresh trace+compile, which
  costs seconds);
* each caller's future resolves to a :class:`~.engine.SearchResult` holding
  exactly its own rows, bit-identical to a direct
  :meth:`~.engine.SearchEngine.search` call on the same coalesced batch.

Exactness is unchanged — batching composes queries, never corpus rows,
and the scan is deterministic per query row. Precisely: ranks always
match a direct call with any batching; scores are bit-identical to a
direct call of the same batch shape, but a *differently shaped* direct
call (e.g. the query alone) can differ in the last ulp on float data,
because the compiler may tile the scoring matmul differently per batch
shape (integer-valued data scores exactly either way). A per-request
``k`` below the
batcher's ``k`` is served by prefix-slicing (exact top-k is
prefix-consistent: the best ``k'<k`` of a query are the first ``k'`` of its
best ``k``).

Reference analog: none — the reference ships no serving layer (its
examples end at an in-process scan loop, ``examples/similarity_search.rs:
140-176``); this is part of the accelerator application layer (SURVEY.md
§5 "serving shapes").

Example::

    eng = SearchEngine.open("corpus.mvt")
    with MicroBatcher(eng, k=10, max_batch=256, max_wait_ms=2.0) as mb:
        fut = mb.submit(query_vec)          # from any thread
        res = fut.result()                  # SearchResult, 1 row
        res2 = mb.search(other_vec)         # submit + wait convenience
    print(mb.stats())
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Sequence

import numpy as np

from .errors import BatcherClosedError, DimensionMismatchError

__all__ = ["MicroBatcher", "BatcherStats"]


@dataclasses.dataclass
class BatcherStats:
    """Counters accumulated over a :class:`MicroBatcher`'s lifetime.

    ``occupancy`` is real query rows / padded kernel rows — how much of the
    device work served actual requests (1.0 = every kernel row was a real
    query). ``p50_ms``/``p99_ms`` are request latencies from ``submit`` to
    future resolution over a bounded sample of recent requests.
    """

    requests: int = 0
    rows: int = 0
    batches: int = 0
    # Coalescing windows drained by the worker. Without per-request
    # predicates ``windows == batches``; with them, one window launches
    # one batch per distinct predicate group it gathered — so
    # ``batches / windows`` is the live predicate diversity and
    # coalescing is healthy while ``rows / batches`` stays large.
    windows: int = 0
    padded_rows: int = 0
    p50_ms: float = 0.0
    p99_ms: float = 0.0

    @property
    def occupancy(self) -> float:
        return self.rows / self.padded_rows if self.padded_rows else 0.0


@dataclasses.dataclass
class _Request:
    rows: np.ndarray  # [m, dim] float-like, validated (bare vectors → m=1)
    k: int
    future: Future
    t_submit: float
    # Predicate-group key: None = the batcher's shared filter; requests
    # coalesce only within their group (same mask ⇒ same batch).
    group: Any = None
    # The request's own filter payload (PreparedFilter or raw mask).
    fmask: Any = None


_LAT_SAMPLE_CAP = 8192


class MicroBatcher:
    """Thread-safe micro-batching wrapper around a search engine.

    Parameters
    ----------
    engine:
        A :class:`~.engine.SearchEngine` (or any object with a compatible
        ``search(queries, k, filter_mask=...)`` returning an object with
        ``indices/scores/distances/metric/ids`` arrays, and a ``space.dim``
        attribute). The engine is used from the single worker thread only,
        so a plain engine needs no extra locking.
    k:
        Top-k depth of the batched kernel launches. Per-request ``k`` may
        be anything ``<= k`` (served by prefix slicing); requests needing a
        deeper k than the batcher's must use a separate batcher (k is part
        of the compiled kernel shape).
    max_batch:
        Coalescing cap in query rows; also the top rung of the bucket
        ladder. Align with the batch size the engine serves best.
    max_wait_ms:
        Maximum time the worker waits for more requests after the first
        queued one — the direct p50-latency/throughput trade. 0 disables
        coalescing-by-time (each drain takes whatever is already queued).
    filter_mask:
        Optional shared ``[num_vectors]`` row predicate applied to every
        request that doesn't carry its own (e.g. a tenant filter);
        prepared once on-device via ``engine.prepare_filter`` when the
        engine supports it. Per-request predicates go through
        :meth:`submit`'s ``filter_mask=`` and coalesce **by predicate
        group** — see there.
    buckets:
        Ascending batch-size ladder to pad drained batches onto. Default:
        powers of two from 1 to ``max_batch``. Batches larger than the top
        rung (a single multi-row request may exceed ``max_batch``) run
        unpadded at their natural size.
    max_queue:
        Bound on queued requests; ``submit`` blocks when full
        (backpressure) rather than growing without limit.
    pipeline:
        Opt-in: keep **one batch in flight** — a dedicated finalizer
        thread reads back batch ``i``'s results while the worker drains,
        uploads and launches batch ``i+1``, so the coalescing window and
        the host→device upload ride the device→host readback instead of
        following it (the serving analog of
        ``SearchEngine.search_pipelined``). Only worthwhile where a
        readback and an upload genuinely proceed concurrently; its effect
        on the card is not measured yet. Default off. Requires an engine
        with the ``_launch``/``_finalize`` split (``SearchEngine`` has
        it).
    search_kwargs:
        Extra keyword arguments forwarded to every ``engine.search``
        call (plain mode only) — e.g. ``{"rerank": 400}`` when the engine
        is a PQ index.
    """

    def __init__(
        self,
        engine: Any,
        k: int = 10,
        max_batch: int = 256,
        max_wait_ms: float = 2.0,
        filter_mask=None,
        buckets: Sequence[int] | None = None,
        max_queue: int = 8192,
        pipeline: bool = False,
        search_kwargs: dict | None = None,
    ):
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.engine = engine
        self.k = int(k)
        self.max_batch = int(max_batch)
        self.max_wait_s = max(0.0, float(max_wait_ms)) / 1e3
        if buckets is None:
            buckets = []
            b = 1
            while b < max_batch:
                buckets.append(b)
                b *= 2
            buckets.append(max_batch)
        self.buckets = sorted(set(int(b) for b in buckets))
        if self.buckets[0] < 1:
            raise ValueError("bucket sizes must be >= 1")
        self._filter = None
        if filter_mask is not None:
            prep = getattr(engine, "prepare_filter", None)
            self._filter = prep(filter_mask) if prep else filter_mask
        splittable = hasattr(engine, "_launch") and hasattr(engine, "_finalize")
        if pipeline and not splittable:
            raise ValueError(
                "pipeline=True needs an engine with the _launch/_finalize "
                "split (SearchEngine has it)"
            )
        self.pipeline = bool(pipeline)
        # SearchEngine wraps a space; mesh-level objects
        # (ShardedDeviceSpace, StreamingSearcher facades) carry dim
        # directly and are accepted as engines themselves
        self._dim = int(getattr(engine, "space", engine).dim)
        self._search_kwargs = dict(search_kwargs or {})
        # raw per-request masks, prepared on-device once per predicate
        # group (worker thread only) and LRU-capped
        self._fcache: dict = {}
        self._fcache_cap = 32
        self._q: queue.Queue = queue.Queue(maxsize=max_queue)
        self._closed = False
        self._lock = threading.Lock()
        self._stats = BatcherStats()
        self._lat_ms: list[float] = []
        self._worker = threading.Thread(
            target=self._run, name="mvt-microbatcher", daemon=True
        )
        self._worker.start()

    # -- client surface ---------------------------------------------------

    def submit(self, query, k: int | None = None,
               filter_mask=None) -> Future:
        """Enqueue one query (``[dim]``) or query group (``[m, dim]``);
        returns a future resolving to that request's own
        :class:`~.engine.SearchResult` (``[1, k]`` rows for a bare vector).
        Shape errors raise here, immediately — a malformed request never
        reaches the worker, so it cannot fail other callers' batch.

        ``filter_mask``: optional per-request row predicate — a
        ``PreparedFilter`` (from ``engine.prepare_filter``; the fast
        serving shape for a set of hot predicates) or a raw
        ``[num_vectors]`` boolean/int mask. Requests coalesce **by
        predicate group**: same prepared filter object (or byte-identical
        raw mask) ⇒ same batch; a drain window holding several distinct
        predicates launches one batch per group, so coalescing survives a
        handful of live predicates (``stats().windows`` vs ``batches``
        shows the diversity). Raw masks are prepared on-device once per
        group and LRU-cached. A per-request mask **replaces** the
        batcher's shared ``filter_mask`` for that request — AND them
        host-side first if both must apply. Results are bit-identical to
        a direct ``engine.search(..., filter_mask=...)`` call."""
        if self._closed:
            raise BatcherClosedError("submit() after close()")
        kk = self.k if k is None else int(k)
        if not (1 <= kk <= self.k):
            raise ValueError(
                f"per-request k must be in [1, {self.k}] (the batcher's "
                f"compiled depth), got {kk}"
            )
        q = np.asarray(query)
        if q.ndim == 1:
            q = q[None, :]
        if q.ndim != 2 or q.shape[1] != self._dim:
            raise DimensionMismatchError(
                expected=self._dim,
                actual=q.shape[-1] if q.ndim else 0,
            )
        if q.shape[0] == 0:
            raise ValueError("empty query group")
        group = fmask = None
        if filter_mask is not None:
            if hasattr(filter_mask, "mask"):  # prepared: identity-keyed
                group, fmask = ("prep", id(filter_mask)), filter_mask
            else:
                fm = np.asarray(filter_mask)
                n = getattr(
                    getattr(self.engine, "space", None), "num_valid", None
                )
                if n is None:
                    n = getattr(self.engine, "num_vectors", None)
                if n is not None and fm.shape != (int(n),):
                    # validate HERE so a malformed mask can never fail an
                    # innocent batch in the worker
                    raise DimensionMismatchError(
                        expected=int(n),
                        actual=fm.shape[0] if fm.ndim == 1
                        else tuple(fm.shape),
                    )
                fm = np.ascontiguousarray(fm, dtype=bool)
                # group key = the mask BYTES, not their hash: dict
                # equality makes hash collisions harmless, where a
                # colliding 64-bit digest would silently serve one
                # group's requests under the other's predicate (the
                # bytes were already materialized for hashing either
                # way; the LRU cap bounds retained copies)
                group, fmask = ("mask", fm.tobytes()), fm
        fut: Future = Future()
        req = _Request(q, kk, fut, time.monotonic(), group, fmask)
        self._q.put(req)  # blocks when full: backpressure
        with self._lock:
            self._stats.requests += 1
            self._stats.rows += q.shape[0]
        if not self._worker.is_alive():
            # Either a raced close() (the request may sit behind the
            # shutdown sentinel where nothing will drain it) or the worker
            # died on an unexpected error — fail the future rather than
            # hang the caller (no-op if a drain already resolved it).
            try:
                fut.set_exception(
                    BatcherClosedError(
                        "submit() after close()" if self._closed
                        else "batcher worker thread is dead"
                    )
                )
            except Exception:  # already resolved by a final drain
                pass
        return fut

    def search(self, query, k: int | None = None, timeout: float | None = None):
        """Blocking convenience: :meth:`submit` then ``future.result()``."""
        return self.submit(query, k).result(timeout)

    def stats(self) -> BatcherStats:
        """Snapshot of lifetime counters (including latency percentiles
        over a bounded recent sample)."""
        with self._lock:
            s = dataclasses.replace(self._stats)
            lat = sorted(self._lat_ms)
        if lat:
            s.p50_ms = lat[len(lat) // 2]
            s.p99_ms = lat[min(len(lat) - 1, int(len(lat) * 0.99))]
        return s

    def close(self, timeout: float | None = None) -> None:
        """Stop accepting requests, flush everything already queued, and
        join the worker. Idempotent. Pending futures all resolve — unless
        ``timeout`` expires first, in which case the worker keeps flushing
        in the background (the engine stays single-threaded: the inline
        leftover drain below runs only once the worker has exited, never
        concurrently with it — it could otherwise pop the shutdown
        sentinel and invoke the engine from two threads)."""
        with self._lock:
            if self._closed:
                already = True
            else:
                self._closed = True
                already = False
        if not already:
            self._q.put(None)  # sentinel
        self._worker.join(timeout)
        # a submit racing close() may have enqueued behind the sentinel;
        # once the worker is gone, run the leftovers inline
        if not self._worker.is_alive():
            self._drain_leftovers()

    def __enter__(self) -> "MicroBatcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- worker -----------------------------------------------------------

    def _bucket(self, rows: int) -> int:
        for b in self.buckets:
            if rows <= b:
                return b
        return rows  # oversized single request: run at natural size

    def _run(self) -> None:
        carry: _Request | None = None  # popped but didn't fit the last batch
        # pipelined mode: a dedicated finalizer thread reads back batch i
        # while this thread drains + uploads + launches batch i+1 — the
        # assembly window rides the readback instead of following it. The
        # depth-1 queue bounds the pipeline to one batch in flight.
        fq: queue.Queue | None = None
        finalizer: threading.Thread | None = None
        if self.pipeline:
            fq = queue.Queue(maxsize=1)
            finalizer = threading.Thread(
                target=self._finalize_loop, args=(fq,),
                name="mvt-microbatcher-finalize", daemon=True,
            )
            finalizer.start()
        try:
            while True:
                if carry is not None:
                    req, carry = carry, None
                else:
                    req = self._q.get()
                    if req is None:
                        return
                # one drain window, grouped by predicate: same-mask
                # requests coalesce into one batch; distinct masks launch
                # as separate (smaller) batches from the same window
                groups: dict = {req.group: [req]}
                rows = req.rows.shape[0]
                deadline = time.monotonic() + self.max_wait_s
                stop = False
                while rows < self.max_batch:
                    remaining = deadline - time.monotonic()
                    try:
                        nxt = self._q.get(
                            timeout=remaining if remaining > 0 else 0
                        )
                    except queue.Empty:
                        break
                    if nxt is None:
                        stop = True
                        break
                    if rows + nxt.rows.shape[0] > self.max_batch:
                        # would overshoot the top ladder rung — defer to the
                        # next batch so launched shapes stay on the ladder
                        carry = nxt
                        break
                    groups.setdefault(nxt.group, []).append(nxt)
                    rows += nxt.rows.shape[0]
                with self._lock:
                    self._stats.windows += 1
                for batch in groups.values():
                    nrows = sum(r.rows.shape[0] for r in batch)
                    if fq is not None:
                        inflight = self._launch(batch, nrows)
                        if inflight is not None:
                            # depth 1: blocks while i-1 reads back
                            fq.put(inflight)
                    else:
                        self._execute(batch, nrows)
                if stop:
                    if carry is not None:
                        with self._lock:
                            self._stats.windows += 1
                        if fq is not None:
                            inflight = self._launch([carry], carry.rows.shape[0])
                            if inflight is not None:
                                fq.put(inflight)
                        else:
                            self._execute([carry], carry.rows.shape[0])
                    return
        finally:
            if fq is not None:
                fq.put(None)
                finalizer.join()
            self._drain_leftovers()

    def _drain_leftovers(self) -> None:
        """Run any requests still queued after shutdown began (a submit
        racing close() can land behind the sentinel) so no caller hangs."""
        while True:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                return
            if req is not None and not req.future.done():
                self._execute([req], req.rows.shape[0])

    def _finalize_loop(self, fq: queue.Queue) -> None:
        while True:
            item = fq.get()
            if item is None:
                return
            self._finish(item)

    def _assemble(self, batch: list[_Request], rows: int):
        padded = self._bucket(rows)
        q = np.concatenate([r.rows for r in batch], axis=0)
        if padded > rows:
            # Pad by REPLICATING the last real query, not with zeros: the
            # pad rows' results are discarded either way, but a zero
            # query is degenerate for every metric (all scores 0.0), so
            # under precision="high_verified" it fails the per-query
            # certificate (0 > 0 + eps) and would force a full-HIGHEST
            # relaunch of EVERY off-rung batch — silently negating the
            # feature's throughput win in serving. A replicated real row
            # certifies exactly like its original.
            q = np.concatenate(
                [q, np.repeat(q[-1:], padded - rows, axis=0)], axis=0
            )
        return q, padded

    def _fail(self, batch: list[_Request], e: BaseException) -> None:
        for r in batch:
            try:
                r.future.set_exception(e)
            except Exception:  # cancelled or already resolved elsewhere
                pass

    def _group_filter(self, batch: list[_Request]):
        """The device filter for one predicate group (worker thread
        only). ``group=None`` → the batcher's shared filter; prepared
        per-request filters pass through; raw masks are prepared once per
        group via ``engine.prepare_filter`` and LRU-cached (engines
        without ``prepare_filter`` take the raw mask per launch)."""
        r = batch[0]
        if r.group is None:
            return self._filter
        if hasattr(r.fmask, "mask"):  # already prepared by the caller
            return r.fmask
        cached = self._fcache.get(r.group)
        if cached is None:
            prep = getattr(self.engine, "prepare_filter", None)
            cached = prep(r.fmask) if prep else r.fmask
            if len(self._fcache) >= self._fcache_cap:
                # evict the least-recently-USED entry (hits below
                # re-insert, so dict order is true LRU — a hot raw-mask
                # predicate used every window is never the one dropped)
                self._fcache.pop(next(iter(self._fcache)))
        else:
            self._fcache.pop(r.group)  # LRU touch: re-insert as newest
        self._fcache[r.group] = cached
        return cached

    def _launch(self, batch: list[_Request], rows: int):
        """Pipelined mode: upload + launch without forcing a readback;
        returns the in-flight tuple (or None if the launch failed)."""
        try:
            q, padded = self._assemble(batch, rows)
            pending = self.engine._launch(q, self.k, self._group_filter(batch))
            return (batch, pending, padded)
        except BaseException as e:  # noqa: BLE001 — delivered to callers
            self._fail(batch, e)
            return None

    def _finish(self, inflight) -> None:
        """Finalize an in-flight launch and resolve its futures."""
        if inflight is None:
            return None
        batch, pending, padded = inflight
        try:
            res = self.engine._finalize(pending, self.k)
            self._deliver(batch, res, padded)
        except BaseException as e:  # noqa: BLE001 — delivered to callers
            # _deliver is inside the guard too: a duck-typed engine whose
            # result rejects the slicing kwargs must fail THIS batch's
            # futures, not kill the worker thread silently.
            self._fail(batch, e)
        return None

    def _execute(self, batch: list[_Request], rows: int) -> None:
        try:
            q, padded = self._assemble(batch, rows)
            kw = dict(self._search_kwargs)
            fmask = self._group_filter(batch)
            if fmask is not None:
                kw["filter_mask"] = fmask
            res = self.engine.search(q, k=self.k, **kw)
            self._deliver(batch, res, padded)
        except BaseException as e:  # noqa: BLE001 — delivered to callers
            self._fail(batch, e)

    def _deliver(self, batch: list[_Request], res, padded: int) -> None:
        now = time.monotonic()
        cls = type(res)
        off = 0
        lat: list[float] = []
        for r in batch:
            m = r.rows.shape[0]
            sl = slice(off, off + m)
            off += m
            out = cls(
                indices=res.indices[sl, : r.k],
                scores=res.scores[sl, : r.k],
                distances=res.distances[sl, : r.k],
                metric=res.metric,
                ids=None if res.ids is None else res.ids[sl, : r.k],
            )
            lat.append((now - r.t_submit) * 1e3)
            try:
                r.future.set_result(out)
            except Exception:  # cancelled or already resolved elsewhere
                pass
        with self._lock:
            self._stats.batches += 1
            self._stats.padded_rows += padded
            self._lat_ms.extend(lat)
            if len(self._lat_ms) > _LAT_SAMPLE_CAP:
                del self._lat_ms[: len(self._lat_ms) - _LAT_SAMPLE_CAP]
