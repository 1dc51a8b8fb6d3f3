"""MicroBatcher: concurrent submitters coalesce into batched kernel
launches with per-request results bit-identical to direct search.

Reference analog: none (the reference ships no serving layer); this is
the accelerator application layer's request-coalescing front-end
(SURVEY.md §5 serving shapes)."""

import threading
import time

import numpy as np
import pytest


def _make_engine(n=400, d=24, seed=5):
    from metrovector_tpu import Builder, Reader, SearchEngine

    rng = np.random.default_rng(seed)
    data = rng.standard_normal((n, d)).astype(np.float32)
    import tempfile, os

    b = Builder()
    b.add_vector_space("v", dim=d)
    b.add_vectors("v", data)
    path = os.path.join(tempfile.mkdtemp(), "serve.mvt")
    b.build().save(path)
    eng = SearchEngine(Reader.open(path).vector_space("v"))
    return eng, data, rng


def test_results_match_direct_search():
    """Many threads submitting single queries: every future's result is
    bit-identical to a direct engine.search of that query alone."""
    from metrovector_tpu import MicroBatcher

    eng, data, rng = _make_engine()
    queries = rng.standard_normal((48, data.shape[1])).astype(np.float32)
    direct = eng.search(queries, k=7)

    with MicroBatcher(eng, k=7, max_batch=16, max_wait_ms=20.0) as mb:
        futs = [None] * len(queries)

        def client(lo, hi):
            for i in range(lo, hi):
                futs[i] = mb.submit(queries[i])

        threads = [
            threading.Thread(target=client, args=(j * 12, (j + 1) * 12))
            for j in range(4)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        results = [f.result(timeout=60) for f in futs]

    for i, res in enumerate(results):
        assert res.indices.shape == (1, 7)
        assert np.array_equal(res.indices[0], direct.indices[i])
        assert np.array_equal(res.scores[0], direct.scores[i])
        assert np.array_equal(res.distances[0], direct.distances[i])

    s = mb.stats()
    assert s.requests == 48 and s.rows == 48
    # coalescing actually happened: fewer kernel launches than requests
    assert s.batches < s.requests
    assert 0.0 < s.occupancy <= 1.0
    assert s.p50_ms >= 0.0 and s.p99_ms >= s.p50_ms


def test_multi_row_requests_and_per_request_k():
    """A [m, d] group resolves to an [m, k] result; per-request k <= the
    batcher's k is the exact top-k prefix."""
    from metrovector_tpu import MicroBatcher

    eng, data, rng = _make_engine()
    g = rng.standard_normal((5, data.shape[1])).astype(np.float32)
    single = rng.standard_normal(data.shape[1]).astype(np.float32)
    direct_g = eng.search(g, k=4)
    direct_s = eng.search(single[None, :], k=9)

    with MicroBatcher(eng, k=9, max_batch=8, max_wait_ms=10.0) as mb:
        fg = mb.submit(g, k=4)
        fs = mb.submit(single)
        rg, rs = fg.result(60), fs.result(60)

    assert rg.indices.shape == (5, 4)
    assert np.array_equal(rg.indices, direct_g.indices)
    assert np.array_equal(rg.distances, direct_g.distances)
    assert rs.indices.shape == (1, 9)
    assert np.array_equal(rs.indices, direct_s.indices)


def test_shared_filter_mask():
    """A batcher-level filter predicate applies to every request, equal to
    direct filtered search."""
    from metrovector_tpu import MicroBatcher

    eng, data, rng = _make_engine()
    mask = (np.arange(data.shape[0]) % 3 == 0)
    q = rng.standard_normal((3, data.shape[1])).astype(np.float32)
    direct = eng.search(q, k=5, filter_mask=mask)

    with MicroBatcher(eng, k=5, max_wait_ms=5.0, filter_mask=mask) as mb:
        res = mb.search(q, timeout=60)
    assert np.array_equal(res.indices, direct.indices)
    assert all(i % 3 == 0 for i in res.indices.ravel() if i >= 0)


def test_submit_validation_and_close():
    """Shape/k errors raise at submit (never poisoning a batch); submit
    after close raises; close flushes queued work and is idempotent."""
    from metrovector_tpu import MicroBatcher
    from metrovector_tpu.errors import BatcherClosedError, DimensionMismatchError

    eng, data, rng = _make_engine()
    mb = MicroBatcher(eng, k=6, max_batch=4, max_wait_ms=50.0)
    with pytest.raises(DimensionMismatchError):
        mb.submit(np.zeros(data.shape[1] + 1, np.float32))
    with pytest.raises(ValueError):
        mb.submit(np.zeros(data.shape[1], np.float32), k=7)  # > batcher k
    with pytest.raises(ValueError):
        mb.submit(np.zeros((0, data.shape[1]), np.float32))

    # queue a few then close: all futures resolve
    futs = [
        mb.submit(rng.standard_normal(data.shape[1]).astype(np.float32))
        for _ in range(6)
    ]
    mb.close(timeout=120)
    for f in futs:
        assert f.result(timeout=60).indices.shape == (1, 6)
    with pytest.raises(BatcherClosedError):
        mb.submit(np.zeros(data.shape[1], np.float32))
    mb.close()  # idempotent


def test_bucket_ladder_bounds_compiled_shapes():
    """Drained batches are padded onto the bucket ladder, so the engine
    sees only ladder sizes (here: 1,2,4,8) — the XLA shape-stability
    property the batcher exists to provide."""
    from metrovector_tpu import MicroBatcher

    eng, data, rng = _make_engine()
    seen = []
    real_search = eng.search

    def spy(queries, k=10, filter_mask=None):
        seen.append(np.asarray(queries).shape[0])
        return real_search(queries, k=k, filter_mask=filter_mask)

    eng.search = spy
    try:
        # pipeline=False: the spy wraps .search, which pipelined mode's
        # _launch/_finalize split bypasses
        with MicroBatcher(
            eng, k=3, max_batch=8, max_wait_ms=25.0, pipeline=False
        ) as mb:
            futs = [
                mb.submit(
                    rng.standard_normal((m, data.shape[1])).astype(np.float32)
                )
                for m in (1, 3, 5, 2, 1)
            ]
            for f in futs:
                f.result(60)
    finally:
        eng.search = real_search
    assert seen, "no batches ran"
    assert all(b in (1, 2, 4, 8) for b in seen), seen
    # oversized single request runs at natural size (no ladder rung fits)
    with MicroBatcher(eng, k=3, max_batch=4, max_wait_ms=1.0) as mb2:
        big = rng.standard_normal((11, data.shape[1])).astype(np.float32)
        r = mb2.submit(big).result(60)
    assert r.indices.shape == (11, 3)


def test_engine_error_propagates_to_all_batch_futures():
    """A failure inside the batched launch resolves every affected future
    with the exception instead of hanging callers or killing the worker."""
    from metrovector_tpu import MicroBatcher

    eng, data, rng = _make_engine()

    class Boom(RuntimeError):
        pass

    real_search = eng.search
    calls = {"n": 0}

    def flaky(queries, k=10, filter_mask=None):
        calls["n"] += 1
        if calls["n"] == 1:
            raise Boom("injected")
        return real_search(queries, k=k, filter_mask=filter_mask)

    eng.search = flaky
    try:
        with MicroBatcher(
            eng, k=4, max_batch=8, max_wait_ms=30.0, pipeline=False
        ) as mb:
            f1 = mb.submit(rng.standard_normal(data.shape[1]).astype(np.float32))
            f2 = mb.submit(rng.standard_normal(data.shape[1]).astype(np.float32))
            excs = 0
            for f in (f1, f2):
                try:
                    f.result(60)
                except Boom:
                    excs += 1
            assert excs >= 1  # the first drained batch failed
            # the worker survived: a later request succeeds
            ok = mb.search(
                rng.standard_normal(data.shape[1]).astype(np.float32),
                timeout=60,
            )
            assert ok.indices.shape == (1, 4)
    finally:
        eng.search = real_search


def test_pipelined_mode_matches_direct_and_plain():
    """pipeline=True (one batch in flight through the engine's
    _launch/_finalize split) returns results bit-identical to direct
    search under sustained submission, and a lone request still resolves
    promptly (idle finalization)."""
    from metrovector_tpu import MicroBatcher

    eng, data, rng = _make_engine()
    queries = rng.standard_normal((40, data.shape[1])).astype(np.float32)
    direct = eng.search(queries, k=6)

    with MicroBatcher(
        eng, k=6, max_batch=8, max_wait_ms=2.0, pipeline=True
    ) as mb:
        assert mb.pipeline
        futs = [mb.submit(q) for q in queries]  # sustained: keeps 1 in flight
        for i, f in enumerate(futs):
            res = f.result(timeout=60)
            assert np.array_equal(res.indices[0], direct.indices[i])
            assert np.array_equal(res.scores[0], direct.scores[i])
        # idle finalization: a lone request resolves without a successor
        lone = mb.search(queries[0], timeout=10)
        assert np.array_equal(lone.indices[0], direct.indices[0])
    s = mb.stats()
    assert s.requests == 41 and s.batches <= s.requests


def test_pipeline_default_and_validation():
    """Pipelining is opt-in (default off); pipeline=True on an engine
    without the _launch/_finalize split raises."""
    from metrovector_tpu import MicroBatcher

    eng, data, rng = _make_engine()
    mb = MicroBatcher(eng, k=3, max_wait_ms=0.0)
    assert not mb.pipeline  # opt-in
    mb.close()

    class Plain:
        space = eng.space

        def search(self, queries, k=10, filter_mask=None):
            return eng.search(queries, k=k, filter_mask=filter_mask)

    plain = Plain()
    mb2 = MicroBatcher(plain, k=3, max_wait_ms=0.0)
    assert not mb2.pipeline  # falls back to .search
    q = rng.standard_normal(data.shape[1]).astype(np.float32)
    res = mb2.search(q, timeout=60)
    assert np.array_equal(res.indices, eng.search(q[None, :], k=3).indices)
    mb2.close()
    with pytest.raises(ValueError):
        MicroBatcher(plain, k=3, pipeline=True)


def test_database_batcher_with_where_predicate():
    """Database.batcher wires a metadata predicate into the batcher's
    shared filter; results match the facade's filtered search."""
    import os
    import tempfile

    from metrovector_tpu import Builder, Database

    rng = np.random.default_rng(11)
    data = rng.standard_normal((200, 12)).astype(np.float32)
    langs = ["en" if i % 2 == 0 else "de" for i in range(200)]
    b = Builder()
    b.add_vector_space("v", dim=12)
    b.add_vectors("v", data)
    b.add_metadata_column("v", "lang", langs)
    path = os.path.join(tempfile.mkdtemp(), "db.mvt")
    b.build().save(path)

    db = Database.open(path)
    q = rng.standard_normal((3, 12)).astype(np.float32)
    direct = db.search("v", q, k=6, where=("lang", "==", "en"))
    with db.batcher("v", k=6, where=("lang", "==", "en"),
                    max_wait_ms=5.0) as mb:
        res = mb.search(q, timeout=60)
    assert np.array_equal(res.indices, direct.indices)
    assert all(i % 2 == 0 for i in res.indices.ravel() if i >= 0)


def test_sharded_space_serving():
    """MicroBatcher over a mesh-sharded corpus (ShardedDeviceSpace is the
    engine) — serving composes with the
    distribution layer on the virtual 8-device mesh."""
    import os
    import tempfile

    from metrovector_tpu import Builder, MicroBatcher, Reader
    from metrovector_tpu.parallel import ShardedDeviceSpace, make_mesh

    rng = np.random.default_rng(4)
    data = rng.standard_normal((320, 24)).astype(np.float32)
    b = Builder()
    b.add_vector_space("v", dim=24)
    b.add_vectors("v", data)
    path = os.path.join(tempfile.mkdtemp(), "shard.mvt")
    b.build().save(path)

    sp = Reader.open(path).vector_space("v")
    ds = ShardedDeviceSpace(sp, make_mesh(8))
    q = rng.standard_normal((6, 24)).astype(np.float32)
    direct = ds.search(q, k=5)

    with MicroBatcher(
        ds, k=5, max_batch=8, max_wait_ms=10.0,
    ) as mb:
        futs = [mb.submit(qi) for qi in q]
        for i, f in enumerate(futs):
            res = f.result(timeout=120)
            assert np.array_equal(res.indices[0], direct.indices[i])
            assert np.array_equal(res.distances[0], direct.distances[i])


def test_streamed_corpus_serving():
    """MicroBatcher over a StreamingSearcher (corpus larger than device memory in
    production; here just streamed in chunks) — the third leg of the
    serving composition matrix (resident / sharded / streamed)."""
    import os
    import tempfile

    from metrovector_tpu import Builder, MicroBatcher, Reader, SearchEngine
    from metrovector_tpu.parallel import StreamingSearcher

    rng = np.random.default_rng(9)
    data = rng.standard_normal((700, 16)).astype(np.float32)
    b = Builder()
    b.add_vector_space("v", dim=16)
    b.add_vectors("v", data)
    path = os.path.join(tempfile.mkdtemp(), "stream.mvt")
    b.build().save(path)

    sp = Reader.open(path).vector_space("v")
    q = rng.standard_normal((4, 16)).astype(np.float32)
    direct = SearchEngine(sp).search(q, k=5)

    ss = StreamingSearcher(sp, chunk_rows=256)
    with MicroBatcher(ss, k=5, max_batch=8, max_wait_ms=10.0) as mb:
        futs = [mb.submit(qi) for qi in q]
        for i, f in enumerate(futs):
            res = f.result(timeout=120)
            assert np.array_equal(res.indices[0], direct.indices[i])


def test_submit_close_race_never_hangs():
    """Stress the submit/close race: every future handed out before or
    during close() resolves (with a result or BatcherClosedError) — no
    caller is left hanging behind the shutdown sentinel."""
    from concurrent.futures import Future

    from metrovector_tpu import MicroBatcher
    from metrovector_tpu.errors import BatcherClosedError

    eng, data, rng = _make_engine()
    qs = rng.standard_normal((8, data.shape[1])).astype(np.float32)

    for trial in range(5):
        mb = MicroBatcher(eng, k=3, max_batch=4, max_wait_ms=1.0)
        futs: list[Future] = []
        go = threading.Event()

        def spam():
            go.wait()
            for i in range(50):
                try:
                    futs.append(mb.submit(qs[i % len(qs)]))
                except BatcherClosedError:
                    return

        ts = [threading.Thread(target=spam) for _ in range(3)]
        for t in ts:
            t.start()
        go.set()
        time.sleep(0.002 * trial)  # vary the race window
        mb.close(timeout=120)
        for t in ts:
            t.join()
        for f in futs:
            try:
                res = f.result(timeout=60)
                assert res.indices.shape == (1, 3)
            except BatcherClosedError:
                pass  # raced the shutdown: failed, not hung


def test_latency_throughput_knob():
    """max_wait_ms=0 disables time-coalescing: sequential submits each run
    in their own batch (occupancy 1.0 at bucket 1)."""
    from metrovector_tpu import MicroBatcher

    eng, data, rng = _make_engine()
    with MicroBatcher(eng, k=3, max_batch=8, max_wait_ms=0.0) as mb:
        for _ in range(4):
            mb.search(
                rng.standard_normal(data.shape[1]).astype(np.float32),
                timeout=60,
            )
    s = mb.stats()
    assert s.requests == 4
    assert s.batches == 4  # sequential + no wait → no coalescing
    assert s.occupancy == 1.0


def test_deliver_failure_fails_batch_not_worker():
    """A result whose attribute access blows up inside result slicing
    (_deliver) resolves the batch's futures with the exception and leaves
    the worker alive for later requests (advisor r4: _deliver used to run
    outside the failure guard and killed the worker silently)."""
    from metrovector_tpu import MicroBatcher

    eng, data, rng = _make_engine()

    class Hostile:
        """Duck-typed result whose slicing raises (bad engine contract)."""

        metric = None
        ids = None

        @property
        def indices(self):
            raise TypeError("hostile result")

        scores = indices
        distances = indices

    real_search = eng.search
    calls = {"n": 0}

    def flaky(queries, k=10, filter_mask=None):
        calls["n"] += 1
        if calls["n"] == 1:
            return Hostile()
        return real_search(queries, k=k, filter_mask=filter_mask)

    eng.search = flaky
    try:
        with MicroBatcher(eng, k=3, max_batch=4, max_wait_ms=0.0) as mb:
            f1 = mb.submit(
                rng.standard_normal(data.shape[1]).astype(np.float32)
            )
            with pytest.raises(TypeError, match="hostile"):
                f1.result(60)
            # worker survived the delivery failure
            ok = mb.search(
                rng.standard_normal(data.shape[1]).astype(np.float32),
                timeout=60,
            )
            assert ok.indices.shape == (1, 3)
    finally:
        eng.search = real_search


def test_submit_fails_fast_when_worker_dead():
    """If the worker thread is gone while the batcher is nominally open,
    submit() must not enqueue futures that can never resolve."""
    from metrovector_tpu import MicroBatcher
    from metrovector_tpu.errors import BatcherClosedError

    eng, data, rng = _make_engine()
    mb = MicroBatcher(eng, k=3, max_batch=4, max_wait_ms=0.0)
    try:
        # simulate an abrupt worker death without setting _closed
        mb._q.put(None)  # worker exits on the sentinel
        mb._worker.join(30)
        assert not mb._worker.is_alive()
        f = mb.submit(rng.standard_normal(data.shape[1]).astype(np.float32))
        with pytest.raises(BatcherClosedError, match="dead"):
            f.result(10)
    finally:
        mb.close()
