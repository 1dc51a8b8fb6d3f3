"""Per-request predicates in the MicroBatcher (round-5 verdict item 6).

Requests coalesce by predicate group — same prepared filter object (or
byte-identical raw mask) lands in the same batch; a drain window holding
several distinct predicates launches one batch per group. Every result
must be bit-identical to a direct ``engine.search(..., filter_mask=...)``
call with the same arguments (the exactness bar every serving surface
carries — ``ops/distances.py`` docstring).
"""

import os
import tempfile
import threading

import numpy as np
import pytest


def _db(n=240, d=16, seed=11):
    from metrovector_tpu import Builder, Database

    rng = np.random.default_rng(seed)
    data = rng.standard_normal((n, d)).astype(np.float32)
    langs = [("en", "de", "fr")[i % 3] for i in range(n)]
    b = Builder()
    b.add_vector_space("docs", dim=d)
    b.add_vectors("docs", data)
    b.add_metadata_column("docs", "lang", langs)
    path = os.path.join(tempfile.mkdtemp(), "f.mvt")
    b.build().save(path)
    return Database.open(path), data, np.asarray(langs)


def test_mixed_predicates_one_window_bit_identical():
    """Several distinct predicates inside one coalescing window: each
    request's result equals a direct filtered search, and grouping is
    visible in the stats (windows <= batches <= requests)."""
    db, data, langs = _db()
    eng = db.engine("docs", mode="exact")
    rng = np.random.default_rng(0)
    queries = rng.standard_normal((9, data.shape[1])).astype(np.float32)
    masks = [langs == lang for lang in ("en", "de", "fr")]

    with db.batcher("docs", k=5, max_batch=64, max_wait_ms=300.0) as mb:
        futs = [
            mb.submit(queries[i], filter_mask=masks[i % 3])
            for i in range(9)
        ]
        results = [f.result(timeout=120) for f in futs]
        stats = mb.stats()
    for i, res in enumerate(results):
        direct = eng.search(queries[i][None], k=5,
                            filter_mask=masks[i % 3])
        np.testing.assert_array_equal(res.indices, direct.indices)
        np.testing.assert_array_equal(res.scores, direct.scores)
    # same-mask requests coalesced: at most one batch per (window, group)
    assert stats.requests == 9
    assert stats.windows <= stats.batches <= stats.requests
    # with a 300 ms window and instant submits, the 3 predicate groups
    # should have coalesced well below one-batch-per-request
    assert stats.batches < 9


def test_identical_raw_masks_share_one_batch():
    db, data, langs = _db()
    mask = langs == "en"
    with db.batcher("docs", k=3, max_batch=64, max_wait_ms=500.0) as mb:
        futs = [mb.submit(data[i], filter_mask=mask.copy())
                for i in range(6)]
        for f in futs:
            r = f.result(timeout=120)
            assert (langs[r.indices[0]] == "en").all()
        stats = mb.stats()
    # byte-identical raw masks hash to the same predicate group
    assert stats.batches == stats.windows == 1


def test_prepared_filter_fast_path():
    db, data, langs = _db()
    eng = db.engine("docs", mode="exact")
    prep = db.prepare_where("docs", where=("lang", "==", "de"),
                            mode="exact")
    rng = np.random.default_rng(1)
    q = rng.standard_normal((4, data.shape[1])).astype(np.float32)
    with db.batcher("docs", k=4, max_wait_ms=200.0, mode="exact") as mb:
        futs = [mb.submit(q[i], filter_mask=prep) for i in range(4)]
        results = [f.result(timeout=120) for f in futs]
        stats = mb.stats()
    direct = eng.search(q, k=4, filter_mask=langs == "de")
    for i, res in enumerate(results):
        np.testing.assert_array_equal(res.indices, direct.indices[i:i + 1])
    assert stats.batches == 1  # one prepared object = one group


def test_per_request_mask_replaces_shared_filter():
    """Documented semantics: a per-request mask REPLACES the batcher's
    shared filter for that request; unfiltered requests still get the
    shared one."""
    db, data, langs = _db()
    eng = db.engine("docs", mode="exact")
    q = data[0][None]
    with db.batcher("docs", k=4, where=("lang", "==", "en"),
                    max_wait_ms=100.0) as mb:
        shared = mb.submit(q).result(timeout=120)
        override = mb.submit(q, filter_mask=langs == "fr").result(timeout=120)
    np.testing.assert_array_equal(
        shared.indices, eng.search(q, k=4, filter_mask=langs == "en").indices
    )
    np.testing.assert_array_equal(
        override.indices,
        eng.search(q, k=4, filter_mask=langs == "fr").indices,
    )


def test_bad_mask_shape_fails_at_submit_not_in_worker():
    from metrovector_tpu.errors import DimensionMismatchError

    db, data, _ = _db()
    with db.batcher("docs", k=3) as mb:
        with pytest.raises(DimensionMismatchError):
            mb.submit(data[0], filter_mask=np.ones(7, bool))
        # the worker never saw the bad request; good ones still serve
        res = mb.submit(data[0]).result(timeout=120)
        assert res.indices[0, 0] == 0


def test_concurrent_mixed_predicates_under_threads():
    """Closed-loop threads with per-thread predicates: every result
    matches its direct search, across many windows."""
    db, data, langs = _db()
    eng = db.engine("docs", mode="exact")
    rng = np.random.default_rng(7)
    masks = {lang: langs == lang for lang in ("en", "de", "fr")}
    errors: list = []

    with db.batcher("docs", k=5, max_batch=32, max_wait_ms=5.0) as mb:
        def client(lang, seed):
            r = np.random.default_rng(seed)
            try:
                for _ in range(5):
                    q = r.standard_normal(data.shape[1]).astype(np.float32)
                    got = mb.submit(q, filter_mask=masks[lang]).result(120)
                    want = eng.search(q[None], k=5, filter_mask=masks[lang])
                    np.testing.assert_array_equal(got.indices, want.indices)
            except Exception as e:  # surface in the main thread
                errors.append(e)

        threads = [
            threading.Thread(target=client, args=(lang, i))
            for i, lang in enumerate(("en", "de", "fr") * 2)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    assert not errors, errors


def test_pipelined_mode_with_per_request_predicates():
    db, data, langs = _db()
    from metrovector_tpu import Reader, SearchEngine

    eng = db.engine("docs", mode="exact")
    from metrovector_tpu.serving import MicroBatcher

    q = data[:3].astype(np.float32)
    with MicroBatcher(eng, k=4, max_wait_ms=200.0, pipeline=True) as mb:
        futs = [mb.submit(q[i], filter_mask=langs == "de") for i in range(3)]
        results = [f.result(timeout=120) for f in futs]
    direct = eng.search(q, k=4, filter_mask=langs == "de")
    for i, res in enumerate(results):
        np.testing.assert_array_equal(res.indices, direct.indices[i:i + 1])


def test_filter_cache_is_bounded():
    db, data, langs = _db()
    from metrovector_tpu.serving import MicroBatcher

    eng = db.engine("docs", mode="exact")
    n = data.shape[0]
    with MicroBatcher(eng, k=2, max_wait_ms=0.0) as mb:
        rng = np.random.default_rng(3)
        for i in range(40):  # > the 32-entry cache cap
            mask = np.zeros(n, bool)
            mask[rng.choice(n, size=50, replace=False)] = True
            res = mb.submit(data[0], filter_mask=mask).result(timeout=120)
            assert mask[res.indices[0, 0]]
        assert len(mb._fcache) <= mb._fcache_cap


def test_filter_cache_is_lru_not_fifo():
    """A hot raw-mask predicate used between one-off masks must survive
    eviction: cache hits refresh recency (true LRU), so the entry the
    worker touches every window is never the one popped."""
    db, data, langs = _db()
    from metrovector_tpu.serving import MicroBatcher

    eng = db.engine("docs", mode="exact")
    n = data.shape[0]
    hot = np.zeros(n, bool)
    hot[:7] = True
    hot_key = ("mask", np.ascontiguousarray(hot, bool).tobytes())
    with MicroBatcher(eng, k=2, max_wait_ms=0.0) as mb:
        rng = np.random.default_rng(4)
        mb.submit(data[0], filter_mask=hot).result(timeout=120)
        for i in range(mb._fcache_cap + 5):
            oneoff = np.zeros(n, bool)
            oneoff[rng.choice(n, size=50, replace=False)] = True
            mb.submit(data[0], filter_mask=oneoff).result(timeout=120)
            # keep the hot predicate live between one-offs
            res = mb.submit(data[0], filter_mask=hot).result(timeout=120)
            assert res.indices[0, 0] < 7
        assert hot_key in mb._fcache  # survived > cap one-off insertions


def test_indexed_batcher_validates_masks_at_submit():
    """Database.batcher over an auto-routed index sidecar still fails a
    malformed raw mask at submit time (IndexEngine exposes num_vectors),
    not in the worker at drain time."""
    from metrovector_tpu import Builder, Database
    from metrovector_tpu.errors import DimensionMismatchError
    from metrovector_tpu.index import encode_pq, train_pq

    rng = np.random.default_rng(12)
    n, d = 240, 16
    data = rng.standard_normal((n, d)).astype(np.float32)
    b = Builder()
    b.add_vector_space("docs", dim=d)
    b.add_vectors("docs", data)
    cb = train_pq(data, m=4, ksub=16, iters=5, seed=0)
    b.set_pq_index("docs", cb, encode_pq(data, cb))
    path = os.path.join(tempfile.mkdtemp(), "f.mvt")
    b.build().save(path)
    db = Database.open(path)
    assert db.index_kind("docs") == "pq"
    with db.batcher("docs", k=2, max_wait_ms=0.0) as mb:
        assert mb.engine.num_vectors == n
        with pytest.raises(DimensionMismatchError):
            mb.submit(data[0], filter_mask=np.ones(7, bool))
        ok = np.zeros(n, bool)
        ok[:11] = True
        res = mb.submit(data[0], filter_mask=ok).result(timeout=120)
        assert res.indices[0, 0] < 11
