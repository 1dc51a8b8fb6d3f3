"""HNSW graph index: build, search recall, persistence, tombstones.
The reference declares the HNSW schema but its writer stores a TODO stub
(``src/builder.rs:459`` in thegenem0/metrovector) — these tests define the
real behavior. HNSW runs host-side by design (graph traversal is
chains of tiny dependent gathers; see index/hnsw.py docstring)."""

import numpy as np
import pytest

from metrovector_tpu import Builder, DistanceMetric, Reader
from metrovector_tpu.index import HNSWIndex
from metrovector_tpu.ops import numpy_oracle

METRICS = [DistanceMetric.L2, DistanceMetric.COSINE, DistanceMetric.INNER_PRODUCT]


def _data(rng, n=600, d=24):
    return rng.standard_normal((n, d)).astype(np.float32)


@pytest.mark.parametrize("metric", METRICS)
def test_hnsw_high_recall(rng, metric):
    data = _data(rng)
    idx = HNSWIndex.build(data, metric, m=12, ef_construction=100, seed=1)
    q = _data(rng, n=15)
    res = idx.search(q, k=10, ef=128)
    _, oi = numpy_oracle(q, data, 10, metric)
    hits = sum(len(set(res.indices[i]) & set(oi[i])) for i in range(15))
    assert hits / 150 >= 0.9


def test_ef_monotone_recall(rng):
    data = _data(rng, n=1000)
    idx = HNSWIndex.build(data, DistanceMetric.L2, m=8, ef_construction=60)
    q = _data(rng, n=20)
    _, oi = numpy_oracle(q, data, 10, DistanceMetric.L2)

    def recall(ef):
        res = idx.search(q, k=10, ef=ef)
        return sum(len(set(res.indices[i]) & set(oi[i])) for i in range(20))

    assert recall(10) <= recall(64) <= recall(256)
    assert recall(256) / 200 >= 0.85


def test_graph_is_connected_enough(rng):
    """Every live row must be reachable: searching for each row's own
    vector with a generous beam must find it."""
    data = _data(rng, n=300, d=8)
    idx = HNSWIndex.build(data, DistanceMetric.L2, m=8, ef_construction=80)
    res = idx.search(data, k=1, ef=128)
    found = (res.indices[:, 0] == np.arange(300)).mean()
    assert found >= 0.99


@pytest.mark.parametrize("threads", [0, 8])
@pytest.mark.parametrize("n", [300, 5000])
def test_parallel_build_reaches_every_row(rng, n, threads):
    """Parallel native insertion (``threads=0``: all cores) keeps rows
    reachable as the sequential build does: a node must hold its lower
    layers' links before a concurrent insertion can descend onto it,
    or such builds lose 0.4-5% of their rows."""
    from metrovector_tpu import native

    if not native.hnsw_available():
        pytest.skip("native hnsw unavailable")
    data = _data(rng, n=n, d=8)
    idx = HNSWIndex.build(data, DistanceMetric.L2, m=8, ef_construction=80,
                          threads=threads)
    res = idx.search(data, k=1, ef=128)
    missing = int((res.indices[:, 0] != np.arange(n)).sum())
    assert missing <= n // 1000 + 1


def test_single_thread_build_is_deterministic(rng):
    """``threads=1`` is the documented reproducible mode: two native
    builds from one seed give the same graph, layer for layer."""
    from metrovector_tpu import native

    if not native.hnsw_available():
        pytest.skip("native hnsw unavailable")
    data = _data(rng, n=400, d=8)
    a, b = (
        HNSWIndex.build(data, DistanceMetric.L2, m=8, ef_construction=60,
                        seed=5, threads=1)
        for _ in range(2)
    )
    assert a.entry == b.entry and len(a.layers) == len(b.layers)
    for (ia, ma), (ib, mb) in zip(a.layers, b.layers):
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_array_equal(ma, mb)


def test_single_and_tiny_corpus(rng):
    one = _data(rng, n=1, d=8)
    idx = HNSWIndex.build(one, DistanceMetric.L2)
    res = idx.search(one, k=3)
    assert res.indices[0, 0] == 0
    assert (res.indices[0, 1:] == -1).all()


def test_distances_match_engine_convention(rng):
    """Returned distances are true Euclidean distances (reference
    find_top_k_similar convention)."""
    data = _data(rng, n=200, d=8)
    idx = HNSWIndex.build(data, DistanceMetric.L2, m=8, ef_construction=60)
    q = data[7:8] + 0.01
    res = idx.search(q, k=1, ef=64)
    i = int(res.indices[0, 0])
    true_d = np.linalg.norm(q[0] - data[i])
    np.testing.assert_allclose(res.distances[0, 0], true_d, rtol=1e-4)


def test_hnsw_persistence_roundtrip(tmp_path, rng):
    data = _data(rng, n=400, d=16)
    idx = HNSWIndex.build(data, DistanceMetric.L2, m=8, ef_construction=80,
                          seed=3)
    b = Builder()
    b.add_vector_space("s", dim=16)
    b.add_vectors("s", data)
    b.set_hnsw_index("s", idx.layers, idx.entry, m=8, ef_construction=80)
    path = tmp_path / "h.mvt"
    b.build().save(path)

    sp = Reader.open(path).vector_space("s")
    from metrovector_tpu.format.constants import IndexKind

    assert sp.info.index.kind == IndexKind.HNSW
    re = HNSWIndex.from_space(sp)
    assert re.entry == idx.entry
    assert len(re.layers) == len(idx.layers)
    for (ia, aa), (ib, ab) in zip(re.layers, idx.layers):
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_array_equal(aa, ab)
    # identical graph → identical results
    q = _data(rng, n=8, d=16)
    a = re.search(q, k=5, ef=64)
    c = idx.search(q, k=5, ef=64)
    np.testing.assert_array_equal(a.indices, c.indices)

    # selection survives reattach so add_rows keeps evolving the stored
    # graph with the strategy the caller asked for (regression: advisor r3)
    rc = HNSWIndex.from_space(sp, selection="closest")
    assert rc.selection == "closest"
    assert HNSWIndex.from_space(sp).selection == "heuristic"
    import pytest

    with pytest.raises(ValueError, match="selection"):
        HNSWIndex.from_space(sp, selection="bogus")


def test_hnsw_excludes_tombstones(tmp_path, rng):
    data = _data(rng, n=150, d=8)
    b = Builder()
    b.add_vector_space("s", dim=8)
    b.add_vectors("s", data)
    b.delete_vector("s", 4)
    path = tmp_path / "t.mvt"
    b.build().save(path)
    sp = Reader.open(path).vector_space("s")
    idx = HNSWIndex.from_space(sp, m=8, ef_construction=60)
    res = idx.search(data[4:5], k=5, ef=64)
    assert 4 not in res.indices


def test_hnsw_config_roundtrip_without_graph(tmp_path, rng):
    """The reference-level behavior — storing only the config — still
    works via the fluent handle."""
    b = Builder()
    b.add_vector_space("s", dim=8).with_hnsw_index(m=24, ef_construction=77)
    b.add_vectors("s", _data(rng, n=10, d=8))
    path = tmp_path / "c.mvt"
    b.build().save(path)
    sp = Reader.open(path).vector_space("s")
    assert sp.info.index.params == {"m": 24, "ef_construction": 77}
    assert sp.hnsw_arrays() is None  # no graph stored


def test_native_and_python_search_agree_on_same_graph(rng):
    """The C++ searcher and the Python beam must return the same results
    on the SAME frozen graph (same algorithm, same scoring); the native
    path is a performance twin, not a semantic fork."""
    from metrovector_tpu import native

    if not native.hnsw_available():
        pytest.skip("native toolchain unavailable")
    data = _data(rng, n=800, d=16)
    idx = HNSWIndex.build(data, DistanceMetric.L2, m=8, ef_construction=80,
                          seed=2)
    q = _data(rng, n=12, d=16)
    res_native = idx.search(q, k=10, ef=64)
    assert idx._native is not None  # the native path actually ran

    idx2 = HNSWIndex(
        rows=idx.rows, norms=idx.norms, layers=idx.layers, entry=idx.entry,
        metric=idx.metric, m=idx.m, ef_construction=idx.ef_construction,
        valid=idx.valid, host_ids=idx.host_ids,
    )
    idx2._native_handle = lambda: None  # force the Python beam
    res_py = idx2.search(q, k=10, ef=64)
    np.testing.assert_array_equal(res_native.indices, res_py.indices)
    np.testing.assert_allclose(res_native.scores, res_py.scores, rtol=1e-5)


def test_native_graph_survives_append_and_persistence(tmp_path, rng):
    """add_rows thaws the (native-built) frozen graph in Python and
    refreezes; the refrozen graph must adopt back into the native
    searcher and keep finding everything."""
    data = _data(rng, n=300, d=8)
    idx = HNSWIndex.build(data, DistanceMetric.L2, m=8, ef_construction=80)
    new = _data(rng, n=20, d=8)
    idx.add_rows(new)
    res = idx.search(new, k=1, ef=128)
    assert (res.indices[:, 0] == np.arange(300, 320)).mean() >= 0.95

    b = Builder()
    b.add_vector_space("s", dim=8)
    b.add_vectors("s", np.concatenate([data, new]))
    b.set_hnsw_index("s", idx.layers, idx.entry, m=8, ef_construction=80)
    path = tmp_path / "ng.mvt"
    b.build().save(path)
    re = HNSWIndex.from_space(Reader.open(path).vector_space("s"))
    q = _data(rng, n=6, d=8)
    np.testing.assert_array_equal(
        re.search(q, k=5, ef=64).indices, idx.search(q, k=5, ef=64).indices
    )


def test_parallel_build_valid_graph(rng):
    """Multithreaded native build (per-node locks) must produce a valid,
    searchable graph with recall comparable to the sequential build —
    structure is insertion-order dependent, so we gate recall, not
    graph equality."""
    from metrovector_tpu import native

    if not native.hnsw_available():
        import pytest

        pytest.skip("native hnsw unavailable")
    n, d = 5000, 24
    centers = rng.standard_normal((16, d)).astype(np.float32) * 3
    data = centers[rng.integers(0, 16, n)] + rng.standard_normal(
        (n, d)
    ).astype(np.float32)
    q = data[rng.integers(0, n, 30)] + 0.1 * rng.standard_normal(
        (30, d)
    ).astype(np.float32)
    norms = (data**2).sum(1)
    oracle = np.argsort(
        -(2 * q @ data.T - norms[None, :]), axis=1, kind="stable"
    )[:, :10]

    recalls = []
    for threads in (1, 4):
        idx = HNSWIndex.build(
            data, DistanceMetric.L2, m=8, ef_construction=60, seed=7,
            threads=threads,
        )
        res = idx.search(q, k=10, ef=80)
        # structural sanity: every neighbor id in range, no self-loops
        for ids, adj in idx.layers:
            live = adj[adj >= 0]
            assert live.size == 0 or (live < n).all()
            for r_i, nid in enumerate(ids):
                assert nid not in set(adj[r_i][adj[r_i] >= 0].tolist())
        recalls.append(
            np.mean(
                [
                    len(set(res.indices[i]) & set(oracle[i])) / 10
                    for i in range(30)
                ]
            )
        )
    assert recalls[0] > 0.85, recalls
    assert recalls[1] > 0.85, recalls


@pytest.mark.parametrize("native_path", [True, False])
def test_selection_strategies(rng, native_path, monkeypatch):
    """Both selection strategies build searchable graphs with good
    recall on iid data; 'closest' is rejected nowhere but validated."""
    if native_path:
        from metrovector_tpu import native

        if not native.hnsw_available():
            pytest.skip("native hnsw unavailable")
    else:
        monkeypatch.setenv("MVT_NO_NATIVE", "1")
        import metrovector_tpu.native as native_mod

        monkeypatch.setattr(native_mod, "_hnsw_lib", None)
        monkeypatch.setattr(native_mod, "_hnsw_tried", False)
    data = _data(rng, n=1500, d=16)
    q = _data(rng, n=20, d=16)
    _, oi = numpy_oracle(q, data, 10, DistanceMetric.L2)
    for sel in ("heuristic", "closest"):
        idx = HNSWIndex.build(
            data, DistanceMetric.L2, m=12, ef_construction=80, seed=3,
            selection=sel,
        )
        assert idx.selection == sel
        res = idx.search(q, k=10, ef=150)
        hits = sum(len(set(res.indices[i]) & set(oi[i])) for i in range(20))
        assert hits / 200 >= 0.85, (sel, hits / 200)
        # add_rows keeps using the chosen strategy (smoke: inserts work)
        idx.add_rows(data[:5] + 0.01)
        assert idx.rows.shape[0] == 1505

    with pytest.raises(ValueError):
        HNSWIndex.build(data, DistanceMetric.L2, selection="weird")
