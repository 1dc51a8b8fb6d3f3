"""Autotune across every scan family + persisted tilings.

The measure/apply loop exists on the dense engine, the PQ/IVF-PQ ADC
scans and the sparse ELL engine, and
``persist=True`` writes winners into the file's PerformanceHints
(``hints["tuned"][space][family]``) where reattachment adopts them — the
same consume-from-hints pattern as ``stream_chunk_rows``.

Reference anchor: the ``PerformanceHints`` table is declared in the
reference schema but never read or written (SURVEY.md §5); here it
drives real kernel configuration.
"""

import os
import tempfile

import numpy as np
import pytest


def _dense_file(n=300, d=16, seed=3):
    from metrovector_tpu import Builder

    rng = np.random.default_rng(seed)
    data = rng.standard_normal((n, d)).astype(np.float32)
    b = Builder()
    b.add_vector_space("v", dim=d)
    b.add_vectors("v", data)
    path = os.path.join(tempfile.mkdtemp(), "t.mvt")
    b.build().save(path)
    return path, data


# ------------------------------------------------------- footer rewrite ---


def test_rewrite_hints_roundtrip_preserves_data_and_checksums():
    from metrovector_tpu import Reader, rewrite_hints

    path, data = _dense_file()
    rewrite_hints(path, {"tuned": {"v": {"dense": {"block_rows": 64}}}})
    r = Reader.open(path)
    assert r.manifest.hints["tuned"]["v"]["dense"]["block_rows"] == 64
    # data blocks untouched: full CRC validation still passes and the
    # vectors read back bit-identical
    r.validate_with_checksum()
    np.testing.assert_array_equal(r.vector_space("v").to_numpy(), data)


def test_rewrite_hints_merges_recursively():
    """Tuning one family (or space) must not clobber siblings."""
    from metrovector_tpu import Reader, rewrite_hints

    path, _ = _dense_file()
    rewrite_hints(path, {"tuned": {"v": {"dense": {"block_rows": 64}}}})
    rewrite_hints(path, {"tuned": {"v": {"adc": {"block_rows": 512}}}})
    rewrite_hints(path, {"tuned": {"w": {"dense": {"block_rows": 128}}}})
    h = Reader.open(path).manifest.hints["tuned"]
    assert h["v"] == {"dense": {"block_rows": 64},
                      "adc": {"block_rows": 512}}
    assert h["w"] == {"dense": {"block_rows": 128}}


def test_rewrite_hints_rejects_non_mvt():
    from metrovector_tpu import rewrite_hints
    from metrovector_tpu.errors import InvalidFormatError

    path = os.path.join(tempfile.mkdtemp(), "junk.bin")
    with open(path, "wb") as f:
        f.write(b"not an mvt file at all........")
    with pytest.raises(InvalidFormatError):
        rewrite_hints(path, {"x": 1})


# ------------------------------------------------- dense persist/adopt ---


def test_dense_autotune_persist_and_adopt():
    from metrovector_tpu import Reader, SearchEngine

    path, data = _dense_file()
    eng = SearchEngine(Reader.open(path).vector_space("v"))
    report = eng.autotune(
        k=3, batch=4,
        block_rows_candidates=[64, 128],
        iters=1, persist=True,
    )
    assert np.isfinite(report[0]["ms"])
    winner = report[0]
    # a fresh engine from a fresh reader adopts the persisted tiling
    eng2 = SearchEngine(Reader.open(path).vector_space("v"))
    assert eng2.block_rows == winner["block_rows"]
    # explicit arguments still win over hints
    eng3 = SearchEngine(Reader.open(path).vector_space("v"), block_rows=32)
    assert eng3.block_rows == 32
    # and the tuned engine stays oracle-exact
    from metrovector_tpu import DistanceMetric
    from metrovector_tpu.ops import numpy_oracle

    rng = np.random.default_rng(0)
    q = rng.standard_normal((4, data.shape[1])).astype(np.float32)
    _, oi = numpy_oracle(q, data, 5, DistanceMetric.L2)
    assert np.array_equal(eng2.search(q, k=5).indices, oi)


def test_dense_persist_requires_file_backed_space():
    from metrovector_tpu import Reader, SearchEngine
    from metrovector_tpu.engine import DeviceSpace

    path, _ = _dense_file()
    dev = DeviceSpace.from_space(Reader.open(path).vector_space("v"))
    eng = SearchEngine(dev)  # no file-backed origin
    with pytest.raises(ValueError, match="file-backed"):
        eng.autotune(k=3, batch=4, block_rows_candidates=[64],
                     iters=1, persist=True)


# ----------------------------------------------------------- ADC family ---


def _pq_file(n=512, d=32, seed=0):
    from metrovector_tpu import Builder
    from metrovector_tpu.index import train_pq, encode_pq

    rng = np.random.default_rng(seed)
    data = rng.standard_normal((n, d)).astype(np.float32)
    books = train_pq(data, m=4, ksub=16, iters=4, seed=seed)
    codes = encode_pq(data, books)
    b = Builder()
    b.add_vector_space("v", dim=d)
    b.add_vectors("v", data)
    b.set_pq_index("v", books, codes)
    path = os.path.join(tempfile.mkdtemp(), "pq.mvt")
    b.build().save(path)
    return path, data


def test_pq_autotune_cliff_candidate_corrected(monkeypatch):
    """The default block_rows gets REJECTED when its measured time loses
    — the autotune exists because no static default wins everywhere.
    Deterministic timings are injected through the measure_once seam; the
    launches themselves still run, so exactness is exercised too."""
    from metrovector_tpu import Reader
    from metrovector_tpu.index import PQIndex
    from metrovector_tpu.index.pq import DEFAULT_ADC_BLOCK_ROWS
    import metrovector_tpu.utils.tune as tune_mod

    path, _ = _pq_file()
    idx = PQIndex.from_space(Reader.open(path).vector_space("v"))
    candidates = [DEFAULT_ADC_BLOCK_ROWS, 64]
    # the default "measures" 100× slower
    times = iter([0.5, 0.005])
    real_measure = tune_mod.measure_once

    def fake_measure(run):
        real_measure(run)  # still execute: compile/shape errors surface
        return next(times)

    monkeypatch.setattr(tune_mod, "measure_once", fake_measure)
    report = idx.autotune(
        k=5, batch=8, block_rows_candidates=candidates, iters=1,
        persist=True,
    )
    assert report[0]["block_rows"] == 64  # the default lost
    assert idx.adc_block_rows == 64
    # reattachment from the file adopts the corrected tiling
    idx2 = PQIndex.from_space(Reader.open(path).vector_space("v"))
    assert idx2.adc_block_rows == 64
    # and serving through the tuned default matches an explicit tiling
    # bit-for-rank (results are tile-independent by design)
    rng = np.random.default_rng(1)
    q = rng.standard_normal((4, idx.dim)).astype(np.float32)
    tuned = idx2.search(q, k=5)
    explicit = idx2.search(q, k=5, block_rows=256)
    np.testing.assert_array_equal(tuned.indices, explicit.indices)


def test_pq_autotune_failing_candidate_records_error():
    from metrovector_tpu import Reader
    from metrovector_tpu.index import PQIndex

    path, _ = _pq_file()
    idx = PQIndex.from_space(Reader.open(path).vector_space("v"))
    report = idx.autotune(
        k=5, batch=8, block_rows_candidates=[-7, 64], iters=1,
    )
    bad = [r for r in report if r["block_rows"] == -7][0]
    assert bad["ms"] == float("inf") and "error" in bad
    assert idx.adc_block_rows == 64  # the finite winner still applies


def test_pq_persist_without_winner_raises():
    from metrovector_tpu import Reader
    from metrovector_tpu.index import PQIndex

    path, _ = _pq_file()
    idx = PQIndex.from_space(Reader.open(path).vector_space("v"))
    with pytest.raises(RuntimeError, match="nothing persisted"):
        idx.autotune(k=5, batch=8, block_rows_candidates=[-3], iters=1,
                     persist=True)


def _ivfpq_file(n=600, d=32, seed=0):
    from metrovector_tpu import Builder
    from metrovector_tpu.index import train_ivfpq

    rng = np.random.default_rng(seed)
    data = rng.standard_normal((n, d)).astype(np.float32)
    cent, assign, books, codes = train_ivfpq(
        data, num_clusters=8, m=4, ksub=16, iters=4, seed=seed
    )
    b = Builder()
    b.add_vector_space("v", dim=d)
    b.add_vectors("v", data)
    b.set_ivf_index("v", cent, assign)
    b.set_pq_index("v", books, codes, residual=True)
    path = os.path.join(tempfile.mkdtemp(), "ivfpq.mvt")
    b.build().save(path)
    return path, data


def test_ivfpq_autotune_persist_and_adopt():
    from metrovector_tpu import Reader
    from metrovector_tpu.index import IVFPQIndex

    path, _ = _ivfpq_file()
    idx = IVFPQIndex.from_space(Reader.open(path).vector_space("v"))
    report = idx.autotune(
        k=5, batch=8, nprobe=4, block_rows_candidates=[64, 128], iters=1,
        persist=True,
    )
    assert np.isfinite(report[0]["ms"])
    assert idx.scan_block_rows == report[0]["block_rows"]
    idx2 = IVFPQIndex.from_space(Reader.open(path).vector_space("v"))
    assert idx2.scan_block_rows == report[0]["block_rows"]
    # tuned default serves identically to an explicit tiling
    rng = np.random.default_rng(1)
    q = rng.standard_normal((4, idx.dim)).astype(np.float32)
    tuned = idx2.search(q, k=5, nprobe=4, mode="scan")
    explicit = idx2.search(q, k=5, nprobe=4, mode="scan", block_rows=128)
    np.testing.assert_array_equal(tuned.indices, explicit.indices)


# --------------------------------------------------------------- sparse ---


def _sparse_file(n=300, d=64, seed=0):
    from metrovector_tpu import Builder, DataType, VectorType

    rng = np.random.default_rng(seed)
    b = Builder()
    b.add_vector_space("sp", dim=d, vector_type=VectorType.SPARSE,
                       dtype=DataType.FLOAT32)
    rows = []
    for _ in range(n):
        nnz = int(rng.integers(1, 6))
        cols = np.sort(rng.choice(d, size=nnz, replace=False)).astype(np.int32)
        vals = rng.standard_normal(nnz).astype(np.float32)
        rows.append((cols, vals))
    b.add_sparse_vectors("sp", rows)
    path = os.path.join(tempfile.mkdtemp(), "sp.mvt")
    b.build().save(path)
    return path


def test_sparse_autotune_persist_and_adopt():
    from metrovector_tpu import Reader
    from metrovector_tpu.sparse import SparseSearchEngine

    path = _sparse_file()
    eng = SparseSearchEngine(Reader.open(path).vector_space("sp"))
    assert eng.formulation == "ell"
    report = eng.autotune(
        k=3, batch=4, block_rows_candidates=[4096, 8192], iters=1,
        persist=True,
    )
    assert np.isfinite(report[0]["ms"])
    assert eng.block_rows == report[0]["block_rows"]
    # a non-divisor candidate is skipped, not crashed on
    rep2 = SparseSearchEngine(
        Reader.open(path).vector_space("sp")
    ).autotune(k=3, batch=4, block_rows_candidates=[3000, 8192], iters=1)
    skipped = [r for r in rep2 if r["block_rows"] == 3000][0]
    assert "skipped" in skipped
    # fresh engine adopts the persisted tiling, results stay exact
    eng2 = SparseSearchEngine(Reader.open(path).vector_space("sp"))
    assert eng2.block_rows == report[0]["block_rows"]
    rng = np.random.default_rng(1)
    q = rng.standard_normal((4, eng2.dim)).astype(np.float32)
    baseline = SparseSearchEngine(Reader.open(path).vector_space("sp"))
    baseline.block_rows = None
    np.testing.assert_array_equal(
        eng2.search(q, k=3).indices, baseline.search(q, k=3).indices
    )


def test_sparse_invalid_block_rows_rejected_at_search():
    from metrovector_tpu import Reader
    from metrovector_tpu.sparse import SparseSearchEngine

    path = _sparse_file()
    eng = SparseSearchEngine(Reader.open(path).vector_space("sp"))
    eng.block_rows = 3000  # does not divide the 8192-padded row count
    with pytest.raises(ValueError, match="divide"):
        eng.search(np.zeros((1, eng.dim), np.float32), k=1)


# ------------------------------------------------------------------ CLI ---


def test_cli_tune_save_persists_hints(capsys):
    from metrovector_tpu import Reader
    from metrovector_tpu.__main__ import main

    path, _ = _dense_file()
    assert main([
        "tune", path, "-s", "v", "-k", "3", "--batch", "4",
        "--block-rows", "64,128", "--save",
    ]) == 0
    capsys.readouterr()
    tuned = Reader.open(path).manifest.hints["tuned"]["v"]["dense"]
    assert tuned == {"block_rows": tuned["block_rows"]}
    assert tuned["block_rows"] in (64, 128)


@pytest.mark.parametrize("family", ["dense", "adc"])
def test_stale_hint_keys_ignored_on_read(family):
    """Files tuned by older versions carry the retired kernel knobs
    (``query_tile``, ``merge``) next to ``block_rows``: reading them keeps
    ``block_rows`` only, and engines open and search normally."""
    from metrovector_tpu import Reader, SearchEngine
    from metrovector_tpu.format.builder import rewrite_hints
    from metrovector_tpu.utils.tune import tuned_hints

    path, data = _dense_file() if family == "dense" else _pq_file()
    rewrite_hints(path, {"tuned": {"v": {family: {
        "block_rows": 64, "query_tile": 256, "merge": "pool",
    }}}})
    sp = Reader.open(path).vector_space("v")
    assert tuned_hints(sp, family) == {"block_rows": 64}
    if family == "dense":
        eng = SearchEngine(sp)
        assert eng.block_rows == 64
        q = data[:2]
        assert (eng.search(q, k=1).indices[:, 0] == [0, 1]).all()
    else:
        from metrovector_tpu.index import PQIndex

        assert PQIndex.from_space(sp).adc_block_rows == 64
