"""Engine-level scan tiling (``block_rows``) + single-launch autotune.

These tests pin that the knob actually reaches the scan, that every tuned
configuration stays bit-for-rank exact, and that autotune's measure/apply
loop works. Reference analog: none (the reference has no scan to
tune)."""

import numpy as np
import pytest


def _engine(n=300, d=16, seed=3, **kw):
    from metrovector_tpu import Builder, Reader, SearchEngine

    rng = np.random.default_rng(seed)
    data = rng.standard_normal((n, d)).astype(np.float32)
    import os, tempfile

    b = Builder()
    b.add_vector_space("v", dim=d)
    b.add_vectors("v", data)
    path = os.path.join(tempfile.mkdtemp(), "t.mvt")
    b.build().save(path)
    eng = SearchEngine(Reader.open(path).vector_space("v"), **kw)
    return eng, data, rng


def test_explicit_tile_knobs_stay_exact():
    """A block_rows override reaches the scan and results stay
    oracle-equal (exactness is tile-independent by design); the retired
    kernel knobs are refused."""
    from metrovector_tpu import DistanceMetric
    from metrovector_tpu.ops import numpy_oracle

    with pytest.raises(TypeError):
        _engine(block_rows=64, query_tile=128)
    with pytest.raises(TypeError):
        _engine(merge="pool")
    eng, data, rng = _engine(block_rows=64)
    assert eng.block_rows == 64
    q = rng.standard_normal((4, 16)).astype(np.float32)
    res = eng.search(q, k=6)
    _, oi = numpy_oracle(q, data, 6, DistanceMetric.L2)
    assert np.array_equal(res.indices, oi)


def test_autotune_measures_applies_and_stays_exact():
    from metrovector_tpu import DistanceMetric
    from metrovector_tpu.ops import numpy_oracle

    eng, data, rng = _engine()
    q = rng.standard_normal((4, 16)).astype(np.float32)
    report = eng.autotune(
        queries=q, k=5,
        block_rows_candidates=[64, 128],
        iters=1,
    )
    assert len(report) == 2
    assert report == sorted(report, key=lambda r: r["ms"])
    assert all(set(r) == {"block_rows", "ms"} for r in report)
    # winner applied
    assert eng.block_rows == report[0]["block_rows"]
    # tuned engine still exact
    res = eng.search(q, k=5)
    _, oi = numpy_oracle(q, data, 5, DistanceMetric.L2)
    assert np.array_equal(res.indices, oi)

    # apply=False leaves knobs untouched
    eng2, _, _ = _engine()
    eng2.autotune(queries=q, k=5, block_rows_candidates=[64],
                  iters=1, apply=False)
    assert eng2.block_rows is None


def test_autotune_default_candidates_clamp_to_corpus():
    """The default candidate list (sized for million-row corpora) runs on
    a tiny corpus too: every candidate clamps to one block and measures a
    finite time, and the tuned engine stays exact."""
    from metrovector_tpu import DistanceMetric
    from metrovector_tpu.ops import numpy_oracle
    from metrovector_tpu.ops.distances import DEFAULT_BLOCK_ROWS
    from metrovector_tpu.utils.tune import block_rows_around

    eng, data, rng = _engine()
    q = rng.standard_normal((4, 16)).astype(np.float32)
    report = eng.autotune(queries=q, k=5, iters=1)
    assert sorted(r["block_rows"] for r in report) == block_rows_around(
        DEFAULT_BLOCK_ROWS
    )
    assert all(np.isfinite(r["ms"]) for r in report)
    res = eng.search(q, k=5)
    _, oi = numpy_oracle(q, data, 5, DistanceMetric.L2)
    assert np.array_equal(res.indices, oi)


def test_database_engine_kwargs_reach_the_kernel():
    """Database(engine_kwargs=...) threads a tuned tiling into every dense
    engine it builds; results stay oracle-equal."""
    import os, tempfile

    from metrovector_tpu import Builder, Database, DistanceMetric
    from metrovector_tpu.ops import numpy_oracle

    rng = np.random.default_rng(6)
    data = rng.standard_normal((150, 8)).astype(np.float32)
    b = Builder()
    b.add_vector_space("v", dim=8)
    b.add_vectors("v", data)
    path = os.path.join(tempfile.mkdtemp(), "dbk.mvt")
    b.build().save(path)

    db = Database.open(path, engine_kwargs={"block_rows": 64})
    eng = db.engine("v")
    assert eng.block_rows == 64
    q = rng.standard_normal((3, 8)).astype(np.float32)
    res = db.search("v", q, k=4)
    _, oi = numpy_oracle(q, data, 4, DistanceMetric.L2)
    assert np.array_equal(res.indices, oi)


def test_autotune_on_quantized_space_stays_exact():
    """autotune exercises the uint8 offset path (rowsums bias inputs)
    without disturbing its integer-exact ranking."""
    import os, tempfile

    from metrovector_tpu import (
        Builder, DataType, DistanceMetric, Reader, SearchEngine,
    )
    from metrovector_tpu.ops import numpy_oracle

    rng = np.random.default_rng(12)
    data = rng.integers(0, 256, (400, 32)).astype(np.float32)
    b = Builder()
    b.add_vector_space(
        "u", dim=32, dtype=DataType.UINT8, metric=DistanceMetric.L2
    ).with_quantization(scale=1.0, zero_point=0.0)
    b.add_vectors("u", data)
    path = os.path.join(tempfile.mkdtemp(), "u8t.mvt")
    b.build().save(path)

    eng = SearchEngine(Reader.open(path).vector_space("u"))
    q = rng.integers(0, 256, (4, 32)).astype(np.float32)
    report = eng.autotune(queries=q, k=5,
                          block_rows_candidates=[64, 128], iters=1)
    assert len(report) == 2 and np.isfinite(report[0]["ms"])
    res = eng.search(q, k=5)
    _, oi = numpy_oracle(q, data, 5, DistanceMetric.L2)
    assert np.array_equal(res.indices, oi)


def test_autotune_records_skipped_oversized_tiles():
    """A candidate carrying a 'skipped' note is recorded in the report
    unmeasured (advisor r4: it used to vanish, implying coverage the run
    never measured), and a candidate that raises records its error; the
    measured candidate still wins."""
    from metrovector_tpu.utils.tune import measure_candidates

    calls = []

    def run_with(cfg):
        def run():
            calls.append(cfg["block_rows"])
            if cfg["block_rows"] == 3:
                raise RuntimeError("out of memory")
        return run

    report = measure_candidates(
        [{"block_rows": 1}, {"block_rows": 2, "skipped": "too big"},
         {"block_rows": 3}],
        run_with, iters=1,
    )
    assert [r["block_rows"] for r in report][0] == 1
    assert np.isfinite(report[0]["ms"])
    skipped = [r for r in report if "skipped" in r]
    assert len(skipped) == 1 and skipped[0]["ms"] == float("inf")
    failed = [r for r in report if "error" in r]
    assert len(failed) == 1 and "out of memory" in failed[0]["error"]
    assert 2 not in calls
