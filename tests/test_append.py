"""Append/update workflow: ``builder_from_reader`` loads a file back into
a Builder so rows can be appended and deletions accumulated across
rebuild cycles — a lifecycle the reference cannot express (its builds are
one-shot, ``src/builder.rs``)."""

import numpy as np
import pytest

from metrovector_tpu import Builder, Reader, builder_from_reader
from metrovector_tpu.errors import BuildError
from metrovector_tpu.format.constants import DataType, DistanceMetric


def test_append_rows_and_metadata(tmp_path, rng):
    data1 = rng.standard_normal((20, 8)).astype(np.float32)
    b = Builder()
    b.add_vector_space("e", dim=8)
    b.add_vectors("e", data1)
    b.add_metadata_column("e", "tag", [f"a{i}" for i in range(20)])
    p1 = tmp_path / "v1.mvt"
    b.build().save(p1)

    data2 = rng.standard_normal((12, 8)).astype(np.float32)
    b2 = builder_from_reader(Reader.open(p1))
    b2.add_vectors("e", data2)
    b2.extend_metadata_column("e", "tag", [f"b{i}" for i in range(12)])
    p2 = tmp_path / "v2.mvt"
    b2.build().save(p2)

    sp = Reader.open(p2).vector_space("e")
    assert sp.num_vectors == 32
    np.testing.assert_array_equal(sp.to_numpy()[:20], data1)
    np.testing.assert_array_equal(sp.to_numpy()[20:], data2)
    tags = sp.metadata_column("tag")
    assert tags[0] == "a0" and tags[20] == "b0" and len(tags) == 32


def test_append_preserves_tombstones_and_ids(tmp_path, rng):
    data = rng.standard_normal((10, 4)).astype(np.float32)
    ids = np.arange(10, dtype=np.uint64) + 100
    b = Builder()
    b.add_vector_space("e", dim=4)
    b.add_vectors("e", data, ids=ids)
    b.delete_vector("e", 3)
    p1 = tmp_path / "v1.mvt"
    b.build().save(p1)

    b2 = builder_from_reader(Reader.open(p1))
    extra = rng.standard_normal((5, 4)).astype(np.float32)
    b2.add_vectors("e", extra, ids=np.arange(5, dtype=np.uint64) + 500)
    b2.delete_vector("e", 7)  # delete another original row
    b2.delete_vector("e", 12)  # and one of the appended rows
    p2 = tmp_path / "v2.mvt"
    b2.build().save(p2)

    sp = Reader.open(p2).vector_space("e")
    assert sp.num_vectors == 15
    mask = sp.tombstone_mask()
    assert set(np.flatnonzero(mask)) == {3, 7, 12}
    assert np.array_equal(
        sp.ids(), np.concatenate([ids, np.arange(5, dtype=np.uint64) + 500])
    )
    # searches exclude carried-over AND new tombstones
    from metrovector_tpu.engine import SearchEngine

    eng = SearchEngine(sp)
    res = eng.search(np.asarray(sp.to_numpy()), k=3)
    assert not np.isin(res.indices, [3, 7, 12]).any()


def test_append_to_id_space_requires_ids(tmp_path, rng):
    data = rng.standard_normal((6, 4)).astype(np.float32)
    b = Builder()
    b.add_vector_space("e", dim=4)
    b.add_vectors("e", data, ids=np.arange(6, dtype=np.uint64))
    p = tmp_path / "x.mvt"
    b.build().save(p)
    b2 = builder_from_reader(Reader.open(p))
    b2.add_vectors("e", data)  # appended rows carry no ids
    with pytest.raises(BuildError):
        b2.build()


def test_append_quantized_space_roundtrip(tmp_path, rng):
    raw = rng.standard_normal((30, 6)).astype(np.float32) * 2 + 1
    b = Builder()
    b.add_vector_space(
        "q", dim=6, dtype=DataType.UINT8, metric=DistanceMetric.L2
    )
    b.add_vectors("q", raw)  # auto-calibrated affine quantization
    p1 = tmp_path / "q1.mvt"
    b.build().save(p1)
    r1 = Reader.open(p1)
    sp1 = r1.vector_space("q")
    codes1 = np.asarray(sp1.to_numpy())

    b2 = builder_from_reader(r1)
    # append raw codes directly (calibration carried over)
    more = rng.integers(0, 256, (4, 6)).astype(np.uint8)
    b2.add_vectors("q", more)
    p2 = tmp_path / "q2.mvt"
    b2.build().save(p2)
    sp2 = Reader.open(p2).vector_space("q")
    assert sp2.num_vectors == 34
    np.testing.assert_array_equal(sp2.to_numpy()[:30], codes1)
    assert sp2.quantization.scale == sp1.quantization.scale
    assert sp2.quantization.zero_point == sp1.quantization.zero_point
