"""Stable vector IDs, tombstone encodings, and format compat floor.

Covers the v2 format additions: the optional per-space u64 ID column
(reference ``vector_ids_block_index``, ``schema/core.fbs:54`` — declared
there, never written), ID-returning search, ID survival through
compaction, SORTED_LIST tombstone emission (``schema/types.fbs:35-39``),
and the version/compat-version acceptance rule
(``schema/mvf.fbs:13-14``).
"""

import numpy as np
import pytest

from metrovector_tpu import Builder, Reader
from metrovector_tpu.errors import BuildError, UnsupportedVersionError
from metrovector_tpu.format.compact import compact
from metrovector_tpu.format.constants import FORMAT_VERSION, TombstoneFormat


def _build_with_ids(tmp_path, rng, n=32, d=8, ids=None):
    data = rng.standard_normal((n, d)).astype(np.float32)
    if ids is None:
        ids = (np.arange(n, dtype=np.uint64) * 7 + 1000)
    b = Builder()
    b.add_vector_space("e", dim=d)
    b.add_vectors("e", data, ids=ids)
    path = tmp_path / "ids.mvt"
    b.build().save(path)
    return path, data, ids


def test_ids_round_trip(tmp_path, rng):
    path, data, ids = _build_with_ids(tmp_path, rng)
    r = Reader.open(path)
    sp = r.vector_space("e")
    assert np.array_equal(sp.ids(), ids)
    assert sp.id_for(3) == int(ids[3])
    assert sp.row_for_id(int(ids[5])) == 5
    with pytest.raises(KeyError):
        sp.row_for_id(2)  # 2 is not among the ids
    # v2 feature present => file declares compat floor 2
    assert r.manifest.compat_version == 2
    assert r.version == FORMAT_VERSION


def test_ids_absent_positions_are_ids(tmp_path, rng, small_file):
    path, _ = small_file
    r = Reader.open(path)
    sp = r.vector_space("embeddings")
    assert sp.ids() is None
    assert sp.id_for(1) == 1
    assert sp.row_for_id(2) == 2
    with pytest.raises(KeyError):
        sp.row_for_id(99)
    # no v2 features => still openable by a v1 reader
    assert r.manifest.compat_version == 1


def test_ids_chunked_and_set_wholesale(tmp_path, rng):
    data = rng.standard_normal((10, 4)).astype(np.float32)
    b = Builder()
    b.add_vector_space("e", dim=4)
    b.add_vectors("e", data[:6], ids=np.arange(100, 106, dtype=np.uint64))
    b.add_vectors("e", data[6:], ids=np.arange(200, 204, dtype=np.uint64))
    path = tmp_path / "c.mvt"
    b.build().save(path)
    sp = Reader.open(path).vector_space("e")
    assert list(sp.ids()[:6]) == list(range(100, 106))
    assert list(sp.ids()[6:]) == list(range(200, 204))

    b2 = Builder()
    b2.add_vector_space("e", dim=4)
    b2.add_vectors("e", data)
    b2.set_vector_ids("e", np.arange(10, dtype=np.uint64) + 5)
    p2 = tmp_path / "w.mvt"
    b2.build().save(p2)
    assert Reader.open(p2).vector_space("e").id_for(0) == 5


def test_ids_validation(tmp_path, rng):
    data = rng.standard_normal((4, 4)).astype(np.float32)
    b = Builder()
    b.add_vector_space("e", dim=4)
    with pytest.raises(BuildError):
        b.add_vectors("e", data, ids=np.arange(3, dtype=np.uint64))
    b.add_vectors("e", data, ids=np.array([1, 2, 3, 3], np.uint64))
    with pytest.raises(BuildError):  # duplicate ids
        b.build()
    b2 = Builder()
    b2.add_vector_space("e", dim=4)
    b2.add_vectors("e", data[:2], ids=np.array([1, 2], np.uint64))
    b2.add_vectors("e", data[2:])  # chunk without ids
    with pytest.raises(BuildError):  # incomplete id coverage
        b2.build()
    with pytest.raises(BuildError):  # wholesale length mismatch
        b2.set_vector_ids("e", np.arange(3, dtype=np.uint64))


def test_search_returns_ids(tmp_path, rng):
    from metrovector_tpu.engine import DeviceSpace, SearchEngine, SearchResult
    from metrovector_tpu.format.constants import DistanceMetric
    from metrovector_tpu.ops.distances import numpy_oracle

    path, data, ids = _build_with_ids(tmp_path, rng, n=64, d=16)
    sp = Reader.open(path).vector_space("e")
    eng = SearchEngine(DeviceSpace.from_space(sp))
    q = rng.standard_normal((3, 16)).astype(np.float32)
    res = eng.search(q, k=70)  # k > n to also exercise sentinel slots
    _, oi = numpy_oracle(q, data, 64, DistanceMetric.L2)
    assert np.array_equal(res.indices[:, :64], oi)
    assert np.array_equal(res.ids[:, :64], ids[oi])
    assert (res.ids[:, 64:] == SearchResult.ID_SENTINEL).all()


def test_search_ids_default_positions(small_file):
    from metrovector_tpu.engine import DeviceSpace, SearchEngine

    path, data = small_file
    sp = Reader.open(path).vector_space("embeddings")
    eng = SearchEngine(DeviceSpace.from_space(sp))
    res = eng.search(data[:1], k=2)
    assert np.array_equal(res.ids, res.indices.astype(np.uint64))


def test_compaction_preserves_ids(tmp_path, rng):
    path, data, ids = _build_with_ids(tmp_path, rng, n=20, d=4)
    r = Reader.open(path)
    # delete rows 0, 7, 19 via a rebuild with tombstones
    b = Builder()
    b.add_vector_space("e", dim=4)
    b.add_vectors("e", data, ids=ids)
    for i in (0, 7, 19):
        b.delete_vector("e", i)
    p2 = tmp_path / "del.mvt"
    b.build().save(p2)
    r2 = Reader.open(p2)
    p3 = tmp_path / "compacted.mvt"
    compact(r2, p3)
    sp3 = Reader.open(p3).vector_space("e")
    keep = np.ones(20, bool)
    keep[[0, 7, 19]] = False
    assert sp3.num_vectors == 17
    assert np.array_equal(sp3.ids(), ids[keep])
    assert np.array_equal(sp3.to_numpy(), data[keep])
    # an external reference by ID still resolves post-compaction
    assert np.allclose(
        sp3.get_vector(sp3.row_for_id(int(ids[8]))).as_f32(), data[8]
    )


def test_compaction_materialize_ids(tmp_path, rng):
    data = rng.standard_normal((12, 4)).astype(np.float32)
    b = Builder()
    b.add_vector_space("e", dim=4)
    b.add_vectors("e", data)
    b.delete_vector("e", 2)
    p = tmp_path / "m.mvt"
    b.build().save(p)
    p2 = tmp_path / "m2.mvt"
    compact(Reader.open(p), p2, materialize_ids=True)
    sp = Reader.open(p2).vector_space("e")
    expect = np.delete(np.arange(12, dtype=np.uint64), 2)
    assert np.array_equal(sp.ids(), expect)
    assert sp.row_for_id(3) == 2  # old position 3 now lives at row 2


def test_sorted_list_tombstones_emitted(tmp_path, rng):
    # 1000 rows, 2 deletions: 4·2 bytes < 125-byte bitmap => SORTED_LIST
    data = rng.standard_normal((1000, 4)).astype(np.float32)
    b = Builder()
    b.add_vector_space("e", dim=4)
    b.add_vectors("e", data)
    b.delete_vector("e", 3)
    b.delete_vector("e", 900)
    p = tmp_path / "sl.mvt"
    b.build().save(p)
    r = Reader.open(p)
    sp = r.vector_space("e")
    assert sp.info.tombstones.format == TombstoneFormat.SORTED_LIST
    mask = sp.tombstone_mask()
    assert mask.sum() == 2 and mask[3] and mask[900]
    # dense deletions still take the bitmap
    b2 = Builder()
    b2.add_vector_space("e", dim=4)
    b2.add_vectors("e", data[:64])
    for i in range(0, 64, 2):
        b2.delete_vector("e", i)
    p2 = tmp_path / "bm.mvt"
    b2.build().save(p2)
    sp2 = Reader.open(p2).vector_space("e")
    assert sp2.info.tombstones.format == TombstoneFormat.BITMAP
    assert sp2.tombstone_mask().sum() == 32


def test_both_tombstone_formats_search_identically(tmp_path, rng):
    """Each persisted tombstone encoding must mask searches exactly like
    the boolean oracle mask (sparse deletions → SORTED_LIST file, dense
    deletions → BITMAP file; the format choice is size-driven)."""
    from metrovector_tpu.engine import DeviceSpace, SearchEngine
    from metrovector_tpu.format.constants import DistanceMetric
    from metrovector_tpu.ops.distances import numpy_oracle

    data = rng.standard_normal((300, 8)).astype(np.float32)
    cases = [
        ([5, 17, 250], TombstoneFormat.SORTED_LIST),
        (list(range(0, 300, 4)), TombstoneFormat.BITMAP),
    ]
    for deleted, expect_fmt in cases:
        b = Builder()
        b.add_vector_space("e", dim=8)
        b.add_vectors("e", data)
        for i in deleted:
            b.delete_vector("e", i)
        p = tmp_path / f"t{int(expect_fmt)}.mvt"
        b.build().save(p)
        sp = Reader.open(p).vector_space("e")
        assert sp.info.tombstones.format == expect_fmt
        eng = SearchEngine(DeviceSpace.from_space(sp))
        res = eng.search(data[:4], k=5)
        mask = np.ones(300, np.float32)
        mask[deleted] = 0
        _, oi = numpy_oracle(
            data[:4], data, 5, DistanceMetric.L2, valid_mask=mask
        )
        assert np.array_equal(res.indices, oi)
        assert not np.isin(res.indices, deleted).any()


def test_compat_floor(tmp_path, rng, small_file):
    path, _ = small_file
    # a v1-era file (version=1, no compat field) must open under v2
    b = Builder()
    b.add_vector_space("e", dim=4)
    b.add_vectors("e", rng.standard_normal((3, 4)).astype(np.float32))
    built = b.build()
    built.manifest.version = 1
    built.manifest.compat_version = 1
    p1 = tmp_path / "v1.mvt"
    built.save(p1)
    r = Reader.open(p1)
    assert r.version == 1

    # a future file demanding a newer reader must be rejected
    built2 = Builder()
    built2.add_vector_space("e", dim=4)
    built2.add_vectors("e", rng.standard_normal((3, 4)).astype(np.float32))
    bf = built2.build()
    bf.manifest.version = FORMAT_VERSION + 5
    bf.manifest.compat_version = FORMAT_VERSION + 1
    p2 = tmp_path / "future.mvt"
    bf.save(p2)
    with pytest.raises(UnsupportedVersionError):
        Reader.open(p2)

    # a future file that stays compatible (compat floor <= ours) opens
    bf.manifest.compat_version = 1
    p3 = tmp_path / "future_compat.mvt"
    bf.save(p3)
    assert Reader.open(p3).version == FORMAT_VERSION + 5


def test_short_metadata_column_rejected(rng):
    """Columns must cover every row at build (review finding r2: a short
    column built fine and corrupted later rebuilds)."""
    data = rng.standard_normal((5, 4)).astype(np.float32)
    b = Builder()
    b.add_vector_space("e", dim=4)
    b.add_vectors("e", data)
    b.add_metadata_column("e", "t", ["x", "y"])  # 2 values, 5 rows
    with pytest.raises(BuildError):
        b.build()


def test_ids_block_validated(tmp_path, rng):
    """validate() must cover the v2 ids_block (review finding r2)."""
    path, data, ids = _build_with_ids(tmp_path, rng, n=8, d=4)
    r = Reader.open(path)
    from metrovector_tpu.errors import CorruptedDataError

    # out-of-range block id
    r.manifest.spaces[0].ids_block = 999
    with pytest.raises(CorruptedDataError):
        r.validate()
    # truncated id block (points at a block smaller than 8 rows × 8 bytes)
    r2 = Reader.open(path)
    small = min(
        range(len(r2.manifest.blocks)),
        key=lambda i: r2.manifest.blocks[i].size,
    )
    if r2.manifest.blocks[small].size < 8 * 8:
        r2.manifest.spaces[0].ids_block = small
        with pytest.raises(CorruptedDataError):
            r2.validate()


def test_ids_with_tombstones_and_streaming(tmp_path, rng):
    """Combination: ID column + tombstones + streamed search — results
    must carry IDs, exclude deletions, and match the resident engine."""
    from metrovector_tpu.engine import DeviceSpace, SearchEngine
    from metrovector_tpu.parallel import StreamingSearcher

    data = rng.standard_normal((200, 16)).astype(np.float32)
    ids = np.arange(200, dtype=np.uint64) + 77
    b = Builder()
    b.add_vector_space("e", dim=16)
    b.add_vectors("e", data, ids=ids)
    for r in (3, 50):
        b.delete_vector("e", r)
    p = tmp_path / "c.mvt"
    b.build().save(p)
    sp = Reader.open(p).vector_space("e")
    q = rng.standard_normal((4, 16)).astype(np.float32)
    res_s = StreamingSearcher(sp, chunk_rows=64).search(q, k=5)
    res_r = SearchEngine(DeviceSpace.from_space(sp)).search(q, k=5)
    assert np.array_equal(res_s.indices, res_r.indices)
    assert np.array_equal(res_s.ids, res_r.ids)
    assert np.array_equal(res_s.ids, ids[res_s.indices])
    assert not np.isin(res_s.indices, [3, 50]).any()


def test_ids_survive_append_then_compact_cycle(tmp_path, rng):
    """Lifecycle chain: ids -> append -> delete -> compact -> search by id."""
    from metrovector_tpu import builder_from_reader
    from metrovector_tpu.engine import SearchEngine

    data = rng.standard_normal((30, 8)).astype(np.float32)
    ids = np.arange(30, dtype=np.uint64) * 10
    b = Builder()
    b.add_vector_space("e", dim=8)
    b.add_vectors("e", data, ids=ids)
    p1 = tmp_path / "1.mvt"
    b.build().save(p1)

    b2 = builder_from_reader(Reader.open(p1))
    extra = rng.standard_normal((5, 8)).astype(np.float32)
    b2.add_vectors("e", extra, ids=np.arange(5, dtype=np.uint64) + 7001)
    b2.delete_vector("e", 4)
    p2 = tmp_path / "2.mvt"
    b2.build().save(p2)

    p3 = tmp_path / "3.mvt"
    compact(Reader.open(p2), p3)
    sp = Reader.open(p3).vector_space("e")
    assert sp.num_vectors == 34
    eng = SearchEngine.open(p3)
    res = eng.search(extra[:1], k=1)
    assert res.ids[0, 0] == 7001
    # deleted row's id is gone; its neighbors renumbered but resolvable
    with pytest.raises(KeyError):
        sp.row_for_id(40)  # id of deleted row 4
    assert sp.row_for_id(50) == 4  # old row 5 slid down
