"""Compaction: rebuilding without tombstoned rows preserves everything
else (values, metadata, quantization, index config, hints)."""

import numpy as np
import pytest

from metrovector_tpu import Builder, DataType, DistanceMetric, Reader, VectorType
from metrovector_tpu.format.compact import compact
from metrovector_tpu.engine import SearchEngine
from metrovector_tpu.ops import numpy_oracle


def test_compact_dense(tmp_path, rng):
    data = rng.standard_normal((50, 16)).astype(np.float32)
    b = Builder()
    b.add_vector_space("v", dim=16).with_ivf_index(num_clusters=4)
    b.add_vectors("v", data)
    b.add_metadata_column("v", "id", list(range(50)))
    b.add_metadata_column("v", "name", [f"n{i}" for i in range(50)])
    b.set_hint("stream_chunk_rows", 77)
    for i in (3, 10, 49):
        b.delete_vector("v", i)
    src = tmp_path / "src.mvt"
    b.build().save(src)

    dst = tmp_path / "dst.mvt"
    compact(Reader.open(src), dst)

    r = Reader.open(dst)
    r.validate_with_checksum()
    sp = r.vector_space("v")
    keep = np.ones(50, bool)
    keep[[3, 10, 49]] = False
    assert sp.num_vectors == 47
    np.testing.assert_array_equal(sp.to_numpy(), data[keep])
    assert sp.tombstone_mask() is None
    np.testing.assert_array_equal(sp.metadata_column("id"), np.arange(50)[keep])
    assert sp.metadata_column("name")[3] == "n4"  # renumbered past deleted 3
    assert r.manifest.hints["stream_chunk_rows"] == 77
    assert sp.info.index.params["num_clusters"] == 4

    # search result parity with masked search on the original
    q = rng.standard_normal((3, 16)).astype(np.float32)
    res = SearchEngine(sp).search(q, k=5)
    _, oi = numpy_oracle(q, data[keep], 5, DistanceMetric.L2)
    assert np.array_equal(res.indices, oi)


def test_compact_quantized_preserves_codes(tmp_path, rng):
    x = rng.standard_normal((30, 8)).astype(np.float32)
    b = Builder()
    b.add_vector_space("q", dim=8, dtype=DataType.INT8)
    b.add_vectors("q", x)
    b.delete_vector("q", 0)
    src = tmp_path / "s.mvt"
    b.build().save(src)
    sp0 = Reader.open(src).vector_space("q")
    codes0 = sp0.to_numpy().copy()
    scale0 = sp0.quantization.scale

    dst = tmp_path / "d.mvt"
    compact(Reader.open(src), dst)
    sp1 = Reader.open(dst).vector_space("q")
    assert sp1.quantization.scale == pytest.approx(scale0)
    np.testing.assert_array_equal(sp1.to_numpy(), codes0[1:])


def test_compact_sparse(tmp_path, rng):
    b = Builder()
    b.add_vector_space("s", dim=32, vector_type=VectorType.SPARSE)
    b.add_sparse_vectors(
        "s", [([1, 5], [1.0, 2.0]), ([0], [3.0]), ([2, 9], [4.0, 5.0])]
    )
    b.delete_vector("s", 1)
    src = tmp_path / "s.mvt"
    b.build().save(src)
    dst = tmp_path / "d.mvt"
    compact(Reader.open(src), dst)
    sp = Reader.open(dst).vector_space("s")
    assert sp.num_vectors == 2
    np.testing.assert_array_equal(sp.get_vector(1).cols, [2, 9])


def test_compact_drops_stale_hnsw_graph_keeps_config(tmp_path, rng):
    """Persisted HNSW graphs reference pre-compaction row ids and block
    ids; compact must strip them (config survives) so from_space rebuilds
    a valid graph instead of dereferencing stale blocks."""
    from metrovector_tpu.format.constants import IndexKind
    from metrovector_tpu.index import HNSWIndex
    from metrovector_tpu.ops import numpy_oracle

    data = rng.standard_normal((120, 8)).astype(np.float32)
    idx = HNSWIndex.build(data, DistanceMetric.L2, m=8, ef_construction=60)
    b = Builder()
    b.add_vector_space("s", dim=8)
    b.add_vectors("s", data)
    b.set_hnsw_index("s", idx.layers, idx.entry, m=8, ef_construction=60)
    b.delete_vector("s", 10)
    src = tmp_path / "src.mvt"
    b.build().save(src)
    dst = tmp_path / "dst.mvt"
    compact(Reader.open(src), dst)

    sp = Reader.open(dst).vector_space("s")
    assert sp.num_vectors == 119
    assert sp.info.index.kind == IndexKind.HNSW
    assert sp.info.index.params == {"m": 8, "ef_construction": 60}
    assert sp.hnsw_arrays() is None
    rebuilt = HNSWIndex.from_space(sp)  # rebuilds over renumbered rows
    kept = np.concatenate([data[:10], data[11:]])
    res = rebuilt.search(kept[:3], k=1, ef=64)
    assert np.array_equal(res.indices[:, 0], [0, 1, 2])


def test_compact_preserves_extensions_and_security(tmp_path, rng):
    b = Builder()
    b.add_vector_space("s", dim=4)
    b.add_vectors("s", rng.standard_normal((10, 4)).astype(np.float32))
    b.add_extension("lineage", b"\x01payload\xff")
    b.set_security(scheme="none", encrypted=False)
    b.delete_vector("s", 2)
    src = tmp_path / "src.mvt"
    b.build().save(src)
    dst = tmp_path / "dst.mvt"
    compact(Reader.open(src), dst)
    r = Reader.open(dst)
    r.validate_with_checksum()
    assert bytes(r.extension("lineage", verify=True)) == b"\x01payload\xff"
    assert r.security == {"scheme": "none", "encrypted": False}


def test_ivfpq_open_skips_reconstruction(tmp_path, rng, monkeypatch):
    """With full persisted sidecars, opening must not re-reconstruct the
    corpus (O(1)-open: recon norms come from the file)."""
    from metrovector_tpu import train_ivfpq
    from metrovector_tpu.index import IVFPQIndex
    from metrovector_tpu.index import ivfpq as ivfpq_mod

    data = rng.standard_normal((80, 16)).astype(np.float32)
    cents, assign, books, codes = train_ivfpq(data, 4, m=4, ksub=8, iters=3)
    b = Builder()
    b.add_vector_space("s", dim=16)
    b.add_vectors("s", data)
    b.set_ivf_index("s", cents, assign)
    b.set_pq_index("s", books, codes, residual=True)
    path = tmp_path / "x.mvt"
    b.build().save(path)

    calls = []
    orig = ivfpq_mod.reconstruct_pq
    monkeypatch.setattr(
        ivfpq_mod, "reconstruct_pq", lambda *a: (calls.append(1), orig(*a))[1]
    )
    sp = Reader.open(path).vector_space("s")
    idx = IVFPQIndex.from_space(sp)
    assert not calls  # no reconstruction on open
    res = idx.search(data[:2], k=1, nprobe=4, rerank=80)
    assert np.array_equal(res.indices[:, 0], [0, 1])
