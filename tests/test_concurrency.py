"""Concurrent shared-reader access: many threads over one mmap reader and
one engine must observe identical, correct results (the reference's
Send+Sync contract, ``src/reader.rs:281-289``, exercised for real instead
of by compile-time marker assertions)."""

import concurrent.futures as cf

import numpy as np

from metrovector_tpu import Builder, Reader
from metrovector_tpu.engine import SearchEngine


def test_many_threads_one_reader(tmp_path, rng):
    data = rng.standard_normal((500, 24)).astype(np.float32)
    b = Builder()
    b.add_vector_space("v", dim=24)
    b.add_vectors("v", data)
    b.add_metadata_column("v", "id", list(range(500)))
    path = tmp_path / "c.mvt"
    b.build().save(path)

    reader = Reader.open(path)
    space = reader.vector_space("v")

    def worker(seed):
        sp = space.clone_concurrent()
        r = np.random.default_rng(seed)
        for _ in range(50):
            i = int(r.integers(0, 500))
            np.testing.assert_array_equal(sp.get_vector(i).as_f32(), data[i])
        sl = sp.map_vector_range(10, 50).clone_concurrent()
        np.testing.assert_array_equal(sl.to_numpy(), data[10:60])
        assert sp.metadata_column("id")[i] == i
        return True

    with cf.ThreadPoolExecutor(8) as ex:
        assert all(ex.map(worker, range(16)))


def test_many_threads_one_engine(tmp_path, rng):
    data = rng.standard_normal((300, 16)).astype(np.float32)
    b = Builder()
    b.add_vector_space("v", dim=16)
    b.add_vectors("v", data)
    path = tmp_path / "e.mvt"
    b.build().save(path)
    eng = SearchEngine.open(path)

    def worker(qid):
        res = eng.search(data[qid], k=1)
        return int(res.indices[0, 0]) == qid

    with cf.ThreadPoolExecutor(6) as ex:
        assert all(ex.map(worker, range(24)))
