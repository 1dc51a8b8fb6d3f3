"""The ``python -m metrovector_tpu`` inspector CLI: info / validate /
head / search over real files. The reference has no tooling surface at
all (its runnable surfaces are examples only)."""

import numpy as np
import pytest

from metrovector_tpu import Builder, DataType, DistanceMetric, VectorType
from metrovector_tpu.__main__ import main


@pytest.fixture
def mixed_file(tmp_path, rng):
    b = Builder()
    b.add_vector_space("dense", dim=8, dtype=DataType.FLOAT32)
    data = rng.standard_normal((40, 8)).astype(np.float32)
    b.add_vectors("dense", data)
    b.set_vector_ids("dense", np.arange(100, 140, dtype=np.uint64))
    b.add_metadata_column("dense", "tag", [f"t{i}" for i in range(40)])
    b.delete_vector("dense", 3)
    b.add_vector_space("sp", dim=32, vector_type=VectorType.SPARSE)
    b.add_sparse_vectors(
        "sp",
        [(rng.choice(32, 4, replace=False),
          rng.standard_normal(4).astype(np.float32)) for _ in range(20)],
    )
    path = tmp_path / "cli.mvt"
    b.build().save(path)
    return str(path), data


def test_cli_info(mixed_file, capsys):
    path, _ = mixed_file
    assert main(["info", path]) == 0
    out = capsys.readouterr().out
    assert "2 space(s)" in out
    assert "dense: 40 x 8 float32 dense, metric=l2" in out
    assert "sp: 20 x 32 float32 sparse" in out
    assert "stable u64 ids: yes" in out
    assert "tombstones: 1 deleted" in out
    assert "metadata: tag" in out


def test_cli_validate(mixed_file, tmp_path, capsys):
    path, _ = mixed_file
    assert main(["validate", path, "--checksum"]) == 0
    assert "OK (checksums verified)" in capsys.readouterr().out
    # corrupt a data byte -> checksum validation fails with exit 1
    raw = bytearray(open(path, "rb").read())
    raw[len(raw) // 3] ^= 0xFF
    bad = tmp_path / "bad.mvt"
    bad.write_bytes(bytes(raw))
    rc = main(["validate", str(bad), "--checksum"])
    out = capsys.readouterr().out
    assert rc == 1 and "INVALID" in out


def test_cli_head(mixed_file, capsys):
    path, data = mixed_file
    assert main(["head", path, "-s", "dense", "-n", "2"]) == 0
    out = capsys.readouterr().out
    assert out.count("[0]") == 1 and "[1]" in out
    assert main(["head", path, "-s", "sp", "-n", "1"]) == 0
    assert "nnz=4" in capsys.readouterr().out


def test_cli_search(mixed_file, tmp_path, capsys):
    import json

    path, data = mixed_file
    qf = tmp_path / "q.npy"
    np.save(qf, data[7])
    assert main(["search", path, "-q", str(qf), "-s", "dense", "-k", "3"]) == 0
    rows = json.loads(capsys.readouterr().out.strip())["results"]
    assert rows[0]["row"] == 7 and rows[0]["id"] == 107
    assert rows[0]["distance"] == pytest.approx(0.0, abs=1e-4)

    # space disambiguation error
    with pytest.raises(SystemExit):
        main(["head", path])
    with pytest.raises(SystemExit):
        main(["head", path, "-s", "nope"])


def test_cli_tune(mixed_file, capsys):
    import json

    path, data = mixed_file
    assert main([
        "tune", path, "-s", "dense", "-k", "3", "--batch", "4",
        "--block-rows", "32,64",
    ]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    report = [r for r in lines if "block_rows" in r]
    assert len(report) == 2
    assert report == sorted(report, key=lambda r: r["ms"])
    assert any("applied" in r for r in lines)

    # sparse spaces route to the ELL engine's autotune (round-5)
    assert main([
        "tune", path, "-s", "sp", "-k", "2", "--batch", "4",
        "--block-rows", "8192",
    ]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    assert any("applied" in r for r in lines)

    # --index without a persisted PQ/IVF-PQ sidecar is refused cleanly
    assert main(["tune", path, "-s", "dense", "--index"]) == 1
