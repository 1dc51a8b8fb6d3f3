"""Native C++ codec parity: CRC, packing and norms must match the pure
Python/numpy implementations bit-for-bit, and files built with either path
must be byte-identical."""

import os
import zlib

import numpy as np
import pytest

from metrovector_tpu import Builder, DataType, Reader
from metrovector_tpu import native
from metrovector_tpu.format.constants import padded_dim_for, padded_rows_for

needs_native = pytest.mark.skipif(
    not native.available(), reason="native codec unavailable"
)


@needs_native
def test_crc32_matches_zlib(rng):
    for size in (0, 1, 7, 8, 9, 1000, 65537):
        data = rng.integers(0, 256, size, dtype=np.uint8)
        assert native.crc32(data) == zlib.crc32(data.tobytes()) & 0xFFFFFFFF
    # incremental
    a, b = rng.integers(0, 256, 100, dtype=np.uint8), rng.integers(0, 256, 50, dtype=np.uint8)
    c1 = native.crc32(b, native.crc32(a))
    assert c1 == zlib.crc32(b.tobytes(), zlib.crc32(a.tobytes())) & 0xFFFFFFFF


@needs_native
@pytest.mark.parametrize(
    "dtype,np_dt",
    [
        (DataType.FLOAT32, np.float32),
        (DataType.FLOAT16, np.float16),
        (DataType.INT8, np.int8),
        (DataType.UINT8, np.uint8),
    ],
)
def test_pack_block_fused_parity(rng, dtype, np_dt):
    n, d = 37, 12
    if np_dt in (np.int8, np.uint8):
        rows = rng.integers(-100 if np_dt == np.int8 else 0, 100, (n, d)).astype(np_dt)
    else:
        rows = rng.standard_normal((n, d)).astype(np_dt)
    pr = padded_rows_for(n, dtype)
    pd = padded_dim_for(d, True)
    out = native.pack_block_fused(rows, pr, pd, int(dtype), 1.0, 0.0)
    assert out is not None
    block, norms, crc = out
    # padding correctness
    assert block.shape == (pr, pd)
    np.testing.assert_array_equal(block[:n, :d], rows)
    assert np.count_nonzero(block[n:]) == 0
    assert np.count_nonzero(block[:, d:]) == 0
    # norms parity (f64 accumulation both sides)
    expect = (rows.astype(np.float64) ** 2).sum(1).astype(np.float32)
    np.testing.assert_allclose(norms[:n], expect, rtol=1e-6)
    assert np.count_nonzero(norms[n:]) == 0
    # CRC over packed bytes
    assert crc == zlib.crc32(block.tobytes()) & 0xFFFFFFFF


@needs_native
def test_bf16_norms(rng):
    import ml_dtypes

    rows = rng.standard_normal((10, 8)).astype(ml_dtypes.bfloat16)
    pr, pd = padded_rows_for(10, DataType.BFLOAT16), padded_dim_for(8, True)
    block, norms, _ = native.pack_block_fused(rows, pr, pd, int(DataType.BFLOAT16))
    expect = (rows.astype(np.float64) ** 2).sum(1).astype(np.float32)
    np.testing.assert_allclose(norms[:10], expect, rtol=1e-6)


@needs_native
def test_quantized_norms_dequant_space(rng):
    codes = rng.integers(-128, 128, (20, 16)).astype(np.int8)
    scale, zp = 0.05, 0.0
    pr, pd = padded_rows_for(20, DataType.INT8), padded_dim_for(16, True)
    _, norms, _ = native.pack_block_fused(codes, pr, pd, int(DataType.INT8), scale, zp)
    expect = ((codes.astype(np.float64) - zp) * scale) ** 2
    np.testing.assert_allclose(norms[:20], expect.sum(1), rtol=1e-5)


def _build_image(rng, env_no_native, monkeypatch):
    data = rng.standard_normal((100, 48)).astype(np.float32)
    b = Builder()
    b.add_vector_space("s", dim=48)
    b.add_vectors("s", data)
    b.add_metadata_column("s", "tag", ["x", "y"] * 50)
    return b.build().to_bytes()


@needs_native
def test_native_and_python_builds_identical(rng, monkeypatch):
    rng2 = np.random.default_rng(0)
    img_native = _build_image(rng2, False, monkeypatch)

    # Force the pure-python path and rebuild the same file.
    import metrovector_tpu.native as nat

    monkeypatch.setattr(nat, "pack_block_fused", lambda *a, **k: None)
    rng3 = np.random.default_rng(0)
    img_py = _build_image(rng3, True, monkeypatch)
    assert img_native == img_py
    r = Reader.from_bytes(img_py)
    r.validate_with_checksum()


# ------------------------------------------------------ streaming prep ---
# Fused chunk-prep twins (parallel/streaming.py slice_chunk): the native
# single pass must match the numpy multi-pass bit-for-bit, including the
# zero pad tail, the tombstone tail and the dim->padded_dim column strip.


@needs_native
def test_prep_f16_to_f32_parity(rng):
    src = rng.standard_normal((513, 40)).astype(np.float16)
    src[0, :4] = [np.inf, -np.inf, 0.0, -0.0]
    src[1, 0] = np.float16(6e-8)  # subnormal
    got = native.prep_f16_to_f32(src, 640)
    ref = np.pad(src.astype(np.float32), ((0, 127), (0, 0)))
    assert got.dtype == np.float32 and got.shape == (640, 40)
    assert np.array_equal(got, ref)
    # no padding
    assert np.array_equal(native.prep_f16_to_f32(src, 513)[:513],
                          src.astype(np.float32))


@needs_native
def test_prep_u8_dequant_parity(rng):
    u = rng.integers(0, 256, (301, 24)).astype(np.uint8)
    scale, zp = 0.031, 117.0
    got = native.prep_u8_dequant(u, 384, scale, zp)
    ref = np.pad((u.astype(np.float32) - zp) * scale, ((0, 83), (0, 0)))
    assert np.array_equal(got, ref)


@needs_native
def test_prep_u8_offset_parity(rng):
    u = rng.integers(0, 256, (300, 32)).astype(np.uint8)
    dim, nvalid = 27, 211  # padded cols stripped, tombstone tail zeroed
    got_c, got_b = native.prep_u8_offset(u, 320, dim, nvalid)
    shifted = u.astype(np.int16) - 128
    shifted[:, dim:] = 0
    shifted[nvalid:, :] = 0
    ref_b = shifted[:, :dim].sum(axis=1, dtype=np.int32).astype(np.float32)
    assert np.array_equal(got_c, np.pad(shifted.astype(np.int8),
                                        ((0, 20), (0, 0))))
    assert np.array_equal(got_b, np.pad(ref_b, (0, 20)))
    # nvalid beyond the chunk is clipped
    c2, b2 = native.prep_u8_offset(u, 300, dim, 10_000)
    shifted = u.astype(np.int16) - 128
    shifted[:, dim:] = 0
    assert np.array_equal(c2, shifted.astype(np.int8))
    assert np.array_equal(
        b2, shifted[:, :dim].sum(axis=1, dtype=np.int32).astype(np.float32)
    )


# ------------------------------------------------- per-host build keying ---


def test_native_libraries_live_in_ignored_build_dir():
    """Built libraries go to <checkout>/.native_build (git-ignored), never
    next to the sources, and no built library is tracked by git."""
    import subprocess

    from metrovector_tpu import native

    root = os.path.dirname(os.path.dirname(native.__file__))
    root = os.path.dirname(root)
    assert native.BUILD_DIR == os.path.join(root, ".native_build")
    with open(os.path.join(root, ".gitignore")) as f:
        ignored = f.read().split()
    assert ".native_build/" in ignored and "*.so" in ignored
    tracked = subprocess.run(
        ["git", "ls-files", "*.so"], cwd=root, capture_output=True,
        text=True,
    )
    if tracked.returncode == 0:  # inside a git checkout
        assert tracked.stdout.strip() == ""


def test_native_library_name_keyed_by_source_command_and_cpu(
    tmp_path, monkeypatch
):
    """A library is found again only for the same source bytes, compiler
    command and host CPU: one built on another machine is never loaded."""
    from metrovector_tpu import native

    src = tmp_path / "x.cpp"
    src.write_text("int f() { return 1; }\n")
    cmd = native._CXX + ["-fopenmp"]
    a = native.library_path(str(src), "x", cmd)
    assert a == native.library_path(str(src), "x", cmd)
    assert os.path.dirname(a) == native.BUILD_DIR
    assert os.path.basename(a).startswith("libx-")
    assert native.library_path(str(src), "x", cmd[:-1]) != a
    src.write_text("int f() { return 2; }\n")
    b = native.library_path(str(src), "x", cmd)
    assert b != a
    monkeypatch.setattr(native, "host_cpu_id", lambda: "another-cpu")
    assert native.library_path(str(src), "x", cmd) != b


def test_host_cpu_id_names_this_machine():
    import platform

    from metrovector_tpu import native

    cid = native.host_cpu_id()
    assert cid.splitlines()[0] == platform.machine()
    if os.path.exists("/proc/cpuinfo"):
        assert len(cid.splitlines()) > 1  # model name / flags present
