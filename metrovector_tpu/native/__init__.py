"""ctypes loader for the native MVT codec.

Compiles ``codec.cpp`` / ``hnsw.cpp`` on first use with the system ``g++``
into ``<checkout>/.native_build`` (git-ignored), then exposes typed
wrappers. The libraries are built with ``-march=native``, so each file
name carries a hash of the source, the compiler command and the host CPU:
a library built on one machine is never loaded on another. Everything here is optional: if
the toolchain is missing or ``MVT_NO_NATIVE=1`` is set, callers fall back to
the numpy implementations in :mod:`..format.packing` — identical semantics,
verified by tests that run both paths.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "codec.cpp")
#: where built libraries live: ``.native_build`` at the checkout root
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(_HERE)), ".native_build"
)
_CXX = ["g++", "-O3", "-march=native", "-fPIC", "-shared", "-std=c++17"]

_lock = threading.Lock()
_lib = None
_tried = False


def host_cpu_id() -> str:
    """Identity of the host CPU that ``-march=native`` compiles for: the
    architecture plus the model name and feature flags of
    ``/proc/cpuinfo`` (Linux), else ``platform.processor()``."""
    parts = [platform.machine()]
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key = line.split(":", 1)[0].strip()
                if key in ("model name", "flags", "Features", "CPU part"):
                    parts.append(line.strip())
                elif not line.strip() and len(parts) > 1:
                    break  # first processor's block is enough
    except OSError:
        parts.append(platform.processor())
    return "\n".join(parts)


def library_path(src: str, name: str, cmd: list[str]) -> str:
    """``BUILD_DIR/lib<name>-<hash>.so``, the hash keyed by the source
    bytes, the compiler command and :func:`host_cpu_id`."""
    h = hashlib.sha256()
    with open(src, "rb") as f:
        h.update(f.read())
    h.update(" ".join(cmd).encode())
    h.update(host_cpu_id().encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def _compile(src: str, name: str, flag_sets: list[list[str]]) -> str | None:
    """Build ``src`` once per (source, command, host CPU) and return the
    library path, trying each extra-flag set in turn; None when no
    toolchain can build it. Writes go to a temporary name first and are
    renamed into place, so concurrent processes never load a partial
    file."""
    for flags in flag_sets:
        cmd = _CXX + flags
        so = library_path(src, name, cmd)
        if os.path.exists(so):
            return so
        try:
            os.makedirs(BUILD_DIR, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
        except OSError:
            return None
        try:
            subprocess.run(
                cmd + [src, "-o", tmp] + _link_flags(name),
                check=True, capture_output=True, timeout=300,
            )
            os.replace(tmp, so)
            return so
        except (OSError, subprocess.SubprocessError):
            if os.path.exists(tmp):
                os.unlink(tmp)
    return None


def _link_flags(name: str) -> list[str]:
    return ["-lz"] if name == "mvtcodec" else []


def _build() -> str | None:
    return _compile(_SRC, "mvtcodec", [["-fopenmp"]])


def load():
    """The loaded codec library, or None when unavailable/disabled."""
    global _lib, _tried
    if _lib is not None:
        return _lib
    if _tried or os.environ.get("MVT_NO_NATIVE") == "1":
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = _build()
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            return None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.mvt_crc32.restype = ctypes.c_uint32
        lib.mvt_crc32.argtypes = [ctypes.c_uint32, u8p, ctypes.c_size_t]
        lib.mvt_pack_rows.restype = None
        lib.mvt_pack_rows.argtypes = [u8p, u8p] + [ctypes.c_size_t] * 5
        lib.mvt_sq_norms.restype = None
        lib.mvt_sq_norms.argtypes = [
            u8p, ctypes.c_size_t, ctypes.c_size_t, ctypes.c_size_t,
            ctypes.c_int, ctypes.c_float, ctypes.c_float, f32p,
        ]
        lib.mvt_pack_block.restype = ctypes.c_uint32
        lib.mvt_pack_block.argtypes = [
            u8p, u8p, ctypes.c_size_t, ctypes.c_size_t, ctypes.c_size_t,
            ctypes.c_size_t, ctypes.c_size_t, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, f32p,
        ]
        lib.mvt_lz4_bound.restype = ctypes.c_size_t
        lib.mvt_lz4_bound.argtypes = [ctypes.c_size_t]
        lib.mvt_lz4_compress.restype = ctypes.c_size_t
        lib.mvt_lz4_compress.argtypes = [u8p, ctypes.c_size_t, u8p,
                                         ctypes.c_size_t]
        lib.mvt_lz4_decompress.restype = ctypes.c_size_t
        lib.mvt_lz4_decompress.argtypes = [u8p, ctypes.c_size_t, u8p,
                                           ctypes.c_size_t]
        i8p = ctypes.POINTER(ctypes.c_int8)
        u16p = ctypes.POINTER(ctypes.c_uint16)
        lib.mvt_prep_f16_to_f32.restype = None
        lib.mvt_prep_f16_to_f32.argtypes = [
            u16p, f32p, ctypes.c_size_t, ctypes.c_size_t,
        ]
        lib.mvt_prep_u8_dequant.restype = None
        lib.mvt_prep_u8_dequant.argtypes = [
            u8p, f32p, ctypes.c_float, ctypes.c_float,
            ctypes.c_size_t, ctypes.c_size_t,
        ]
        lib.mvt_prep_u8_offset.restype = None
        lib.mvt_prep_u8_offset.argtypes = [
            u8p, i8p, f32p, ctypes.c_size_t, ctypes.c_size_t,
            ctypes.c_size_t, ctypes.c_size_t, ctypes.c_size_t,
        ]
        lib.mvt_abi_version.restype = ctypes.c_int
        if lib.mvt_abi_version() != 3:
            return None
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


def _u8(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def crc32(data: np.ndarray | bytes | memoryview, value: int = 0) -> int:
    """zlib-compatible CRC32 via the native slice-by-8 implementation."""
    lib = load()
    buf = np.frombuffer(data, dtype=np.uint8) if not isinstance(data, np.ndarray) \
        else data.reshape(-1).view(np.uint8)
    if lib is None:
        import zlib

        return zlib.crc32(buf.tobytes(), value) & 0xFFFFFFFF
    return int(lib.mvt_crc32(value, _u8(buf), buf.nbytes))


def lz4_compress(data) -> bytes | None:
    """LZ4 block-format compression via the native codec, or None when it
    is unavailable (caller falls back to the pure-Python encoder)."""
    lib = load()
    if lib is None:
        return None
    buf = np.frombuffer(data, dtype=np.uint8) if not isinstance(
        data, np.ndarray
    ) else data.reshape(-1).view(np.uint8)
    out = np.empty(int(lib.mvt_lz4_bound(buf.nbytes)), dtype=np.uint8)
    wrote = lib.mvt_lz4_compress(_u8(buf), buf.nbytes, _u8(out), out.nbytes)
    if wrote == 0 and buf.nbytes:
        return None
    return out[:wrote].tobytes()


def lz4_decompress(data, uncompressed_size: int) -> bytes | None:
    """LZ4 block-format decompression via the native codec; None when the
    codec is unavailable. Raises ValueError on malformed input."""
    lib = load()
    if lib is None:
        return None
    buf = np.frombuffer(data, dtype=np.uint8) if not isinstance(
        data, np.ndarray
    ) else data.reshape(-1).view(np.uint8)
    out = np.empty(max(uncompressed_size, 1), dtype=np.uint8)
    wrote = lib.mvt_lz4_decompress(
        _u8(buf), buf.nbytes, _u8(out), uncompressed_size
    )
    if wrote != uncompressed_size:
        raise ValueError(
            f"malformed LZ4 block: decoded {wrote} of "
            f"{uncompressed_size} expected bytes"
        )
    return out[:uncompressed_size].tobytes()


def pack_block_fused(
    rows: np.ndarray,
    padded_rows: int,
    padded_dim: int,
    dtype_code: int,
    scale: float = 1.0,
    zero_point: float = 0.0,
):
    """Fused pack + dequantized-norms + CRC. ``rows`` is a C-contiguous
    ``[n, dim]`` array. Returns ``(block, norms, crc)`` or None when the
    native codec is unavailable (caller falls back to numpy)."""
    lib = load()
    if lib is None:
        return None
    n, dim = rows.shape
    esz = rows.dtype.itemsize
    rows = np.ascontiguousarray(rows)
    block = np.empty((padded_rows, padded_dim), dtype=rows.dtype)
    norms = np.empty(padded_rows, dtype=np.float32)
    crc = lib.mvt_pack_block(
        _u8(rows.view(np.uint8).reshape(-1)),
        _u8(block.view(np.uint8).reshape(-1)),
        n, dim, esz, padded_rows, padded_dim, dtype_code,
        ctypes.c_float(scale), ctypes.c_float(zero_point),
        norms.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return block, norms, int(crc)


def prep_f16_to_f32(src: np.ndarray, out_rows: int) -> np.ndarray | None:
    """Streaming chunk prep: exact f16→f32 upcast of a ``[n, dimp]`` chunk
    into a zero-padded ``[out_rows, dimp]`` f32 array in ONE native pass
    (F16C + OpenMP) — the numpy twin costs an astype temp plus an np.pad
    copy. None when the codec is unavailable."""
    lib = load()
    if lib is None:
        return None
    src = np.ascontiguousarray(src)
    n, dimp = src.shape
    out = np.empty((out_rows, dimp), np.float32)
    lib.mvt_prep_f16_to_f32(
        src.view(np.uint16).ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n * dimp, out_rows * dimp,
    )
    return out


def prep_u8_dequant(
    src: np.ndarray, out_rows: int, scale: float, zero_point: float
) -> np.ndarray | None:
    """Streaming chunk prep: dequantize a ``[n, dimp]`` u8 chunk to
    ``(c − zp)·scale`` f32 (numpy-matching f32 arithmetic) into a
    zero-padded ``[out_rows, dimp]`` array in one native pass."""
    lib = load()
    if lib is None:
        return None
    src = np.ascontiguousarray(src, np.uint8)
    n, dimp = src.shape
    out = np.empty((out_rows, dimp), np.float32)
    lib.mvt_prep_u8_dequant(
        _u8(src), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_float(scale), ctypes.c_float(zero_point),
        n * dimp, out_rows * dimp,
    )
    return out


def prep_u8_offset(
    src: np.ndarray, out_rows: int, dim: int, nvalid: int
) -> tuple[np.ndarray, np.ndarray] | None:
    """Streaming chunk prep for the offset-u8 kernel path: recenter a
    ``[n, dimp]`` u8 chunk to int8 ``c − 128`` over the logical ``dim``
    columns and emit the per-row code-sum bias, zeroing rows ≥ ``nvalid``
    and the pad tail, in one native pass. Returns ``(codes, bias)``."""
    lib = load()
    if lib is None:
        return None
    src = np.ascontiguousarray(src, np.uint8)
    n, dimp = src.shape
    codes = np.empty((out_rows, dimp), np.int8)
    bias = np.empty(out_rows, np.float32)
    lib.mvt_prep_u8_offset(
        _u8(src),
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        bias.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n, dimp, dim, nvalid, out_rows,
    )
    return codes, bias


# ----------------------------------------------------------- native HNSW ---

_HNSW_SRC = os.path.join(_HERE, "hnsw.cpp")
_hnsw_lib = None
_hnsw_tried = False


def _build_hnsw() -> str | None:
    # without OpenMP as a fallback (single-threaded batch search)
    return _compile(_HNSW_SRC, "mvthnsw", [["-fopenmp"], []])


def load_hnsw():
    """The loaded native-HNSW library, or None when unavailable/disabled."""
    global _hnsw_lib, _hnsw_tried
    if _hnsw_lib is not None:
        return _hnsw_lib
    if _hnsw_tried or os.environ.get("MVT_NO_NATIVE") == "1":
        return None
    with _lock:
        if _hnsw_lib is not None or _hnsw_tried:
            return _hnsw_lib
        _hnsw_tried = True
        so = _build_hnsw()
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            return None
        f32p = ctypes.POINTER(ctypes.c_float)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.mvt_hnsw_abi_version.restype = ctypes.c_int
        if lib.mvt_hnsw_abi_version() != 3:
            return None
        lib.mvt_hnsw_build.restype = ctypes.c_void_p
        lib.mvt_hnsw_build.argtypes = [
            f32p, ctypes.c_int64, ctypes.c_int32, f32p, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_uint64, i64p,
            ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ]
        lib.mvt_hnsw_new.restype = ctypes.c_void_p
        lib.mvt_hnsw_new.argtypes = [
            f32p, ctypes.c_int64, ctypes.c_int32, f32p, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32,
        ]
        lib.mvt_hnsw_add_layer.restype = None
        lib.mvt_hnsw_add_layer.argtypes = [
            ctypes.c_void_p, i32p, ctypes.c_int64, i32p, ctypes.c_int32,
        ]
        lib.mvt_hnsw_set_entry.restype = None
        lib.mvt_hnsw_set_entry.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.mvt_hnsw_n_layers.restype = ctypes.c_int32
        lib.mvt_hnsw_n_layers.argtypes = [ctypes.c_void_p]
        lib.mvt_hnsw_layer_size.restype = ctypes.c_int64
        lib.mvt_hnsw_layer_size.argtypes = [ctypes.c_void_p, ctypes.c_int32]
        lib.mvt_hnsw_layer_width.restype = ctypes.c_int32
        lib.mvt_hnsw_layer_width.argtypes = [ctypes.c_void_p, ctypes.c_int32]
        lib.mvt_hnsw_entry.restype = ctypes.c_int64
        lib.mvt_hnsw_entry.argtypes = [ctypes.c_void_p]
        lib.mvt_hnsw_export_layer.restype = None
        lib.mvt_hnsw_export_layer.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, i32p, i32p,
        ]
        lib.mvt_hnsw_search.restype = None
        lib.mvt_hnsw_search.argtypes = [
            ctypes.c_void_p, f32p, ctypes.c_int64, ctypes.c_int32, i32p,
            f32p,
        ]
        lib.mvt_hnsw_free.restype = None
        lib.mvt_hnsw_free.argtypes = [ctypes.c_void_p]
        _hnsw_lib = lib
        return _hnsw_lib


def hnsw_available() -> bool:
    return load_hnsw() is not None


def _f32p(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _i32p(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


class NativeHNSW:
    """Owned handle over the C++ HNSW graph. BORROWS the row/norm arrays
    (held via ``_keep`` for lifetime); freed on GC."""

    def __init__(self, lib, handle, keep):
        self._lib = lib
        self._handle = handle
        self._keep = keep

    def __del__(self):
        lib, h = getattr(self, "_lib", None), getattr(self, "_handle", None)
        if lib is not None and h:
            lib.mvt_hnsw_free(h)
            self._handle = None

    @classmethod
    def build(cls, rows, norms, use_norms, m, ef_construction, seed, live,
              threads: int = 0, heuristic: bool = True):
        """Build by incremental insertion over the ``live`` row ids.
        ``threads``: parallel insertion workers (hnswlib-style per-node
        locking; 0 = the OpenMP default, 1 = deterministic sequential).
        ``heuristic``: diversifying neighbor selection (False = plain
        closest-M). Returns None when the native library is unavailable."""
        lib = load_hnsw()
        if lib is None:
            return None
        rows = np.ascontiguousarray(rows, np.float32)
        norms = np.ascontiguousarray(norms, np.float32)
        live = np.ascontiguousarray(live, np.int64)
        h = lib.mvt_hnsw_build(
            _f32p(rows), rows.shape[0], rows.shape[1], _f32p(norms),
            int(use_norms), int(m), int(ef_construction),
            ctypes.c_uint64(int(seed) & (2**64 - 1)),
            live.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            live.shape[0], int(threads), int(bool(heuristic)),
        )
        if not h:
            return None
        return cls(lib, h, (rows, norms))

    @classmethod
    def adopt(cls, rows, norms, use_norms, m, ef_construction, layers,
              entry):
        """Wrap an existing frozen graph (persisted or Python-built)
        without copying the row data."""
        lib = load_hnsw()
        if lib is None:
            return None
        rows = np.ascontiguousarray(rows, np.float32)
        norms = np.ascontiguousarray(norms, np.float32)
        h = lib.mvt_hnsw_new(
            _f32p(rows), rows.shape[0], rows.shape[1], _f32p(norms),
            int(use_norms), int(m), int(ef_construction),
        )
        keep = [rows, norms]
        for ids, adj in layers:
            ids = np.ascontiguousarray(ids, np.int32)
            adj = np.ascontiguousarray(adj, np.int32)
            lib.mvt_hnsw_add_layer(
                h, _i32p(ids), ids.shape[0], _i32p(adj), adj.shape[1]
            )
            keep.extend((ids, adj))
        lib.mvt_hnsw_set_entry(h, int(entry))
        return cls(lib, h, tuple(keep))

    @property
    def entry(self) -> int:
        return int(self._lib.mvt_hnsw_entry(self._handle))

    def export_layers(self):
        """Frozen (ids, adj) per layer, bottom-up — the Python layout."""
        out = []
        for layer in range(int(self._lib.mvt_hnsw_n_layers(self._handle))):
            n = int(self._lib.mvt_hnsw_layer_size(self._handle, layer))
            w = int(self._lib.mvt_hnsw_layer_width(self._handle, layer))
            ids = np.empty(n, np.int32)
            adj = np.empty((n, w), np.int32)
            self._lib.mvt_hnsw_export_layer(
                self._handle, layer, _i32p(ids), _i32p(adj)
            )
            out.append((ids, adj))
        return out

    def search(self, queries, ef: int):
        """Batched beam search: ``(ids [nq, ef] i32, scores [nq, ef] f32)``
        best-first, −1/−inf padded. Thread-parallel over queries."""
        q = np.ascontiguousarray(queries, np.float32)
        nq = q.shape[0]
        ids = np.empty((nq, ef), np.int32)
        scores = np.empty((nq, ef), np.float32)
        self._lib.mvt_hnsw_search(
            self._handle, _f32p(q), nq, int(ef), _i32p(ids), _f32p(scores)
        )
        return ids, scores
