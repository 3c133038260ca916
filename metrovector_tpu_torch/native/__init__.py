"""ctypes loaders for the native MVT codec and the native HNSW graph.

Compiles ``codec.cpp`` (and ``hnsw.cpp``, the JAX package's HNSW library,
ABI version 3) on first use with the system ``g++`` into
``build/metrovector_tpu_torch/native/`` under the repository root (a
git-ignored tree; the source directory stays read-only), then exposes typed
wrappers. Everything here is optional: if the toolchain is missing or
``MVT_NO_NATIVE=1`` is set, callers use the numpy implementations in
:mod:`..format.packing` and :mod:`..index.hnsw` — identical semantics, verified by tests that run
both paths. This is host code with one file format either way, not a device
fallback.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "codec.cpp")
_BUILD = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                      "metrovector_tpu_torch", "native")
_SO = os.path.join(_BUILD, "libmvtcodec.so")

_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> str | None:
    if os.path.exists(_SO) and os.path.getmtime(_SO) >= os.path.getmtime(_SRC):
        return _SO
    # Build under a private name, then rename: a concurrent reader never
    # loads half a library.
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = [
        "g++", "-O3", "-march=native", "-fPIC", "-shared", "-std=c++17",
        "-fopenmp", _SRC, "-o", tmp, "-lz",
    ]
    try:
        os.makedirs(_BUILD, exist_ok=True)
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _SO)
        return _SO
    except (OSError, subprocess.SubprocessError):
        return None


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


def _out(out, shape, dtype):
    """``out`` checked as a C-contiguous array of ``shape`` and ``dtype``
    (a pinned staging buffer's view), or a new one."""
    if out is None:
        return np.empty(shape, dtype)
    if out.shape != shape or out.dtype != dtype or not out.flags.c_contiguous:
        raise ValueError(f"out must be a C-contiguous {shape} {np.dtype(dtype)} array")
    return out


def prep_u8_offset(
    src: np.ndarray, out_rows: int, dim: int, nvalid: int,
    out: tuple[np.ndarray, np.ndarray] | None = None,
) -> tuple[np.ndarray, np.ndarray] | None:
    """Streaming chunk prep for the offset-u8 kernel path: recenter a
    ``[n, dimp]`` u8 chunk to int8 ``c − 128`` over the logical ``dim``
    columns and emit the per-row code-sum bias, zeroing rows ≥ ``nvalid``
    and the pad tail, in one native pass, into ``out = (codes, bias)`` or
    new arrays. Returns ``(codes, bias)``."""
    lib = load()
    if lib is None:
        return None
    src = np.ascontiguousarray(src, np.uint8)
    n, dimp = src.shape
    codes = _out(None if out is None else out[0], (out_rows, dimp), np.int8)
    bias = _out(None if out is None else out[1], (out_rows,), np.float32)
    lib.mvt_prep_u8_offset(
        _u8(src),
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        bias.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n, dimp, dim, nvalid, out_rows,
    )
    return codes, bias


# ----------------------------------------------------------- native HNSW ---

_HNSW_SRC = os.path.join(_HERE, "hnsw.cpp")
_HNSW_SO = os.path.join(_BUILD, "libmvthnsw.so")
_hnsw_lib = None
_hnsw_tried = False


def _build_hnsw() -> str | None:
    """Compile ``hnsw.cpp`` into ``build/`` (private name, then rename, as
    :func:`_build`), with OpenMP or, failing that, without it."""
    if os.path.exists(_HNSW_SO) and os.path.getmtime(
        _HNSW_SO
    ) >= os.path.getmtime(_HNSW_SRC):
        return _HNSW_SO
    tmp = f"{_HNSW_SO}.{os.getpid()}.tmp"
    cmd = [
        "g++", "-O3", "-march=native", "-fPIC", "-shared", "-std=c++17",
        "-fopenmp", _HNSW_SRC, "-o", tmp,
    ]
    try:
        os.makedirs(_BUILD, exist_ok=True)
    except OSError:
        return None
    for attempt in (cmd, [c for c in cmd if c != "-fopenmp"]):
        try:
            subprocess.run(attempt, check=True, capture_output=True, timeout=120)
            os.replace(tmp, _HNSW_SO)
            return _HNSW_SO
        except (OSError, subprocess.SubprocessError):
            continue  # retry without OpenMP (single-threaded batch search)
    return None


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
