"""ctypes bindings for the native FSST string codec (port of
`liquid_tpu/_native/__init__.py`).

The port builds its OWN shared library from the repository's
`native/*.cpp` with g++ on first use, into `liquid_tpu_torch/_build/`
(keyed by a hash of the sources and flags, as `ops/nvcc.py` keys the CUDA
kernels).  It never writes into, or loads from, the JAX package's
directory.  Concurrent builders (test workers) each compile to a private
temp file and `os.replace` it into place, so a reader never sees a
half-written library.  The ABI is plain C: the FSST codec's entry points
(`lqt_fsst_*`) and the disk block store's (`lqt_store_*`,
`cache/store.py`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
_PKG = os.path.dirname(_HERE)
SRC_DIR = os.path.join(os.path.dirname(_PKG), "native")
BUILD_DIR = os.path.join(_PKG, "_build")
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17",
             "-Wall")

_LOCK = threading.Lock()
_lib = None

_u8p = ctypes.POINTER(ctypes.c_uint8)
_u64p = ctypes.POINTER(ctypes.c_uint64)


def sources():
    return sorted(os.path.join(SRC_DIR, f) for f in os.listdir(SRC_DIR)
                  if f.endswith(".cpp"))


def library_path() -> str:
    """Where the library built from the current sources lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for s in sources():
        with open(s, "rb") as f:
            h.update(os.path.basename(s).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"liquidnative_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the sources if this version has not been built yet ->
    library path.  Raises with g++'s output if the build fails."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    res = subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, *sources()],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, out)  # atomic: concurrent builders race safely
    return out


def lib() -> ctypes.CDLL:
    """The loaded native library, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    with _LOCK:
        if _lib is None:
            handle = ctypes.CDLL(build())
            _declare(handle)
            _lib = handle
    return _lib


def _declare(h: ctypes.CDLL) -> None:
    u64, vp = ctypes.c_uint64, ctypes.c_void_p
    h.lqt_fsst_train.restype = vp
    h.lqt_fsst_train.argtypes = [_u8p, _u64p, u64]
    h.lqt_fsst_free.restype = None
    h.lqt_fsst_free.argtypes = [vp]
    h.lqt_fsst_compress.restype = u64
    h.lqt_fsst_compress.argtypes = [vp, _u8p, u64, _u8p, u64]
    h.lqt_fsst_decompress.restype = u64
    h.lqt_fsst_decompress.argtypes = [vp, _u8p, u64, _u8p, u64]
    h.lqt_fsst_decompressed_len.restype = u64
    h.lqt_fsst_decompressed_len.argtypes = [vp, _u8p, u64]
    h.lqt_fsst_table_serialize.restype = u64
    h.lqt_fsst_table_serialize.argtypes = [vp, _u8p, u64]
    h.lqt_fsst_table_deserialize.restype = vp
    h.lqt_fsst_table_deserialize.argtypes = [_u8p, u64]
    h.lqt_fsst_num_symbols.restype = ctypes.c_int
    h.lqt_fsst_num_symbols.argtypes = [vp]
    h.lqt_fsst_compress_batch.restype = u64
    h.lqt_fsst_compress_batch.argtypes = [vp, _u8p, _u64p, u64, _u8p, u64,
                                          _u64p]
    h.lqt_fsst_decompress_batch.restype = u64
    h.lqt_fsst_decompress_batch.argtypes = [vp, _u8p, _u64p, u64, _u8p, u64,
                                            _u64p]
    # the block store
    h.lqt_store_open.restype = vp
    h.lqt_store_open.argtypes = [ctypes.c_char_p]
    h.lqt_store_close.restype = None
    h.lqt_store_close.argtypes = [vp]
    h.lqt_store_put.restype = ctypes.c_int
    h.lqt_store_put.argtypes = [vp, u64, _u8p, u64, _u64p]
    h.lqt_store_get_len.restype = ctypes.c_int64
    h.lqt_store_get_len.argtypes = [vp, u64]
    h.lqt_store_get.restype = ctypes.c_int
    h.lqt_store_get.argtypes = [vp, u64, _u8p, u64]
    h.lqt_store_read_range.restype = ctypes.c_int
    h.lqt_store_read_range.argtypes = [vp, u64, u64, _u8p]
    h.lqt_store_remove.restype = u64
    h.lqt_store_remove.argtypes = [vp, u64]
    h.lqt_store_contains.restype = ctypes.c_int
    h.lqt_store_contains.argtypes = [vp, u64]
    h.lqt_store_range_of.restype = ctypes.c_int
    h.lqt_store_range_of.argtypes = [vp, u64, _u64p, _u64p]
    h.lqt_store_file_bytes.restype = u64
    h.lqt_store_file_bytes.argtypes = [vp]
    h.lqt_store_live_bytes.restype = u64
    h.lqt_store_live_bytes.argtypes = [vp]
    h.lqt_store_compact.restype = ctypes.c_int
    h.lqt_store_compact.argtypes = [vp]


def buf_ptr(b) -> "ctypes._Pointer":
    """Pointer to a bytes / bytearray buffer (no copy)."""
    if isinstance(b, bytes):
        return ctypes.cast(b, _u8p)
    return (ctypes.c_uint8 * len(b)).from_buffer(b)


def np_ptr(a, ptype=_u8p):
    """Pointer to a contiguous numpy array's data."""
    return a.ctypes.data_as(ptype)
