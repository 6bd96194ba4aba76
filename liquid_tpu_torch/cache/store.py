"""On-disk block store (port of `liquid_tpu/cache/store.py`).

An append-only log file with an in-memory {key -> (offset, len)} index.
Range reads serve the squeezed arrays' IO handler; a removed record
leaves a hole that `compact()` reclaims.  The index is not reloaded on
restart.

`BlockStore(path)` is the native store (`native/blockstore.cpp`, pread
range reads outside the GIL), built with the port's native library on
first use; a failed build raises -- the cache never quietly falls back.
`PyBlockStore` is the same contract in Python, a class a caller picks by
name (the tests hold the two against each other).
"""
from __future__ import annotations

import ctypes
import os
from typing import Dict, Optional, Tuple

from liquid_tpu_torch.utils import sync as _sync


class PyBlockStore:
    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._path = path
        self._f = open(path, "a+b")
        self._lock = _sync.Lock()
        self._index: Dict[int, Tuple[int, int]] = {}
        self._tail = self._f.seek(0, os.SEEK_END)
        self._live_bytes = 0

    def put(self, key: int, data: bytes) -> Tuple[int, int]:
        """-> (offset, len) of the written record."""
        with self._lock:
            off = self._tail
            self._f.seek(off)
            self._f.write(data)
            self._f.flush()
            self._tail = off + len(data)
            old = self._index.get(key)
            if old is not None:
                self._live_bytes -= old[1]
            self._index[key] = (off, len(data))
            self._live_bytes += len(data)
            return (off, len(data))

    def get(self, key: int) -> Optional[bytes]:
        with self._lock:
            rng = self._index.get(key)
        if rng is None:
            return None
        return self.read_range(rng)

    def read_range(self, rng: Tuple[int, int]) -> bytes:
        off, ln = rng
        with self._lock:
            self._f.seek(off)
            return self._f.read(ln)

    def remove(self, key: int) -> int:
        """-> bytes freed (logically; the space returns on compact)."""
        with self._lock:
            rng = self._index.pop(key, None)
            if rng is None:
                return 0
            self._live_bytes -= rng[1]
            return rng[1]

    def contains(self, key: int) -> bool:
        with self._lock:
            return key in self._index

    def range_of(self, key: int) -> Optional[Tuple[int, int]]:
        with self._lock:
            return self._index.get(key)

    @property
    def file_bytes(self) -> int:
        with self._lock:
            return self._tail

    @property
    def live_bytes(self) -> int:
        with self._lock:
            return self._live_bytes

    def compact(self) -> None:
        """Rewrite the live records contiguously, dropping holes."""
        with self._lock:
            items = sorted(self._index.items(), key=lambda kv: kv[1][0])
            tmp_path = self._path + ".compact"
            with open(tmp_path, "wb") as out:
                new_index = {}
                pos = 0
                for key, (off, ln) in items:
                    self._f.seek(off)
                    out.write(self._f.read(ln))
                    new_index[key] = (pos, ln)
                    pos += ln
            self._f.close()
            os.replace(tmp_path, self._path)
            self._f = open(self._path, "r+b")
            self._index = new_index
            self._tail = pos

    def close(self) -> None:
        with self._lock:
            self._f.close()


class NativeBlockStore:
    """The C++ store of `native/blockstore.cpp`, bound with ctypes."""

    def __init__(self, path: str):
        from liquid_tpu_torch import _native
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._lib = _native.lib()
        self._h = self._lib.lqt_store_open(path.encode())
        if not self._h:
            raise OSError(f"cannot open block store at {path}")
        self._buf_ptr = _native.buf_ptr

    def put(self, key: int, data: bytes) -> Tuple[int, int]:
        off = ctypes.c_uint64()
        rc = self._lib.lqt_store_put(self._h, key, self._buf_ptr(data),
                                     len(data), ctypes.byref(off))
        if rc != 0:
            raise OSError(f"block store write failed ({rc})")
        return (off.value, len(data))

    def get(self, key: int) -> Optional[bytes]:
        n = self._lib.lqt_store_get_len(self._h, key)
        if n < 0:
            return None
        out = bytearray(n)
        rc = self._lib.lqt_store_get(self._h, key, self._buf_ptr(out), n)
        if rc != 0:
            raise OSError(f"block store read failed ({rc})")
        return bytes(out)

    def read_range(self, rng: Tuple[int, int]) -> bytes:
        off, ln = rng
        out = bytearray(ln)
        rc = self._lib.lqt_store_read_range(self._h, off, ln,
                                            self._buf_ptr(out))
        if rc != 0:
            raise OSError(f"block store range read failed ({rc})")
        return bytes(out)

    def remove(self, key: int) -> int:
        return self._lib.lqt_store_remove(self._h, key)

    def contains(self, key: int) -> bool:
        return bool(self._lib.lqt_store_contains(self._h, key))

    def range_of(self, key: int) -> Optional[Tuple[int, int]]:
        off = ctypes.c_uint64()
        ln = ctypes.c_uint64()
        rc = self._lib.lqt_store_range_of(self._h, key, ctypes.byref(off),
                                          ctypes.byref(ln))
        return None if rc != 0 else (off.value, ln.value)

    @property
    def file_bytes(self) -> int:
        return self._lib.lqt_store_file_bytes(self._h)

    @property
    def live_bytes(self) -> int:
        return self._lib.lqt_store_live_bytes(self._h)

    def compact(self) -> None:
        rc = self._lib.lqt_store_compact(self._h)
        if rc != 0:
            raise OSError(f"block store compact failed ({rc})")

    def close(self) -> None:
        if self._h:
            self._lib.lqt_store_close(self._h)
            self._h = None


def BlockStore(path: str) -> NativeBlockStore:
    """The cache's store: the native one (its library built on first use,
    raising if it cannot be)."""
    return NativeBlockStore(path)
