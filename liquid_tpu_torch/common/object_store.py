"""Object-store abstraction, instrumented mock store, and byte cache
(host copy of `liquid_tpu/common/object_store.py`).

Reference behavior:
- `MockStore` (liquid-cache `src/common/src/mock_store.rs:56-225`): an
  in-memory object store recording per-object access counts and byte
  ranges, with `fork()` for test isolation.
- `ByteCache` (`src/core/src/utils/byte_cache.rs:20-70`): a caching
  wrapper that serves remote object bytes from a local disk cache of
  4 MB blocks, transparently and read-through.
- URL sanitization (`src/common/src/utils.rs:4-17`).
"""
from __future__ import annotations

import abc
import io
import os
import threading
from typing import Dict, List, Optional, Tuple

#: ByteCache block size (ref byte_cache.rs: 4MB blocks)
BLOCK_SIZE = 4 * 1024 * 1024


def sanitize_url(url: str) -> str:
    """object-store URL -> directory-name-safe string (ref utils.rs:4-17)."""
    out = []
    for ch in url:
        out.append(ch if ch.isalnum() or ch in "._-" else "_")
    return "".join(out)


class ObjectStore(abc.ABC):
    @abc.abstractmethod
    def size(self, path: str) -> int: ...

    @abc.abstractmethod
    def get_range(self, path: str, start: int, length: int) -> bytes: ...

    def get(self, path: str) -> bytes:
        return self.get_range(path, 0, self.size(path))

    def list(self) -> List[str]:
        raise NotImplementedError


class LocalStore(ObjectStore):
    """Local filesystem store rooted at a directory."""

    def __init__(self, root: str = "/"):
        self.root = root

    def _p(self, path: str) -> str:
        return os.path.join(self.root, path.lstrip("/"))

    def size(self, path: str) -> int:
        return os.path.getsize(self._p(path))

    def get_range(self, path: str, start: int, length: int) -> bytes:
        with open(self._p(path), "rb") as f:
            f.seek(start)
            return f.read(length)


class MockStore(ObjectStore):
    """In-memory store with access instrumentation (ref mock_store.rs):
    `get_access_count(path)`, `get_access_ranges(path)`, `fork()`."""

    def __init__(self, objects: Optional[Dict[str, bytes]] = None):
        self._objects: Dict[str, bytes] = dict(objects or {})
        self._counts: Dict[str, int] = {}
        self._ranges: Dict[str, List[Tuple[int, int]]] = {}
        self._lock = threading.Lock()

    def put(self, path: str, data: bytes) -> None:
        with self._lock:
            self._objects[path] = data

    def size(self, path: str) -> int:
        return len(self._objects[path])

    def get_range(self, path: str, start: int, length: int) -> bytes:
        with self._lock:
            self._counts[path] = self._counts.get(path, 0) + 1
            self._ranges.setdefault(path, []).append((start, start + length))
        return self._objects[path][start:start + length]

    def list(self) -> List[str]:
        return sorted(self._objects)

    def get_access_count(self, path: str) -> int:
        return self._counts.get(path, 0)

    def get_access_ranges(self, path: str) -> List[Tuple[int, int]]:
        return list(self._ranges.get(path, []))

    def fork(self) -> "MockStore":
        """Same objects, fresh instrumentation (ref mock_store.rs:193)."""
        return MockStore(self._objects)


class ByteCache(ObjectStore):
    """Read-through 4MB-block disk cache over a remote store
    (ref byte_cache.rs:20-70): every upstream read is block-aligned;
    blocks are written once to the cache dir and served locally after."""

    def __init__(self, inner: ObjectStore, cache_dir: str,
                 block_size: int = BLOCK_SIZE):
        self.inner = inner
        self.cache_dir = cache_dir
        self.block_size = block_size
        self._sizes: Dict[str, int] = {}
        self._lock = threading.Lock()
        os.makedirs(cache_dir, exist_ok=True)

    def size(self, path: str) -> int:
        with self._lock:
            if path not in self._sizes:
                self._sizes[path] = self.inner.size(path)
            return self._sizes[path]

    def _block_path(self, path: str, block: int) -> str:
        return os.path.join(self.cache_dir,
                            f"{sanitize_url(path)}.{block}.blk")

    def _load_block(self, path: str, block: int, total: int) -> bytes:
        bp = self._block_path(path, block)
        try:
            with open(bp, "rb") as f:
                return f.read()
        except FileNotFoundError:
            pass
        start = block * self.block_size
        length = min(self.block_size, total - start)
        data = self.inner.get_range(path, start, length)
        # concurrent-safe: write to a temp file, atomic rename
        tmp = bp + f".tmp{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, bp)
        return data

    def get_range(self, path: str, start: int, length: int) -> bytes:
        total = self.size(path)
        end = min(start + length, total)
        out = io.BytesIO()
        block = start // self.block_size
        while block * self.block_size < end:
            data = self._load_block(path, block, total)
            bs = block * self.block_size
            lo = max(start, bs) - bs
            hi = min(end, bs + len(data)) - bs
            out.write(data[lo:hi])
            block += 1
        return out.getvalue()

    def cached_blocks(self, path: str) -> int:
        pre = sanitize_url(path) + "."
        return sum(1 for f in os.listdir(self.cache_dir)
                   if f.startswith(pre) and f.endswith(".blk"))

    def disk_usage(self) -> int:
        return sum(os.path.getsize(os.path.join(self.cache_dir, f))
                   for f in os.listdir(self.cache_dir)
                   if f.endswith(".blk"))


class StoreFile(io.RawIOBase):
    """File-like adapter over an ObjectStore object, so pyarrow's parquet
    reader can scan remote objects through the ByteCache."""

    def __init__(self, store: ObjectStore, path: str):
        self.store = store
        self.path = path
        self._size = store.size(path)
        self._pos = 0

    def readable(self) -> bool:
        return True

    def seekable(self) -> bool:
        return True

    def seek(self, pos: int, whence: int = 0) -> int:
        if whence == 0:
            self._pos = pos
        elif whence == 1:
            self._pos += pos
        else:
            self._pos = self._size + pos
        return self._pos

    def tell(self) -> int:
        return self._pos

    def read(self, n: int = -1) -> bytes:
        if n is None or n < 0:
            n = self._size - self._pos
        n = min(n, self._size - self._pos)
        if n <= 0:
            return b""
        data = self.store.get_range(self.path, self._pos, n)
        self._pos += len(data)
        return data

    def size(self) -> int:
        return self._size
