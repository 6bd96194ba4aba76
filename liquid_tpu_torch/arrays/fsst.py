"""FSST-compressed byte buffers (port of `liquid_tpu/arrays/fsst.py`).

A dictionary's values are compressed with a trained FSST symbol table
(one table shared per column); each entry can be decompressed on its own,
which is what makes "decompress only the ambiguous dictionary entries"
cheap.  The codec is the repository's native C++ (`native/fsst.cpp`),
built and bound by `liquid_tpu_torch._native`.  It has no random source,
so the same input gives the same compressed bytes as the JAX package.
Host code only: nothing here touches a device.
"""
from __future__ import annotations

import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np
import pyarrow as pa

from liquid_tpu_torch import _native

_ERR = (1 << 64) - 1  # the codec's failure return


def _check(n: int, what: str) -> int:
    if n == _ERR:
        raise RuntimeError(f"fsst {what} failed (corrupt stream or table)")
    return n


class FsstCompressor:
    """A trained FSST symbol table (shared per column)."""

    def __init__(self, handle: int):
        if not handle:
            raise RuntimeError("fsst: no symbol table")
        self._h = handle
        self._lib = _native.lib()

    def __del__(self):
        lib = getattr(self, "_lib", None)
        if lib is not None:
            lib.lqt_fsst_free(self._h)

    @classmethod
    def train(cls, values: Sequence[bytes]) -> "FsstCompressor":
        data = b"".join(values)
        offsets = np.zeros(len(values) + 1, dtype=np.uint64)
        np.cumsum([len(v) for v in values], out=offsets[1:])
        return cls(_native.lib().lqt_fsst_train(
            _native.buf_ptr(data), _native.np_ptr(offsets, _native._u64p),
            len(values)))

    @classmethod
    def train_on_arrow(cls, arr: pa.Array) -> "FsstCompressor":
        data, offsets = _arrow_bytes(arr)
        return cls._train_np(data, offsets, len(arr))

    @classmethod
    def _train_np(cls, data: np.ndarray, offsets: np.ndarray,
                  n: int) -> "FsstCompressor":
        offs = offsets.astype(np.uint64)
        d = data if data.size else np.zeros(1, np.uint8)
        return cls(_native.lib().lqt_fsst_train(
            _native.np_ptr(d), _native.np_ptr(offs, _native._u64p), n))

    @property
    def num_symbols(self) -> int:
        return self._lib.lqt_fsst_num_symbols(self._h)

    # -- single buffer ----------------------------------------------------

    def compress(self, data: bytes) -> bytes:
        out = bytearray(2 * len(data))
        n = _check(self._lib.lqt_fsst_compress(
            self._h, _native.buf_ptr(data), len(data),
            _native.buf_ptr(out), len(out)), "compress")
        return bytes(out[:n])

    def decompress(self, data: bytes) -> bytes:
        n = _check(self._lib.lqt_fsst_decompressed_len(
            self._h, _native.buf_ptr(data), len(data)), "decompress")
        out = bytearray(n)
        m = self._lib.lqt_fsst_decompress(
            self._h, _native.buf_ptr(data), len(data), _native.buf_ptr(out),
            n)
        if m != n:
            raise RuntimeError(f"fsst decompress wrote {m} of {n} bytes")
        return bytes(out)

    # -- batch: one ctypes crossing per dictionary --------------------------

    def _batch(self, fn, data: np.ndarray, offsets: np.ndarray, cap: int,
               what: str) -> Tuple[np.ndarray, np.ndarray]:
        n = len(offsets) - 1
        out = np.empty(max(cap, 1), dtype=np.uint8)
        out_offs = np.zeros(n + 1, dtype=np.uint64)
        offs = offsets.astype(np.uint64)
        data = np.ascontiguousarray(data, dtype=np.uint8)
        if data.size == 0:
            data = np.zeros(1, dtype=np.uint8)
        w = _check(fn(self._h, _native.np_ptr(data),
                      _native.np_ptr(offs, _native._u64p), n,
                      _native.np_ptr(out), out.size,
                      _native.np_ptr(out_offs, _native._u64p)), what)
        return out[:w], out_offs

    def compress_batch(self, data: np.ndarray, offsets: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray]:
        out, offs = self._batch(self._lib.lqt_fsst_compress_batch, data,
                                offsets, 2 * int(offsets[-1]), "compress")
        return out.copy(), offs

    def decompress_batch(self, data: np.ndarray, offsets: np.ndarray,
                         uncompressed_bytes: int
                         ) -> Tuple[np.ndarray, np.ndarray]:
        return self._batch(self._lib.lqt_fsst_decompress_batch, data,
                           offsets, int(uncompressed_bytes), "decompress")

    # -- the symbol table as bytes -------------------------------------------

    def to_bytes(self) -> bytes:
        need = self._lib.lqt_fsst_table_serialize(self._h, None, 0)
        out = bytearray(need)
        n = self._lib.lqt_fsst_table_serialize(self._h,
                                               _native.buf_ptr(out), need)
        if n != need:
            raise RuntimeError("fsst table serialize size changed")
        return bytes(out)

    @classmethod
    def from_bytes(cls, data: bytes) -> "FsstCompressor":
        return cls(_native.lib().lqt_fsst_table_deserialize(
            _native.buf_ptr(data), len(data)))


def _arrow_bytes(arr: pa.Array) -> Tuple[np.ndarray, np.ndarray]:
    """(data u8[], offsets i64[n+1]) of a string / binary array."""
    b = arr.cast(pa.large_binary())
    offsets = np.frombuffer(b.buffers()[1], dtype=np.int64, count=len(b) + 1,
                            offset=b.offset * 8)
    base = offsets[0]
    data_buf = b.buffers()[2]
    data = (np.frombuffer(data_buf, dtype=np.uint8)
            if data_buf is not None else np.zeros(0, np.uint8))
    return data[base:offsets[-1]].copy(), (offsets - base).copy()


class FsstBuffer:
    """Compressed value buffer with per-entry random access."""

    def __init__(self, comp_data: np.ndarray, comp_offsets: np.ndarray,
                 compressor: FsstCompressor, uncompressed_bytes: int):
        self.comp_data = comp_data          # u8[]
        self.comp_offsets = comp_offsets    # u64[n+1]
        self.compressor = compressor
        self.uncompressed_bytes = uncompressed_bytes

    def __len__(self) -> int:
        return len(self.comp_offsets) - 1

    @classmethod
    def from_arrow(cls, values: pa.Array,
                   compressor: Optional[FsstCompressor] = None
                   ) -> "FsstBuffer":
        data, offsets = _arrow_bytes(values)
        if compressor is None:
            compressor = FsstCompressor._train_np(data, offsets, len(values))
        comp, comp_offs = compressor.compress_batch(data, offsets)
        return cls(comp, comp_offs, compressor, int(offsets[-1]))

    def memory_bytes(self) -> int:
        return int(self.comp_data.nbytes + self.comp_offsets.nbytes + 64)

    def to_numpy(self) -> Tuple[np.ndarray, np.ndarray]:
        """Decompress everything -> (data u8[], offsets u64[n+1])."""
        return self.compressor.decompress_batch(
            self.comp_data, self.comp_offsets, self.uncompressed_bytes)

    def to_arrow(self, arrow_type: pa.DataType = None) -> pa.Array:
        data, offsets = self.to_numpy()
        arr = pa.LargeBinaryArray.from_buffers(
            pa.large_binary(), len(self),
            [None, pa.py_buffer(offsets.astype(np.int64).tobytes()),
             pa.py_buffer(data.tobytes())])
        if arrow_type is not None and not arrow_type.equals(pa.large_binary()):
            arr = arr.cast(arrow_type)
        return arr

    def get(self, i: int) -> bytes:
        lo, hi = int(self.comp_offsets[i]), int(self.comp_offsets[i + 1])
        return self.compressor.decompress(self.comp_data[lo:hi].tobytes())

    def take_bytes(self, indices: np.ndarray) -> List[bytes]:
        """Decompress only the requested entries, in one batch call (a
        symbol expands to at most 8 bytes, which bounds the output)."""
        idx = np.asarray(indices, dtype=np.int64)
        lo = self.comp_offsets[idx].astype(np.int64)
        lens = self.comp_offsets[idx + 1].astype(np.int64) - lo
        offs = np.zeros(len(idx) + 1, dtype=np.int64)
        np.cumsum(lens, out=offs[1:])
        pos = np.repeat(lo - offs[:-1], lens) + np.arange(offs[-1])
        out, out_offs = self.compressor.decompress_batch(
            self.comp_data[pos], offs, 8 * int(offs[-1]))
        return [out[out_offs[i]:out_offs[i + 1]].tobytes()
                for i in range(len(idx))]

    # -- serialization (inside Liquid IPC, `arrays/ipc.py`) -------------------

    def to_bytes(self, include_table: bool = True) -> bytes:
        """Header (entries, uncompressed bytes, table bytes, data bytes as
        u64 LE), the symbol table, the offsets and the data -- the
        reference's layout."""
        table = self.compressor.to_bytes() if include_table else b""
        head = struct.pack("<QQQQ", len(self), self.uncompressed_bytes,
                           len(table), len(self.comp_data))
        return b"".join([head, table,
                         self.comp_offsets.astype(np.uint64).tobytes(),
                         self.comp_data.tobytes()])

    @classmethod
    def from_bytes(cls, data: bytes,
                   compressor: Optional[FsstCompressor] = None
                   ) -> "FsstBuffer":
        n, unc, tlen, dlen = struct.unpack_from("<QQQQ", data, 0)
        off = 32
        if tlen:
            compressor = FsstCompressor.from_bytes(data[off:off + tlen])
        if compressor is None:
            raise ValueError("fsst: no symbol table in the stream or given")
        off += tlen
        comp_offsets = np.frombuffer(data, dtype=np.uint64, count=n + 1,
                                     offset=off).copy()
        off += (n + 1) * 8
        comp_data = np.frombuffer(data, dtype=np.uint8, count=dlen,
                                  offset=off).copy()
        return cls(comp_data, comp_offsets, compressor, unc)
