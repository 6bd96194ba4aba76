"""Parquet bloom-filter row-group pruning (host copy of
`liquid_tpu/io/bloom.py`).

Reference behavior: `RowGroupAccessPlanFilter::prune_by_bloom_filters`
(liquid-cache `src/datafusion/src/reader/plantime/row_group_filter.rs:103`,
via the parquet crate's SBBF reader): for an `=` predicate that survives
min/max pruning, probe the column chunk's split-block bloom filter and
drop the row group when the literal is provably absent.

pyarrow's Python API exposes `bloom_filter_offset`/`bloom_filter_length`
on column-chunk metadata but no reader, so this module implements the
parquet bloom spec directly:

- header: a thrift **compact-protocol** encoded `BloomFilterHeader`
  {1: numBytes i32, 2: algorithm union{BLOCK}, 3: hash union{XXHASH},
  4: compression union{UNCOMPRESSED}} at `bloom_filter_offset`;
- hash: XXH64 with seed 0 over the value's *plain-encoded* bytes
  (byte arrays raw, ints little-endian fixed width);
- filter: split-block bloom (SBBF): 32-byte blocks of 8 u32 words,
  block picked by the top 32 hash bits, one bit per word from the
  8 salt constants.

The probe is O(1) per (row group, literal); bitsets are cached per file.
A filter's location is pyarrow's `bloom_filter_offset` /
`bloom_filter_length` where its metadata has them (pyarrow 25), else
read from the footer's thrift (`ColumnMetaData` fields 14 and 15),
which older pyarrow does not expose.
"""
from __future__ import annotations

import datetime
import struct
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from liquid_tpu_torch.io.pageindex import _I32, _I64, _LIST, _STRUCT, \
    _Reader, read_footer

_SALT = np.array([
    0x47B6137B, 0x44974D91, 0x8824AD5B, 0xA2B7289D,
    0x705495C7, 0x2DF1424B, 0x9EFC4947, 0x5C6BFB31,
], dtype=np.uint64)

_PRIME64_1 = 0x9E3779B185EBCA87
_PRIME64_2 = 0xC2B2AE3D27D4EB4F
_PRIME64_3 = 0x165667B19E3779F9
_PRIME64_4 = 0x85EBCA77C2B2AE63
_PRIME64_5 = 0x27D4EB2F165667C5
_M64 = (1 << 64) - 1


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _round(acc: int, lane: int) -> int:
    acc = (acc + lane * _PRIME64_2) & _M64
    return (_rotl(acc, 31) * _PRIME64_1) & _M64


def _merge_round(acc: int, val: int) -> int:
    acc ^= _round(0, val)
    return ((acc * _PRIME64_1) + _PRIME64_4) & _M64


def xxhash64(data: bytes, seed: int = 0) -> int:
    """Pure-python XXH64 (parquet bloom filters hash with seed 0).
    Only runs on predicate literals -- a handful of bytes per probe."""
    n = len(data)
    pos = 0
    if n >= 32:
        v1 = (seed + _PRIME64_1 + _PRIME64_2) & _M64
        v2 = (seed + _PRIME64_2) & _M64
        v3 = seed & _M64
        v4 = (seed - _PRIME64_1) & _M64
        while pos + 32 <= n:
            lanes = struct.unpack_from("<4Q", data, pos)
            v1 = _round(v1, lanes[0])
            v2 = _round(v2, lanes[1])
            v3 = _round(v3, lanes[2])
            v4 = _round(v4, lanes[3])
            pos += 32
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)) & _M64
        h = _merge_round(h, v1)
        h = _merge_round(h, v2)
        h = _merge_round(h, v3)
        h = _merge_round(h, v4)
    else:
        h = (seed + _PRIME64_5) & _M64
    h = (h + n) & _M64
    while pos + 8 <= n:
        (lane,) = struct.unpack_from("<Q", data, pos)
        h ^= _round(0, lane)
        h = (_rotl(h, 27) * _PRIME64_1 + _PRIME64_4) & _M64
        pos += 8
    if pos + 4 <= n:
        (lane,) = struct.unpack_from("<I", data, pos)
        h ^= (lane * _PRIME64_1) & _M64
        h = (_rotl(h, 23) * _PRIME64_2 + _PRIME64_3) & _M64
        pos += 4
    while pos < n:
        h ^= (data[pos] * _PRIME64_5) & _M64
        h = (_rotl(h, 11) * _PRIME64_1) & _M64
        pos += 1
    h ^= h >> 33
    h = (h * _PRIME64_2) & _M64
    h ^= h >> 29
    h = (h * _PRIME64_3) & _M64
    h ^= h >> 32
    return h


# -- thrift compact protocol (just enough for BloomFilterHeader) ------------

def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    out = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7


def _zigzag(v: int) -> int:
    return (v >> 1) ^ -(v & 1)


def parse_bloom_header(buf: bytes) -> Tuple[int, int]:
    """-> (num_bytes, header_len).  Validates algorithm=BLOCK,
    hash=XXHASH, compression=UNCOMPRESSED (each a thrift union whose
    only variant is an empty struct)."""
    pos = 0
    num_bytes = None
    last_fid = 0
    while True:
        byte = buf[pos]
        pos += 1
        if byte == 0:  # STOP
            break
        delta = (byte >> 4) & 0x0F
        ftype = byte & 0x0F
        if delta:
            fid = last_fid + delta
        else:
            z, pos = _read_varint(buf, pos)
            fid = _zigzag(z)
        last_fid = fid
        if ftype == 5:  # i32
            z, pos = _read_varint(buf, pos)
            val = _zigzag(z)
            if fid == 1:
                num_bytes = val
        elif ftype == 12:  # struct (the unions)
            # union: one field (empty struct) then STOP
            inner_last = 0
            while True:
                b2 = buf[pos]
                pos += 1
                if b2 == 0:
                    break
                d2 = (b2 >> 4) & 0x0F
                t2 = b2 & 0x0F
                if not d2:
                    z, pos = _read_varint(buf, pos)
                    inner_last = _zigzag(z)
                else:
                    inner_last = inner_last + d2
                if t2 == 12:  # empty struct variant
                    assert buf[pos] == 0, "non-empty union variant"
                    pos += 1
                else:
                    raise ValueError(f"unexpected union field type {t2}")
        else:
            raise ValueError(f"unexpected field type {ftype} in bloom header")
    if num_bytes is None or num_bytes <= 0 or num_bytes % 32:
        raise ValueError(f"bad bloom numBytes {num_bytes}")
    return num_bytes, pos


class Sbbf:
    """A loaded split-block bloom filter: `num_blocks` 32-byte blocks."""

    def __init__(self, bitset: bytes):
        self.words = np.frombuffer(bitset, dtype="<u4")
        self.num_blocks = len(bitset) // 32

    def might_contain_hash(self, h: int) -> bool:
        block = ((h >> 32) * self.num_blocks) >> 32
        x = np.uint64(h & 0xFFFFFFFF)
        bits = ((x * _SALT) & np.uint64(0xFFFFFFFF)) >> np.uint64(27)
        masks = (np.uint32(1) << bits.astype(np.uint32))
        words = self.words[block * 8:(block + 1) * 8]
        return bool(np.all((words & masks) != 0))

    def might_contain(self, value) -> bool:
        enc = encode_value(value)
        if enc is None:
            return True
        return self.might_contain_hash(xxhash64(enc))


def encode_value(v) -> Optional[bytes]:
    """Plain-encode a predicate literal the way parquet hashes it.
    Returns None for types we don't probe (-> may contain)."""
    if isinstance(v, bool) or v is None:
        return None
    if isinstance(v, str):
        return v.encode("utf-8")
    if isinstance(v, bytes):
        return v
    if isinstance(v, int):
        # physical type depends on the column; the caller passes the
        # already-width-resolved encoder via encode_int
        return None
    if isinstance(v, float):
        return struct.pack("<d", v)
    return None


def encode_int(v: int, physical_type: str) -> Optional[bytes]:
    if physical_type == "INT32":
        if not (-(1 << 31) <= v < (1 << 31)):
            return b""  # out of range: definitely not present
        return struct.pack("<i", v)
    if physical_type == "INT64":
        if not (-(1 << 63) <= v < (1 << 63)):
            return b""
        return struct.pack("<q", v)
    return None


def parse_footer_bloom_locs(footer: bytes
                            ) -> List[List[Optional[Tuple[int, Optional[int]]]]]:
    """FileMetaData -> per row group, per column: (bloom_filter_offset,
    bloom_filter_length or None), or None without a filter."""
    r = _Reader(footer)
    out: List[List[Optional[Tuple[int, Optional[int]]]]] = []
    for fid, ft in r.fields():
        if fid != 4 or ft != _LIST:  # row_groups
            r.skip(ft)
            continue
        size, _ = r.list_header()
        for _ in range(size):
            cols: List[Optional[Tuple[int, Optional[int]]]] = []
            for fid2, ft2 in r.fields():  # RowGroup
                if fid2 != 1 or ft2 != _LIST:  # columns
                    r.skip(ft2)
                    continue
                csize, _ = r.list_header()
                for _ in range(csize):
                    off = length = None
                    for fid3, ft3 in r.fields():  # ColumnChunk
                        if fid3 != 3 or ft3 != _STRUCT:  # meta_data
                            r.skip(ft3)
                            continue
                        for fid4, ft4 in r.fields():  # ColumnMetaData
                            if fid4 == 14 and ft4 == _I64:
                                off = r.zigzag()
                            elif fid4 == 15 and ft4 == _I32:
                                length = r.zigzag()
                            else:
                                r.skip(ft4)
                    cols.append(None if off is None else (off, length))
            out.append(cols)
    return out


class BloomReader:
    """Per-file bloom-filter loader with a (rg, col) -> Sbbf|None cache.

    `open_file()` must return a fresh binary file-like (same contract as
    ParquetTable's); plain paths open directly."""

    def __init__(self, path: str, metadata, open_file=None):
        self.path = path
        self.metadata = metadata
        self.open_file = open_file
        self._cache: Dict[Tuple[int, int], Optional[Sbbf]] = {}
        self._footer_locs = None  # parse_footer_bloom_locs, when needed
        self._lock = threading.Lock()

    def location(self, rg: int, ci: int) -> Optional[Tuple[int, Optional[int]]]:
        """(offset, length or None) of the (rg, ci) filter, or None."""
        col = self.metadata.row_group(rg).column(ci)
        if hasattr(col, "bloom_filter_offset"):
            off = col.bloom_filter_offset
            return None if off is None else (off, col.bloom_filter_length)
        with self._lock:
            if self._footer_locs is None:
                self._footer_locs = parse_footer_bloom_locs(
                    read_footer(self.path, self.open_file))
        return self._footer_locs[rg][ci]

    def _load(self, rg: int, ci: int) -> Optional[Sbbf]:
        loc = self.location(rg, ci)
        if loc is None:
            return None
        off, length = loc
        f = self.open_file() if self.open_file else open(self.path, "rb")
        try:
            f.seek(off)
            if length:
                raw = f.read(length)
                num_bytes, hlen = parse_bloom_header(raw)
                bitset = raw[hlen:hlen + num_bytes]
            else:
                head = f.read(64)
                num_bytes, hlen = parse_bloom_header(head)
                bitset = head[hlen:hlen + num_bytes]
                if len(bitset) < num_bytes:
                    bitset += f.read(num_bytes - len(bitset))
            if len(bitset) != num_bytes:
                return None
            return Sbbf(bitset)
        except (ValueError, OSError):
            return None
        finally:
            f.close()

    def get(self, rg: int, ci: int) -> Optional[Sbbf]:
        key = (rg, ci)
        with self._lock:
            if key in self._cache:
                return self._cache[key]
        sb = self._load(rg, ci)
        with self._lock:
            self._cache[key] = sb
        return sb

    def might_contain(self, rg: int, ci: int, value,
                      physical_type: str) -> Optional[bool]:
        """None when no bloom filter exists; else the SBBF verdict."""
        sb = self.get(rg, ci)
        if sb is None:
            return None
        if isinstance(value, datetime.date) and not isinstance(
                value, datetime.datetime):
            value = (value - datetime.date(1970, 1, 1)).days
        if isinstance(value, bool) or value is None:
            return None
        if isinstance(value, int):
            enc = encode_int(value, physical_type)
            if enc is None:
                return None
            if enc == b"":
                return False
            return sb.might_contain_hash(xxhash64(enc))
        enc = encode_value(value)
        if enc is None:
            return None
        return sb.might_contain_hash(xxhash64(enc))
