"""Parquet page-index (ColumnIndex / OffsetIndex) reader (host copy of
`liquid_tpu/io/pageindex.py`).

The scan prunes pages from the parquet page index BEFORE any data IO
(liquid-cache `src/datafusion/src/reader/plantime/opener.rs:314-327`):
the column-index min/max statistics are read straight from the file's
footer region and seed batch-level zones, so even the first scan of a
file skips the batches they disprove.

pyarrow's Python API exposes neither the ColumnIndex nor the
ColumnChunk `column_index_offset` fields, so this parses the thrift
compact protocol directly (as the bloom reader does, `io/bloom.py`):

- the file footer `FileMetaData.row_groups[].columns[].meta_data` is
  walked generically to pull `{column,offset}_index_{offset,length}`;
- `ColumnIndex {1: null_pages, 2: min_values, 3: max_values,
  5: null_counts}` and `OffsetIndex {1: page_locations
  [{1: offset, 2: size, 3: first_row_index}]}` decode per column chunk;
- min/max binaries decode by physical type (plain encoding).
"""
from __future__ import annotations

import struct
import threading
from typing import Dict, List, Optional, Tuple

# thrift compact type ids
_BOOL_T, _BOOL_F, _BYTE, _I16, _I32, _I64 = 1, 2, 3, 4, 5, 6
_DOUBLE, _BINARY, _LIST, _SET, _MAP, _STRUCT = 7, 8, 9, 10, 11, 12


class _Reader:
    """Minimal thrift compact-protocol walker with skip support."""

    def __init__(self, buf: bytes, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def varint(self) -> int:
        out = 0
        shift = 0
        while True:
            b = self.buf[self.pos]
            self.pos += 1
            out |= (b & 0x7F) << shift
            if not b & 0x80:
                return out
            shift += 7

    def zigzag(self) -> int:
        v = self.varint()
        return (v >> 1) ^ -(v & 1)

    def binary(self) -> bytes:
        n = self.varint()
        out = self.buf[self.pos: self.pos + n]
        self.pos += n
        return out

    def fields(self):
        """Yield (field_id, type_id); caller must consume or skip each
        value (type BOOL_T/BOOL_F carry their value in the type)."""
        last = 0
        while True:
            byte = self.buf[self.pos]
            self.pos += 1
            if byte == 0:
                return
            delta = (byte >> 4) & 0x0F
            ftype = byte & 0x0F
            if delta:
                last += delta
            else:
                last = self.zigzag()
            yield last, ftype

    def list_header(self) -> Tuple[int, int]:
        byte = self.buf[self.pos]
        self.pos += 1
        size = (byte >> 4) & 0x0F
        etype = byte & 0x0F
        if size == 15:
            size = self.varint()
        return size, etype

    def skip(self, ftype: int) -> None:
        if ftype in (_BOOL_T, _BOOL_F):
            return
        if ftype == _BYTE:
            self.pos += 1
        elif ftype in (_I16, _I32, _I64):
            self.varint()
        elif ftype == _DOUBLE:
            self.pos += 8
        elif ftype == _BINARY:
            n = self.varint()  # NOT `pos += varint()`: augmented
            self.pos += n      # assignment reads pos before the call
        elif ftype in (_LIST, _SET):
            size, etype = self.list_header()
            for _ in range(size):
                self.skip(etype)
        elif ftype == _MAP:
            byte = self.buf[self.pos]
            self.pos += 1
            size = byte
            if size:  # non-empty map: size varint precedes kv-type byte
                self.pos -= 1
                size = self.varint()
                kv = self.buf[self.pos]
                self.pos += 1
                kt, vt = (kv >> 4) & 0x0F, kv & 0x0F
                for _ in range(size):
                    self.skip(kt)
                    self.skip(vt)
        elif ftype == _STRUCT:
            for _, ft in self.fields():
                self.skip(ft)
        else:
            raise ValueError(f"bad thrift type {ftype}")


class ChunkIndexLoc:
    __slots__ = ("ci_off", "ci_len", "oi_off", "oi_len")

    def __init__(self):
        self.ci_off = self.ci_len = self.oi_off = self.oi_len = None


def parse_footer_index_locs(footer: bytes) -> List[List[ChunkIndexLoc]]:
    """FileMetaData -> per row group, per column: page-index locations.
    Unknown/absent fields stay None."""
    r = _Reader(footer)
    out: List[List[ChunkIndexLoc]] = []
    for fid, ft in r.fields():
        if fid == 4 and ft == _LIST:  # row_groups
            size, _ = r.list_header()
            for _ in range(size):
                cols: List[ChunkIndexLoc] = []
                for fid2, ft2 in r.fields():       # RowGroup
                    if fid2 == 1 and ft2 == _LIST:  # columns
                        csize, _ = r.list_header()
                        for _ in range(csize):
                            loc = ChunkIndexLoc()
                            for fid3, ft3 in r.fields():  # ColumnChunk
                                if fid3 == 4 and ft3 == _I64:    # offset_index_offset
                                    loc.oi_off = r.zigzag()
                                elif fid3 == 5 and ft3 == _I32:  # offset_index_length
                                    loc.oi_len = r.zigzag()
                                elif fid3 == 6 and ft3 == _I64:  # column_index_offset
                                    loc.ci_off = r.zigzag()
                                elif fid3 == 7 and ft3 == _I32:  # column_index_length
                                    loc.ci_len = r.zigzag()
                                else:
                                    r.skip(ft3)
                            cols.append(loc)
                    else:
                        r.skip(ft2)
                out.append(cols)
        else:
            r.skip(ft)
    return out


def parse_column_index(buf: bytes):
    """-> (null_pages [bool], min_values [bytes], max_values [bytes]).
    Bool list elements are one byte each (0x01 true / 0x02 false)."""
    r = _Reader(buf)
    null_pages: List[bool] = []
    mins: List[bytes] = []
    maxs: List[bytes] = []
    for fid, ft in r.fields():
        if fid == 1 and ft == _LIST:
            size, etype = r.list_header()
            if etype in (_BOOL_T, _BOOL_F):
                for _ in range(size):
                    b = r.buf[r.pos]
                    r.pos += 1
                    null_pages.append(b == 1)
            else:
                for _ in range(size):
                    r.skip(etype)
        elif fid == 2 and ft == _LIST:
            size, _ = r.list_header()
            mins = [r.binary() for _ in range(size)]
        elif fid == 3 and ft == _LIST:
            size, _ = r.list_header()
            maxs = [r.binary() for _ in range(size)]
        else:
            r.skip(ft)
    return null_pages, mins, maxs


def parse_offset_index(buf: bytes) -> List[Tuple[int, int, int]]:
    """-> [(offset, compressed_size, first_row_index)] per page."""
    r = _Reader(buf)
    pages: List[Tuple[int, int, int]] = []
    for fid, ft in r.fields():
        if fid == 1 and ft == _LIST:
            size, _ = r.list_header()
            for _ in range(size):
                off = sz = frow = 0
                for fid2, ft2 in r.fields():
                    if fid2 == 1:
                        off = r.zigzag()
                    elif fid2 == 2:
                        sz = r.zigzag()
                    elif fid2 == 3:
                        frow = r.zigzag()
                    else:
                        r.skip(ft2)
                pages.append((off, sz, frow))
        else:
            r.skip(ft)
    return pages


def decode_stat(raw: bytes, physical_type: str):
    """Plain-decode a column-index min/max value.  Returns None for
    types zones don't cover (byte arrays etc.)."""
    try:
        if physical_type == "INT32":
            return struct.unpack("<i", raw)[0]
        if physical_type == "INT64":
            return struct.unpack("<q", raw)[0]
        if physical_type == "FLOAT":
            return struct.unpack("<f", raw)[0]
        if physical_type == "DOUBLE":
            return struct.unpack("<d", raw)[0]
    except struct.error:
        return None
    return None


def read_footer(path: str, open_file=None) -> bytes:
    """The raw thrift FileMetaData bytes (footer minus magic/length)."""
    f = open_file() if open_file else open(path, "rb")
    try:
        f.seek(0, 2)
        size = f.tell()
        f.seek(size - 8)
        tail = f.read(8)
        flen = struct.unpack("<I", tail[:4])[0]
        assert tail[4:] == b"PAR1", "not a parquet file"
        f.seek(size - 8 - flen)
        return f.read(flen)
    finally:
        f.close()


class PageIndexReader:
    """Per-file page-index loader: batch-granularity min/max zones from
    the column index, with NO column data IO (footer-region reads only).
    """

    def __init__(self, path: str, open_file=None):
        self.path = path
        self.open_file = open_file
        self._locs: Optional[List[List[ChunkIndexLoc]]] = None
        self._lock = threading.Lock()

    def _load_locs(self):
        if self._locs is None:
            with self._lock:
                if self._locs is None:
                    self._locs = parse_footer_index_locs(
                        read_footer(self.path, self.open_file))
        return self._locs

    def _read_range(self, off: int, length: int) -> bytes:
        f = self.open_file() if self.open_file else open(self.path, "rb")
        try:
            f.seek(off)
            return f.read(length)
        finally:
            f.close()

    def page_zones(self, rg: int, ci: int, physical_type: str,
                   rg_num_rows: int):
        """-> list of (first_row, end_row, lo, hi) per page, or None when
        the file carries no page index / stats don't decode."""
        locs = self._load_locs()
        try:
            loc = locs[rg][ci]
        except IndexError:
            return None
        if loc.ci_off is None or loc.ci_len is None \
                or loc.oi_off is None or loc.oi_len is None:
            return None
        try:
            nulls, mins, maxs = parse_column_index(
                self._read_range(loc.ci_off, loc.ci_len))
            pages = parse_offset_index(
                self._read_range(loc.oi_off, loc.oi_len))
        except (ValueError, IndexError, AssertionError):
            return None
        if len(pages) != len(mins) or len(mins) != len(maxs):
            return None
        out = []
        for i, (off, sz, frow) in enumerate(pages):
            end = pages[i + 1][2] if i + 1 < len(pages) else rg_num_rows
            if nulls and i < len(nulls) and nulls[i]:
                continue  # all-null page: no min/max; zones stay unknown
            lo = decode_stat(mins[i], physical_type)
            hi = decode_stat(maxs[i], physical_type)
            if lo is None or hi is None:
                return None
            out.append((frow, end, lo, hi))
        return out
