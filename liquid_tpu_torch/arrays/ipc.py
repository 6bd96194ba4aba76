"""Liquid IPC: self-describing bytes of an encoded block (port of
`liquid_tpu/arrays/ipc.py`).

The format is the reference's, byte for byte, so either package reads the
other's bytes.  Header (16 bytes, little-endian):
  magic "LQTP" | u16 version | u16 physical_id | u16 logical_id | u16 flags
  | u32 meta_len
then a JSON metadata blob (scalar fields) and the raw buffers back to
back.  The squeezed arrays' disk backing and the DiskLiquid entries are
these bytes.

The port serializes primitive, byte-view (raw and FSST dictionaries), ALP
float and linear blocks.  Decimal and fixed-length blocks
(`arrays/decimal.py`) and delta blocks (`LiquidPrimitiveDeltaArray` of
`arrays/linear.py`) are not ported: `deserialize` raises
NotImplementedError for their ids.
"""
from __future__ import annotations

import json
import struct

import numpy as np
import pyarrow as pa

MAGIC = b"LQTP"
VERSION = 1

PHYS_PRIMITIVE = 1
PHYS_BYTEVIEW = 2
PHYS_FLOAT = 3
PHYS_DECIMAL = 4
PHYS_FIXEDLEN = 5
PHYS_LINEAR = 6
PHYS_DELTA = 7

#: the encodings whose readers are not ported, and where they live
_NOT_PORTED = {
    PHYS_DECIMAL: "decimal blocks (LiquidDecimalArray, arrays/decimal.py)",
    PHYS_FIXEDLEN: "fixed-length byte blocks (LiquidFixedLenByteArray, "
                   "arrays/decimal.py)",
    PHYS_DELTA: "delta blocks (LiquidPrimitiveDeltaArray, arrays/linear.py)",
}

_LOGICAL = [
    pa.bool_(),
    pa.int8(), pa.int16(), pa.int32(), pa.int64(),
    pa.uint8(), pa.uint16(), pa.uint32(), pa.uint64(),
    pa.float32(), pa.float64(),
    pa.date32(), pa.date64(),
    pa.timestamp("s"), pa.timestamp("ms"), pa.timestamp("us"),
    pa.timestamp("ns"),
    pa.string(), pa.large_string(), pa.binary(), pa.large_binary(),
    pa.string_view(), pa.binary_view(),
]


def logical_id(t: pa.DataType) -> int:
    for i, c in enumerate(_LOGICAL):
        if t.equals(c):
            return i
    raise ValueError(f"unsupported logical type {t}")


def logical_from_id(i: int) -> pa.DataType:
    return _LOGICAL[i]


def _emit(physical: int, logical: int, meta: dict, buffers: list) -> bytes:
    meta = dict(meta)
    meta["buf_lens"] = [len(b) for b in buffers]
    mb = json.dumps(meta).encode()
    head = struct.pack("<4sHHHHI", MAGIC, VERSION, physical, logical, 0,
                       len(mb))
    return b"".join([head, mb] + buffers)


def _parse(data: bytes):
    magic, version, physical, logical, _flags, meta_len = struct.unpack_from(
        "<4sHHHHI", data, 0)
    if magic != MAGIC:
        raise ValueError(f"bad magic {magic!r}")
    if version != VERSION:
        raise ValueError(f"unsupported IPC version {version}")
    off = 16
    meta = json.loads(data[off:off + meta_len])
    off += meta_len
    buffers = []
    for ln in meta["buf_lens"]:
        buffers.append(data[off:off + ln])
        off += ln
    return physical, logical, meta, buffers


def _np_bytes(arr) -> bytes:
    return np.ascontiguousarray(np.asarray(arr)).tobytes()


def _opt_validity_bytes(validity) -> bytes:
    return b"" if validity is None else _np_bytes(validity)


def _validity_from(buf: bytes):
    if not buf:
        return None
    return np.frombuffer(buf, dtype=np.uint32).copy()


def _planes_from(buf: bytes, meta: dict) -> np.ndarray:
    return np.frombuffer(buf, dtype=np.uint32).copy().reshape(
        meta["rows"], meta["words"])


def arrow_to_bytes(arr: pa.Array) -> bytes:
    """One arrow array as an IPC stream of one column "v"."""
    batch = pa.record_batch([arr], names=["v"])
    sink = pa.BufferOutputStream()
    with pa.ipc.new_stream(sink, batch.schema) as w:
        w.write_batch(batch)
    return sink.getvalue().to_pybytes()


def arrow_from_bytes(buf: bytes) -> pa.Array:
    with pa.ipc.open_stream(pa.BufferReader(buf)) as r:
        t = r.read_all()
    return t.column(0).combine_chunks()


# -- per encoding -------------------------------------------------------------

def serialize_primitive(a) -> bytes:
    planes = a.planes_np
    meta = {"width": a.width, "ref": a.reference_value, "length": a.length,
            "rows": int(planes.shape[0]), "words": int(planes.shape[1])}
    bufs = [_np_bytes(planes), _opt_validity_bytes(a.validity_np)]
    return _emit(PHYS_PRIMITIVE, logical_id(a.arrow_type), meta, bufs)


def serialize_byteview(a) -> bytes:
    fps = a.fingerprints
    meta = {"length": a.length, "has_fp": fps is not None,
            "fsst": a.is_fsst}
    if a.is_fsst:
        pm = a.prefix_meta
        bufs = [_np_bytes(a.codes_np), _opt_validity_bytes(a.validity_np),
                a.fsst.to_bytes(), pm.prefixes.tobytes(),
                pm.rest_lens.tobytes(), pm.shared]
    else:
        bufs = [_np_bytes(a.codes_np), _opt_validity_bytes(a.validity_np),
                arrow_to_bytes(a.dictionary)]
    if fps is not None:
        bufs.append(fps.tobytes())
    return _emit(PHYS_BYTEVIEW, logical_id(a.arrow_type), meta, bufs)


def serialize_float(a) -> bytes:
    planes = a.planes_np
    meta = {"width": a.width, "ref": a.reference_value, "exp": a.exponent,
            "length": a.length,
            "rows": int(planes.shape[0]), "words": int(planes.shape[1])}
    bufs = [_np_bytes(planes), _opt_validity_bytes(a.validity_np),
            _np_bytes(a.patch_idx), _np_bytes(a.patch_vals)]
    return _emit(PHYS_FLOAT, logical_id(a.arrow_type), meta, bufs)


def serialize_linear(a) -> bytes:
    r = a.residuals
    rp = r.planes_np
    meta = {"slope": a.slope, "length": a.length,
            "width": r.width, "ref": r.reference_value,
            "rows": int(rp.shape[0]), "words": int(rp.shape[1])}
    bufs = [_np_bytes(rp), _opt_validity_bytes(r.validity_np)]
    return _emit(PHYS_LINEAR, logical_id(a.arrow_type), meta, bufs)


def deserialize(data: bytes):
    """The encoded block the bytes describe (dispatch on the ids)."""
    physical, logical, meta, bufs = _parse(data)
    if physical in _NOT_PORTED:
        raise NotImplementedError(
            f"Liquid IPC physical id {physical}: {_NOT_PORTED[physical]} "
            f"are not ported yet")
    t = logical_from_id(logical)
    if physical == PHYS_PRIMITIVE:
        from liquid_tpu_torch.arrays.primitive import LiquidPrimitiveArray
        return LiquidPrimitiveArray(_planes_from(bufs[0], meta),
                                    meta["width"], meta["ref"],
                                    _validity_from(bufs[1]), meta["length"],
                                    t)
    if physical == PHYS_BYTEVIEW:
        from liquid_tpu_torch.arrays.byteview import LiquidByteViewArray
        codes = np.frombuffer(bufs[0], dtype=np.int32).copy()
        if meta.get("fsst"):
            from liquid_tpu_torch.arrays.fsst import FsstBuffer
            from liquid_tpu_torch.arrays.prefixkeys import PrefixMeta
            pm = PrefixMeta(bytes(bufs[5]),
                            np.frombuffer(bufs[3], dtype=np.uint64).copy(),
                            np.frombuffer(bufs[4], dtype=np.int32).copy())
            fps = (np.frombuffer(bufs[6], dtype=np.uint32).copy()
                   if meta.get("has_fp") else None)
            return LiquidByteViewArray(codes, None, _validity_from(bufs[1]),
                                       meta["length"], t, fps,
                                       fsst=FsstBuffer.from_bytes(bufs[2]),
                                       prefix_meta=pm)
        fps = (np.frombuffer(bufs[3], dtype=np.uint32).copy()
               if meta.get("has_fp") else None)
        return LiquidByteViewArray(codes, arrow_from_bytes(bufs[2]),
                                   _validity_from(bufs[1]), meta["length"],
                                   t, fps)
    if physical == PHYS_FLOAT:
        from liquid_tpu_torch.arrays.float_alp import LiquidFloatArray
        return LiquidFloatArray(
            _planes_from(bufs[0], meta), meta["width"], meta["ref"],
            meta["exp"], np.frombuffer(bufs[2], dtype=np.int32).copy(),
            np.frombuffer(bufs[3], dtype=np.float64).copy(),
            _validity_from(bufs[1]), meta["length"], t)
    if physical == PHYS_LINEAR:
        from liquid_tpu_torch.arrays.linear import LiquidLinearArray
        from liquid_tpu_torch.arrays.primitive import LiquidPrimitiveArray
        inner = LiquidPrimitiveArray(_planes_from(bufs[0], meta),
                                     meta["width"], meta["ref"],
                                     _validity_from(bufs[1]), meta["length"],
                                     pa.int64())
        return LiquidLinearArray(inner, meta["slope"], meta["length"], t)
    raise ValueError(f"unknown physical id {physical}")
