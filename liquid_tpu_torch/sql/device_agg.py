"""Group-key code images back to arrow, and the host/device choice for
host-resident work (port of `liquid_tpu/sql/device_agg.py`, `KeyCodec`
and `_prefer_host`).

The reference's classic aggregators in the same module are not ported
yet; the grouped fused path uses `KeyCodec` to decode its packed keys.
"""
from __future__ import annotations

import numpy as np
import pyarrow as pa
import torch


class DeviceUnsupported(Exception):
    """A column type with no code image."""


class KeyCodec:
    """Decode packed int64 group-key code images (and null flags) back to
    an arrow array of the key's type.  The images are the fused path's:
    integers and dates as values, floats as canonical IEEE bits.  String
    keys take the vocabulary decoder, which is not ported yet."""

    def __init__(self, typ: pa.DataType):
        self.type = typ
        t = typ
        if pa.types.is_dictionary(t):
            t = t.value_type
        self._vt = t
        if pa.types.is_integer(t):
            self._kind = "int"
        elif pa.types.is_floating(t):
            self._kind = "float"
        elif pa.types.is_date32(t):
            self._kind = "date32"
        elif pa.types.is_date64(t) or pa.types.is_timestamp(t):
            self._kind = "i64like"
        elif pa.types.is_boolean(t):
            self._kind = "bool"
        else:
            raise DeviceUnsupported(f"group key type {t}")

    def decode(self, codes: np.ndarray, nulls: np.ndarray) -> pa.Array:
        k = self._kind
        mask = nulls if nulls.any() else None
        if k == "int":
            if pa.types.is_uint64(self._vt):
                return pa.array(codes.view(np.uint64), self._vt, mask=mask)
            return pa.array(codes, pa.int64(), mask=mask).cast(
                self._vt, safe=False)
        if k == "float":
            return pa.array(codes.view(np.float64), pa.float64(),
                            mask=mask).cast(self._vt)
        if k == "date32":
            return pa.array(codes.astype(np.int32), pa.int32(),
                            mask=mask).view(pa.date32())
        if k == "i64like":
            return pa.array(codes, pa.int64(), mask=mask).view(self._vt)
        return pa.array(codes != 0, pa.bool_(), mask=mask)  # bool


def _prefer_host(device) -> bool:
    """Host-resident post-aggregate work (a sort over a result table)
    stays on the host when the engine runs on an accelerator: a round
    trip to the card per small table costs more than the work, as the
    reference finds on a TPU.  On the CPU the device path is the host
    anyway, so it stays."""
    return torch.device(device).type != "cpu"
