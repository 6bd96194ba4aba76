"""Build the port's block objects from host fields.

`from_numpy_fields(kind, fields)` takes the encoded fields of a block
as plain numpy values -- the reference's `planes_np`, `reference_value`,
`validity_np`, and for floats the ALP exponent and patches, for linear
blocks the slope -- and returns the port's block with exactly those
fields.  Tests use it to feed identical encoded blocks through both
packages.

fields (all kinds): planes uint32[bucket, 256], width, reference_value,
validity uint32[256] | None, length, arrow_type.
"float" adds exponent, patch_idx, patch_vals; "linear" adds slope (the
other fields describe its residual block, typed int64).

"byteview" (a string block) takes codes int32[8192], validity, length and
arrow_type, optional fingerprints uint32[dict], and either `dictionary`
(the raw pyarrow dictionary) or the FSST backing: `fsst_table` (the
symbol table's bytes), comp_data uint8[], comp_offsets uint64[dict+1],
uncompressed_bytes, and the prefix meta as prefix_shared (bytes),
prefixes uint64[dict] and rest_lens int32[dict].
"""
from __future__ import annotations

import numpy as np
import pyarrow as pa

from liquid_tpu_torch.arrays import prefixkeys as pk
from liquid_tpu_torch.arrays.byteview import LiquidByteViewArray
from liquid_tpu_torch.arrays.float_alp import LiquidFloatArray
from liquid_tpu_torch.arrays.fsst import FsstBuffer, FsstCompressor
from liquid_tpu_torch.arrays.linear import LiquidLinearArray
from liquid_tpu_torch.arrays.primitive import LiquidPrimitiveArray


def _validity(fields):
    v = fields.get("validity")
    return None if v is None else np.asarray(v, np.uint32)


def _byteview(fields):
    fps = fields.get("fingerprints")
    args = (np.asarray(fields["codes"], np.int32), fields.get("dictionary"),
            _validity(fields), int(fields["length"]), fields["arrow_type"],
            None if fps is None else np.asarray(fps, np.uint32))
    if args[1] is not None:
        return LiquidByteViewArray(*args)
    buf = FsstBuffer(np.asarray(fields["comp_data"], np.uint8),
                     np.asarray(fields["comp_offsets"], np.uint64),
                     FsstCompressor.from_bytes(bytes(fields["fsst_table"])),
                     int(fields["uncompressed_bytes"]))
    meta = pk.PrefixMeta(bytes(fields["prefix_shared"]),
                         np.asarray(fields["prefixes"], np.uint64),
                         np.asarray(fields["rest_lens"], np.int32))
    return LiquidByteViewArray(*args, fsst=buf, prefix_meta=meta)


def from_numpy_fields(kind: str, fields: dict):
    if kind == "byteview":
        return _byteview(fields)
    planes = np.asarray(fields["planes"], np.uint32)
    if kind == "primitive":
        return LiquidPrimitiveArray(
            planes, int(fields["width"]), int(fields["reference_value"]),
            _validity(fields), int(fields["length"]), fields["arrow_type"])
    if kind == "float":
        return LiquidFloatArray(
            planes, int(fields["width"]), int(fields["reference_value"]),
            int(fields["exponent"]), fields["patch_idx"],
            fields["patch_vals"], _validity(fields), int(fields["length"]),
            fields["arrow_type"])
    if kind == "linear":
        resid = LiquidPrimitiveArray(
            planes, int(fields["width"]), int(fields["reference_value"]),
            _validity(fields), int(fields["length"]), pa.int64())
        return LiquidLinearArray(resid, float(fields["slope"]),
                                 int(fields["length"]), fields["arrow_type"])
    raise ValueError(f"unknown block kind {kind!r}")
