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
"""
from __future__ import annotations

import numpy as np
import pyarrow as pa

from liquid_tpu_torch.arrays.float_alp import LiquidFloatArray
from liquid_tpu_torch.arrays.linear import LiquidLinearArray
from liquid_tpu_torch.arrays.primitive import LiquidPrimitiveArray


def _validity(fields):
    v = fields.get("validity")
    return None if v is None else np.asarray(v, np.uint32)


def from_numpy_fields(kind: str, fields: dict):
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
