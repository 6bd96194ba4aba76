"""Arrow -> Liquid transcoding dispatch (port of
`liquid_tpu/cache/transcode.py`).

Integers, dates, timestamps and bools become bit-plane blocks (linear
when a line fits the block much better); floats become ALP blocks.
Strings and decimals have liquid encodings in the reference (dictionary
+ FSST, decimal planes) that are not ported yet: transcoding one raises
NotImplementedError.  Other types return None and stay in arrow form.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import pyarrow as pa

from liquid_tpu_torch.arrays import float_alp, linear, primitive
from liquid_tpu_torch.arrays.base import LiquidArray
from liquid_tpu_torch.ops import bitpack as bp


def _is_string_like(t: pa.DataType) -> bool:
    if pa.types.is_dictionary(t):
        t = t.value_type
    return (pa.types.is_string(t) or pa.types.is_large_string(t)
            or pa.types.is_binary(t) or pa.types.is_large_binary(t)
            or pa.types.is_string_view(t) or pa.types.is_binary_view(t)
            or pa.types.is_fixed_size_binary(t))


def _try_linear(arr: pa.Array):
    """Pick LiquidLinearArray when a least-squares line leaves residuals
    at least 3 bits narrower than the plain offsets (the reference's
    adaptive rule, same arithmetic)."""
    n = len(arr)
    if n < 1024 or arr.null_count * 4 > n:
        return None
    vals = np.asarray(arr.fill_null(0) if arr.null_count else arr)
    vals = vals.astype(np.int64, copy=False)
    # range in Python ints: int64 columns spanning > 2^63 would wrap
    plain_width = bp.bit_width_for(int(vals.max()) - int(vals.min()))
    if plain_width < 10:
        return None
    idx = np.arange(n, dtype=np.float64)
    vf = vals.astype(np.float64)
    denom = ((idx - idx.mean()) ** 2).sum()
    if denom <= 0:
        return None
    slope = ((idx - idx.mean()) * (vf - vf.mean())).sum() / denom
    resid = vals - np.round(slope * idx).astype(np.int64)
    resid_width = bp.bit_width_for(int(resid.max()) - int(resid.min()))
    if resid_width + 3 > plain_width:
        return None
    return linear.LiquidLinearArray.from_arrow(arr)


def transcode(arr: pa.Array) -> Optional[LiquidArray]:
    """-> LiquidArray, or None when the type has no liquid encoding
    (the caller keeps the arrow form)."""
    t = arr.type
    if pa.types.is_boolean(t):
        # 1-bit primitive; the logical type is preserved
        return primitive.LiquidPrimitiveArray.from_arrow(
            arr.cast(pa.uint8())).with_logical(t)
    if primitive.is_supported_type(t):
        lin = _try_linear(arr)
        if lin is not None:
            return lin
        return primitive.LiquidPrimitiveArray.from_arrow(arr)
    if float_alp.is_supported_type(t):
        return float_alp.LiquidFloatArray.from_arrow(arr)
    if pa.types.is_decimal(t):
        raise NotImplementedError(
            f"transcoding a decimal column ({t}) is not ported yet")
    if _is_string_like(t):
        raise NotImplementedError(
            f"transcoding a string column ({t}) is not ported yet")
    return None
