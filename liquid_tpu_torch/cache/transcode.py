"""Arrow -> Liquid transcoding dispatch (port of
`liquid_tpu/cache/transcode.py`).

Integers, dates, timestamps and bools become bit-plane blocks (linear
when a line fits the block much better); floats become ALP blocks;
strings and binaries become dictionary blocks (FSST-backed when the
dictionary is large), with substring fingerprints when the column is
read through LIKE '%x%' (a SubstringSearch hint) and the column's shared
FSST compressor passed in.  A decimal whose unscaled values fit i64
becomes bit-planes of them (`LiquidDecimalArray`), a wider one a
dictionary of FSST-compressed fixed-width bytes
(`LiquidFixedLenByteArray`).  Other types return None and stay in arrow
form.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import pyarrow as pa

from liquid_tpu_torch.arrays import (
    byteview, decimal as dec, float_alp, linear, primitive,
)
from liquid_tpu_torch.arrays.base import LiquidArray
from liquid_tpu_torch.cache.expressions import SubstringSearch
from liquid_tpu_torch.ops import bitpack as bp


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


def transcode(arr: pa.Array, hint=None,
              compressor=None) -> Optional[LiquidArray]:
    """-> LiquidArray, or None when the type has no liquid encoding
    (the caller keeps the arrow form).  `compressor` is the column's
    shared FSST compressor; with None a string block trains its own."""
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
    if dec.is_supported_type(t):
        if dec.LiquidDecimalArray.fits(arr):
            return dec.LiquidDecimalArray.from_arrow(arr)
        return dec.LiquidFixedLenByteArray.from_arrow(arr,
                                                      compressor=compressor)
    if byteview.is_supported_type(t):
        return byteview.LiquidByteViewArray.from_arrow(
            arr, with_fingerprints=isinstance(hint, SubstringSearch),
            compressor=compressor)
    return None
