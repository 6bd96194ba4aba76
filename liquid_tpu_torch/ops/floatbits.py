"""float64 -> int64 IEEE-754 bit image (port of `liquid_tpu/ops/floatbits.py`).

The reference rebuilds the bit pattern arithmetically because the TPU
cannot bitcast 64-bit values.  Its contract: bit-identical to
`np.float64(x).view(np.int64)` for normals, infinities and zeros; every
NaN collapses to the quiet-NaN pattern 0x7FF8000000000000; every
subnormal maps to a signed zero (the TPU flushes them).  A GPU computes
f64 in full IEEE without flushing, so the port bitcasts with
`Tensor.view` and then canonicalises NaNs and subnormals explicitly.
"""
from __future__ import annotations

import torch

_CANON_NAN = 0x7FF8000000000000
_SIGN = -(1 << 63)              # int64 image of bit 63
_EXP_MASK = 0x7FF0000000000000
_MANT_MASK = (1 << 52) - 1


def f64_bits(x: torch.Tensor) -> torch.Tensor:
    """IEEE-754 bit image of a float64 tensor as int64 (reference
    contract).  Inverse on host: `np.asarray(bits).view(np.float64)`."""
    assert x.dtype == torch.float64, x.dtype
    bits = x.contiguous().view(torch.int64)
    # integer test: a float compare would itself flush under DAZ
    subnormal = ((bits & _EXP_MASK) == 0) & ((bits & _MANT_MASK) != 0)
    bits = torch.where(subnormal, bits & _SIGN, bits)
    return torch.where(torch.isnan(x), torch.full_like(bits, _CANON_NAN),
                       bits)
