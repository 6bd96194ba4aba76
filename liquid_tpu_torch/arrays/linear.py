"""Linear-model integer blocks (port of `LiquidLinearArray` in
`liquid_tpu/arrays/linear.py`).

value[i] = round(slope * i) + residual[i]; residuals are a bit-packed
primitive block (the intercept folds into its reference_value).  The
linear term is computed on the HOST with numpy's rounding, exactly as the
encoder and the reference compute it (an f64 multiply-and-round on a
device can land one off at some i).
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import pyarrow as pa
import torch

from liquid_tpu_torch.arrays.base import (
    BLOCK_ROWS, LiquidArray, Predicate, arrow_with_validity, const_words,
    np_dtype_for, validity_mask_or_full,
)
from liquid_tpu_torch.arrays.primitive import LiquidPrimitiveArray
from liquid_tpu_torch.ops import mask as mops


def linear_term(slope: float) -> np.ndarray:
    """int64[BLOCK_ROWS]: round(slope * i), host-exact."""
    return np.round(slope * np.arange(BLOCK_ROWS, dtype=np.float64)
                    ).astype(np.int64)


class LiquidLinearArray(LiquidArray):
    """value[i] = round(slope*i) + residual[i]; residuals bit-packed."""

    def __init__(self, residuals: LiquidPrimitiveArray, slope: float,
                 length: int, arrow_type: pa.DataType):
        self.residuals = residuals   # int64-typed primitive block
        self.slope = float(slope)
        self.length = length
        self._arrow_type = arrow_type

    @classmethod
    def from_arrow(cls, arr: pa.Array) -> "LiquidLinearArray":
        assert len(arr) <= BLOCK_ROWS
        np_dtype_for(arr.type)  # rejects types without a numpy image
        if arr.null_count:
            valid = np.asarray(arr.is_valid())
            vals = np.asarray(arr.fill_null(0)).astype(np.int64, copy=False)
        else:
            valid = None
            vals = np.asarray(arr).astype(np.int64, copy=False)
        length = len(arr)
        live = vals[valid] if valid is not None else vals
        if live.size >= 2:
            # least-squares slope (near the L-inf optimum for the
            # monotonic columns this encoding targets)
            idx = (np.flatnonzero(valid).astype(np.float64)
                   if valid is not None
                   else np.arange(length, dtype=np.float64))
            lf = live.astype(np.float64)
            denom = ((idx - idx.mean()) ** 2).sum()
            slope = (float(((idx - idx.mean()) * (lf - lf.mean())).sum()
                           / denom) if denom > 0 else 0.0)
        else:
            slope = 0.0
        pred = np.round(slope * np.arange(length, dtype=np.float64)
                        ).astype(np.int64)
        residuals = LiquidPrimitiveArray.from_numpy(
            vals[:length] - pred, valid, pa.int64(), length)
        return cls(residuals, slope, length, arr.type)

    @property
    def arrow_type(self) -> pa.DataType:
        return self._arrow_type

    @property
    def validity_np(self) -> Optional[np.ndarray]:
        return self.residuals.validity_np

    def memory_bytes(self) -> int:
        return self.residuals.memory_bytes() + 16

    def to_device(self, device):
        resid, valid = self.residuals.to_device(device)
        lin = torch.from_numpy(linear_term(self.slope)).to(device)
        return resid + lin, valid

    def to_arrow(self) -> pa.Array:
        r = self.residuals
        host = (r.offsets_host().astype(np.int64) + r.reference_value
                + linear_term(self.slope))
        return arrow_with_validity(host, self._arrow_type, self.validity_np,
                                   self.length)

    def try_eval_predicate(self, pred: Predicate, device):
        """Packed row mask of `pred` on `device`: the block decoded on the
        device and compared (linear codes have no packed-domain form).
        None for other predicates."""
        if pred.op not in ("eq", "ne", "lt", "lt_eq", "gt", "gt_eq"):
            return None
        r = _int_literal(pred)
        if r is None:
            return None
        op, lit = r
        valid = validity_mask_or_full(self.validity_np, self.length, device)
        if op == "const":
            return mops.BoolMask(const_words(lit, device), valid)
        vals, _ = self.to_device(device)
        cmp = {"eq": torch.eq, "ne": torch.ne, "lt": torch.lt,
               "lt_eq": torch.le, "gt": torch.gt, "gt_eq": torch.ge}[op]
        return mops.BoolMask(mops.pack_bools(cmp(vals, lit)), valid)


def _int_literal(pred: Predicate):
    """A numeric literal normalized for an integer compare -> (op, int),
    ("const", bool) or None."""
    lit, op = pred.literal, pred.op
    if isinstance(lit, bool) or not isinstance(
            lit, (int, float, np.integer, np.floating)):
        return None
    if isinstance(lit, (float, np.floating)):
        f = float(lit)
        if math.isnan(f):
            return ("const", op == "ne")
        if math.isinf(f):
            pos = f > 0
            return ("const", {"eq": False, "ne": True, "lt": pos,
                              "lt_eq": pos, "gt": not pos,
                              "gt_eq": not pos}[op])
        if f != int(f):
            if op in ("eq", "ne"):
                return ("const", op == "ne")
            if op in ("lt", "lt_eq"):
                return ("lt_eq", math.floor(f))
            return ("gt_eq", math.ceil(f))
        lit = int(f)
    return (op, int(lit))
