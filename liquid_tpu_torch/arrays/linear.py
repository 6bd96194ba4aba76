"""Linear-model and delta integer blocks (port of `liquid_tpu/arrays/
linear.py`).

- `LiquidLinearArray`: value[i] = round(slope * i) + residual[i];
  residuals are a bit-packed primitive block (the intercept folds into
  its reference_value).  The linear term is computed on the HOST with
  numpy's rounding, exactly as the encoder and the reference compute it
  (an f64 multiply-and-round on a device can land one off at some i).
- `LiquidPrimitiveDeltaArray`: value[i] = first + d[1] + ... + d[i]; the
  deltas are a bit-packed primitive block, decoded on the device by a
  cumulative sum.  No transcode picks it (as in the reference); Liquid
  IPC reads and writes it.
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
from liquid_tpu_torch.device import words_to_tensor
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
        return mops.BoolMask(mops.pack_bools(_CMP[op](vals, lit)), valid)

    def to_bytes(self) -> bytes:
        from liquid_tpu_torch.arrays import ipc
        return ipc.serialize_linear(self)


class LiquidPrimitiveDeltaArray(LiquidArray):
    """Delta-encoded, bit-packed integers: deltas[0] = 0 (the first value
    is `first_value`); decode is a cumulative sum of the unpacked
    deltas."""

    def __init__(self, deltas: LiquidPrimitiveArray, first_value: int,
                 validity: Optional[np.ndarray], length: int,
                 arrow_type: pa.DataType):
        # the deltas are packed fully valid: zeroing a null slot's delta
        # would shift every later row, so row validity lives here
        self.deltas = deltas           # int64-typed primitive block of d[i]
        self.first_value = int(first_value)
        self.validity_np = validity    # uint32[256] | None
        self.length = length
        self._arrow_type = arrow_type

    @classmethod
    def from_arrow(cls, arr: pa.Array) -> "LiquidPrimitiveDeltaArray":
        from liquid_tpu_torch.arrays.base import pack_validity
        assert len(arr) <= BLOCK_ROWS
        np_dtype_for(arr.type)  # rejects types without a numpy image
        if arr.null_count:
            valid = np.asarray(arr.is_valid())
            vals = np.asarray(arr.fill_null(0)).astype(np.int64, copy=False)
        else:
            valid = None
            vals = np.asarray(arr).astype(np.int64, copy=False)
        length = len(arr)
        v = vals[:length]
        d = np.zeros(length, dtype=np.int64)
        if length > 1:
            d[1:] = v[1:] - v[:-1]
        deltas = LiquidPrimitiveArray.from_numpy(d, None, pa.int64(), length)
        return cls(deltas, int(v[0]) if length else 0,
                   pack_validity(valid, length), length, arr.type)

    @property
    def arrow_type(self) -> pa.DataType:
        return self._arrow_type

    def memory_bytes(self) -> int:
        return self.deltas.memory_bytes() + 16

    def to_device(self, device):
        d, _ = self.deltas.to_device(device)
        # padding rows decode to the reference value: zero them so the
        # sum reconstructs the live rows (a null row keeps its fill's
        # delta and the validity hides it)
        rows = torch.arange(BLOCK_ROWS, device=device)
        d = torch.where(rows < self.length, d, torch.zeros_like(d))
        valid = (None if self.validity_np is None
                 else words_to_tensor(self.validity_np, device))
        return torch.cumsum(d, 0) + self.first_value, valid

    def to_arrow(self) -> pa.Array:
        d0 = self.deltas
        d = d0.offsets_host().astype(np.int64) + d0.reference_value
        d[self.length:] = 0
        d[0] = 0
        return arrow_with_validity(np.cumsum(d) + self.first_value,
                                   self._arrow_type, self.validity_np,
                                   self.length)

    def try_eval_predicate(self, pred: Predicate, device):
        """Packed row mask of `pred` on `device`: the block decoded on the
        device and compared.  None for other predicates."""
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
        return mops.BoolMask(mops.pack_bools(_CMP[op](vals, lit)), valid)

    def to_bytes(self) -> bytes:
        from liquid_tpu_torch.arrays import ipc
        return ipc.serialize_delta(self)


_CMP = {"eq": torch.eq, "ne": torch.ne, "lt": torch.lt, "lt_eq": torch.le,
        "gt": torch.gt, "gt_eq": torch.ge}


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
