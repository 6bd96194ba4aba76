"""Bit-packed primitive blocks: ints, dates, timestamps, bools (port of
`liquid_tpu/arrays/primitive.py`).

Values are stored as unsigned offsets from a per-block
`reference_value`, packed into bit-planes at the minimal width.  The
encoding is computed on the host with the reference's exact arithmetic,
so `planes_np`, `reference_value` and `validity_np` equal the
reference's fields.  Predicates are translated into the packed domain on
the host (`packed_plan`); the fused path compares on the device.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import pyarrow as pa

from liquid_tpu_torch.arrays.base import (
    BLOCK_ROWS, LiquidArray, Predicate, arrow_with_validity, const_words,
    np_dtype_for, pack_validity, validity_mask_or_full,
)
from liquid_tpu_torch.device import words_to_tensor, wrap_i64
from liquid_tpu_torch.ops import bitpack as bp
from liquid_tpu_torch.ops import mask as mops


def is_supported_type(t: pa.DataType) -> bool:
    return (pa.types.is_integer(t) or pa.types.is_date(t)
            or pa.types.is_timestamp(t))


class LiquidPrimitiveArray(LiquidArray):
    """One 8192-row block of a primitive column in bit-plane form."""

    def __init__(self, planes: np.ndarray, width: int, reference_value: int,
                 validity: Optional[np.ndarray], length: int,
                 arrow_type: pa.DataType):
        self.planes_np = planes               # uint32[bucket, 256]
        self.width = width
        self.reference_value = reference_value
        self.validity_np = validity           # uint32[256] | None
        self.length = length
        self._arrow_type = arrow_type

    @classmethod
    def from_arrow(cls, arr: pa.Array) -> "LiquidPrimitiveArray":
        assert len(arr) <= BLOCK_ROWS, len(arr)
        t = arr.type
        assert is_supported_type(t), t
        np_dtype = np_dtype_for(t)
        if arr.null_count:
            valid = np.asarray(arr.is_valid())
            vals = np.asarray(arr.fill_null(0)).astype(np_dtype, copy=False)
        else:
            valid = None
            vals = np.asarray(arr).astype(np_dtype, copy=False)
        return cls.from_numpy(vals, valid, t, len(arr))

    @classmethod
    def from_numpy(cls, vals: np.ndarray, valid: Optional[np.ndarray],
                   arrow_type: pa.DataType, length: int
                   ) -> "LiquidPrimitiveArray":
        assert length <= BLOCK_ROWS
        v = np.zeros(BLOCK_ROWS, dtype=np.int64)
        v[:length] = vals[:length].astype(np.int64, copy=False)
        live = v[:length][valid[:length]] if valid is not None else v[:length]
        if live.size:
            ref = int(live.min())
            max_off = int(live.max()) - ref
        else:
            ref, max_off = 0, 0
        width = bp.bit_width_for(max_off)
        # padding and null slots get offset 0 (decode to reference_value)
        off = np.where(np.arange(BLOCK_ROWS) < length, v - ref, 0)
        if valid is not None:
            vv = np.zeros(BLOCK_ROWS, dtype=bool)
            vv[:length] = valid[:length]
            off = np.where(vv, off, 0)
        planes = bp.pack_bitplanes_host(off.astype(np.uint64), width)
        return cls(planes, width, ref, pack_validity(valid, length), length,
                   arrow_type)

    def with_logical(self, t: pa.DataType) -> "LiquidPrimitiveArray":
        """Re-tag the logical arrow type (bool stored as uint8)."""
        self._arrow_type = t
        return self

    @property
    def arrow_type(self) -> pa.DataType:
        return self._arrow_type

    def memory_bytes(self) -> int:
        n = self.planes_np.size * 4
        if self.validity_np is not None:
            n += self.validity_np.size * 4
        return n + 64

    def offsets_host(self) -> np.ndarray:
        return bp.unpack_bitplanes_host(self.planes_np)

    def to_device(self, device):
        planes = words_to_tensor(self.planes_np, device)
        off = bp.unpack_bitplanes_many(planes[None])[0]
        vals = off + wrap_i64(self.reference_value)
        valid = (None if self.validity_np is None
                 else words_to_tensor(self.validity_np, device))
        return vals, valid

    def to_arrow(self) -> pa.Array:
        return self.decode_from_offsets(self.offsets_host())

    def decode_from_offsets(self, off: np.ndarray) -> pa.Array:
        """Finish decoding from offsets unpacked elsewhere (the cache's
        batched decode unpacks many blocks at once)."""
        host = off.astype(np.int64) + self.reference_value
        return arrow_with_validity(host, self._arrow_type, self.validity_np,
                                   self.length)

    def try_eval_predicate(self, pred: Predicate, device):
        """Packed row mask of `pred` on `device`, or None without a
        packed-domain form."""
        plan = self.packed_plan(pred)
        if plan is None:
            return None
        if plan[0] == "const":
            return self._const_mask(plan[1], device)
        _, u, op = plan
        bits = bp.cmp_const_op(words_to_tensor(self.planes_np, device),
                               int(u), op)
        return mops.BoolMask(bits, validity_mask_or_full(
            self.validity_np, self.length, device))

    def _const_mask(self, value: bool, device) -> mops.BoolMask:
        return mops.BoolMask(const_words(value, device), validity_mask_or_full(
            self.validity_np, self.length, device))

    def packed_plan(self, pred: Predicate):
        """Host range analysis of a predicate against this block's packed
        domain -> ("const", bool) | ("cmp", offset_u64, op) | None."""
        if pred.op not in ("eq", "ne", "lt", "lt_eq", "gt", "gt_eq"):
            return None
        lit = pred.literal
        if isinstance(lit, bool) or not isinstance(
                lit, (int, float, np.integer, np.floating)):
            return None
        op = pred.op
        # normalize non-integral float literals against an integer domain
        if isinstance(lit, (float, np.floating)):
            if math.isnan(lit):
                return ("const", op == "ne")
            if math.isinf(lit):
                pos = lit > 0
                return ("const", {
                    "eq": False, "ne": True,
                    "lt": pos, "lt_eq": pos,          # v < +inf always
                    "gt": not pos, "gt_eq": not pos,  # v > -inf always
                }[op])
            if float(lit) != int(lit):
                f = float(lit)
                if op == "eq":
                    return ("const", False)
                if op == "ne":
                    return ("const", True)
                if op in ("lt", "lt_eq"):    # v < 10.5  <=>  v <= 10
                    lit, op = math.floor(f), "lt_eq"
                else:                         # v > 10.5  <=>  v >= 11
                    lit, op = math.ceil(f), "gt_eq"
            else:
                lit = int(lit)
        lit = int(lit)
        r = self.reference_value
        max_rep = r + (1 << self.width) - 1
        if op == "eq":
            if lit < r or lit > max_rep:
                return ("const", False)
        elif op == "ne":
            if lit < r or lit > max_rep:
                return ("const", True)
        elif op in ("lt", "lt_eq"):
            if (lit <= r and op == "lt") or (lit < r):
                return ("const", False)
            if (lit > max_rep) or (lit == max_rep and op == "lt_eq"):
                return ("const", True)
        else:  # gt, gt_eq
            if (lit >= max_rep and op == "gt") or (lit > max_rep):
                return ("const", False)
            if (lit < r) or (lit == r and op == "gt_eq"):
                return ("const", True)
        return ("cmp", np.uint64(lit - r), op)
