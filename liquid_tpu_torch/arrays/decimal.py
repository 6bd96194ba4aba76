"""Decimal blocks (port of `liquid_tpu/arrays/decimal.py`).

- `LiquidDecimalArray`: a decimal whose unscaled values fit i64 is a
  bit-plane block of the unscaled integers, like a primitive block, and
  its predicates are packed compares on the unscaled domain (K1's single
  form, `ops/bitpack`).  It subclasses `LiquidPrimitiveArray`, so every
  path that takes a primitive block takes it too; the block itself makes
  them right: `packed_plan` scales the literal (a literal the scale
  cannot represent moves `lt` to `lt_eq` and `gt` to `gt_eq`, and makes
  `eq` / `ne` constant), and `decode_from_offsets` returns the decimal at
  its scale.  The cache's batched compares and decodes, the classic scan
  and the fused route's preparation (which passes a decimal column on to
  the classic path) all go through these two methods.  It has no
  squeezed form.
- `LiquidFixedLenByteArray`: a decimal that does not fit i64, and every
  `decimal256`, keeps one dictionary code per row (int32) and its
  distinct values as FSST-compressed fixed-width bytes.  A predicate is
  decided once per distinct value on the host (pyarrow) and gathered by
  code on the device, as `byteview` does.

The unscaled integers are read from and written to the arrow buffers
with numpy (two's complement, little-endian), so the blocks' words equal
the reference's.
"""
from __future__ import annotations

import decimal as pydec
import math
from typing import Optional, Tuple

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import torch

from liquid_tpu_torch.arrays.base import (
    BLOCK_ROWS, LiquidArray, Predicate, pack_validity,
)
from liquid_tpu_torch.arrays.primitive import LiquidPrimitiveArray
from liquid_tpu_torch.device import words_to_tensor
from liquid_tpu_torch.ops import mask as mops

_CMP_FNS = {"eq": pc.equal, "ne": pc.not_equal, "lt": pc.less,
            "lt_eq": pc.less_equal, "gt": pc.greater,
            "gt_eq": pc.greater_equal}


def is_supported_type(t: pa.DataType) -> bool:
    return pa.types.is_decimal(t)


def _byte_width(t: pa.DataType) -> int:
    return 32 if pa.types.is_decimal256(t) else 16


def _raw_rows(arr: pa.Array) -> np.ndarray:
    """uint8[n, w]: each row's w little-endian bytes."""
    w = _byte_width(arr.type)
    n = len(arr)
    raw = np.frombuffer(arr.buffers()[1], dtype=np.uint8,
                        count=(arr.offset + n) * w)[arr.offset * w:]
    return raw.reshape(n, w)


def _unscaled_i64(arr: pa.Array) -> Tuple[np.ndarray, np.ndarray]:
    """(low 64 bits of every unscaled value as int64, bool[n]: the value
    equals them, i.e. its higher words are the low word's sign)."""
    words = np.ascontiguousarray(_raw_rows(arr)).view("<i8")
    low = words[:, 0].astype(np.int64)
    fits = np.all(words[:, 1:] == (low >> 63)[:, None], axis=1)
    return low, fits


def _decimal_from_unscaled(vals: np.ndarray, t: pa.DataType,
                           valid: Optional[np.ndarray] = None) -> pa.Array:
    """A decimal array of type t from int64 unscaled values (no
    rescaling): each value sign-extended to the type's width."""
    n = len(vals)
    vals = np.asarray(vals, dtype=np.int64)
    words = np.empty((n, _byte_width(t) // 8), dtype="<i8")
    words[:, 0] = vals
    words[:, 1:] = (vals >> 63)[:, None]
    bufs = [None, pa.py_buffer(words.tobytes())]
    if valid is not None:
        bufs[0] = pa.py_buffer(np.packbits(valid, bitorder="little")
                               .tobytes())
        return pa.Array.from_buffers(t, n, bufs,
                                     null_count=int((~valid).sum()))
    return pa.Array.from_buffers(t, n, bufs)


def _scaled_literal(lit, scale: int):
    """A numeric literal in the unscaled domain -> (floor(lit * 10^scale),
    exact) or "nan" / "inf" / "-inf"; None when it is not a number."""
    if isinstance(lit, bool) or not isinstance(
            lit, (int, float, pydec.Decimal, np.integer, np.floating)):
        return None
    if isinstance(lit, (float, np.floating)):
        f = float(lit)
        if math.isnan(f):
            return "nan"
        if math.isinf(f):
            return "inf" if f > 0 else "-inf"
        lit = pydec.Decimal(str(f))
    elif isinstance(lit, (int, np.integer)):
        lit = pydec.Decimal(int(lit))
    elif not lit.is_finite():
        return "nan" if lit.is_nan() else ("inf" if lit > 0 else "-inf")
    d = lit * (pydec.Decimal(10) ** scale)
    whole = d.to_integral_value(rounding=pydec.ROUND_FLOOR)
    return int(whole), d == whole


class LiquidDecimalArray(LiquidPrimitiveArray):
    """A decimal whose unscaled values fit i64: bit-planes of the unscaled
    integers."""

    @classmethod
    def fits(cls, arr: pa.Array) -> bool:
        t = arr.type
        if pa.types.is_decimal128(t) and t.precision <= 18:
            return True
        _low, fits = _unscaled_i64(arr)
        if arr.null_count:
            fits = fits[np.asarray(arr.is_valid())]
        return bool(fits.all())

    @classmethod
    def from_arrow(cls, arr: pa.Array) -> "LiquidDecimalArray":
        assert len(arr) <= BLOCK_ROWS, len(arr)
        vals, _fits = _unscaled_i64(arr)
        valid = None
        if arr.null_count:
            valid = np.asarray(arr.is_valid())
            vals = np.where(valid, vals, 0)
        base = LiquidPrimitiveArray.from_numpy(vals, valid, pa.int64(),
                                               len(arr))
        return cls(base.planes_np, base.width, base.reference_value,
                   base.validity_np, base.length, arr.type)

    def decode_from_offsets(self, off: np.ndarray) -> pa.Array:
        host = (off.astype(np.int64) + self.reference_value)[: self.length]
        valid = None
        if self.validity_np is not None:
            valid = mops.unpack_bits_host(self.validity_np)[: self.length]
        return _decimal_from_unscaled(host, self._arrow_type, valid)

    def packed_plan(self, pred: Predicate):
        """The primitive plan of `pred` with its literal scaled to the
        unscaled domain; a literal the scale cannot represent decides
        `eq` / `ne` alone and turns `x < L` into `x <= floor(L)` and
        `x > L` into `x >= floor(L) + 1`."""
        if pred.op not in ("eq", "ne", "lt", "lt_eq", "gt", "gt_eq"):
            return None
        r = _scaled_literal(pred.literal, self._arrow_type.scale)
        if r is None:
            return None
        op = pred.op
        if r == "nan":
            return ("const", op == "ne")
        if r in ("inf", "-inf"):
            pos = r == "inf"
            return ("const", {"eq": False, "ne": True, "lt": pos,
                              "lt_eq": pos, "gt": not pos,
                              "gt_eq": not pos}[op])
        lit, exact = r
        if not exact:
            if op in ("eq", "ne"):
                return ("const", op == "ne")
            if op in ("lt", "lt_eq"):
                op = "lt_eq"
            else:
                lit, op = lit + 1, "gt_eq"
        return LiquidPrimitiveArray.packed_plan(self, Predicate(op, lit))

    def to_bytes(self) -> bytes:
        from liquid_tpu_torch.arrays import ipc
        return ipc.serialize_decimal(self)

    def squeeze(self):
        return None


class LiquidFixedLenByteArray(LiquidArray):
    """A decimal that does not fit i64 (or any decimal256): int32 codes
    plus its distinct values as FSST-compressed fixed-width bytes."""

    def __init__(self, codes: np.ndarray, fsst, byte_width: int,
                 validity: Optional[np.ndarray], length: int,
                 arrow_type: pa.DataType):
        self.codes_np = codes          # int32[BLOCK_ROWS]
        self.fsst = fsst               # arrays.fsst.FsstBuffer of w-byte values
        self.byte_width = byte_width
        self.validity_np = validity    # uint32[256] | None
        self.length = length
        self._arrow_type = arrow_type
        #: (op, literal) -> bool[dict] verdict
        self._verdict_cache: dict = {}

    @classmethod
    def from_arrow(cls, arr: pa.Array, compressor=None
                   ) -> "LiquidFixedLenByteArray":
        from liquid_tpu_torch.arrays.fsst import FsstBuffer
        assert len(arr) <= BLOCK_ROWS, len(arr)
        t = arr.type
        w = _byte_width(t)
        length = len(arr)
        rows = _raw_rows(arr)
        valid = None
        if arr.null_count:
            valid = np.asarray(arr.is_valid())
            rows = np.where(valid[:, None], rows, 0)
        if length:
            uniq, inverse = np.unique(rows, axis=0, return_inverse=True)
        else:
            uniq, inverse = np.zeros((0, w), np.uint8), np.zeros(0, np.int64)
        codes = np.zeros(BLOCK_ROWS, dtype=np.int32)
        codes[:length] = inverse.reshape(-1).astype(np.int32)
        n_dict = len(uniq)
        offs = np.arange(n_dict + 1, dtype=np.int64) * w
        dict_bin = pa.LargeBinaryArray.from_buffers(
            pa.large_binary(), n_dict,
            [None, pa.py_buffer(offs.tobytes()),
             pa.py_buffer(np.ascontiguousarray(uniq).tobytes())])
        return cls(codes, FsstBuffer.from_arrow(dict_bin, compressor), w,
                   pack_validity(valid, length), length, t)

    @property
    def arrow_type(self) -> pa.DataType:
        return self._arrow_type

    @property
    def dict_size(self) -> int:
        return len(self.fsst)

    def memory_bytes(self) -> int:
        n = self.codes_np.size * 4 + self.fsst.memory_bytes()
        if self.validity_np is not None:
            n += self.validity_np.size * 4
        return n + 64

    def to_device(self, device):
        """(codes int32[BLOCK_ROWS], packed validity or None)."""
        codes = torch.from_numpy(self.codes_np).to(device)
        valid = (None if self.validity_np is None
                 else words_to_tensor(self.validity_np, device))
        return codes, valid

    def dictionary(self) -> pa.Array:
        """The distinct decimal values (decompressed)."""
        data, _offsets = self.fsst.to_numpy()
        n = len(self.fsst)
        return pa.Array.from_buffers(
            self._arrow_type, n,
            [None, pa.py_buffer(data[: n * self.byte_width].tobytes())])

    def to_arrow(self) -> pa.Array:
        codes = self.codes_np[: self.length]
        mask = None
        if self.validity_np is not None:
            mask = ~mops.unpack_bits_host(self.validity_np)[: self.length]
        idx = pa.array(codes, type=pa.int32(), mask=mask)
        return pa.DictionaryArray.from_arrays(idx, self.dictionary()).cast(
            self._arrow_type)

    def dict_verdict(self, pred: Predicate) -> Optional[np.ndarray]:
        """bool[dict_size] verdict of `pred` per distinct value (pyarrow),
        cached per (op, literal); None for a literal the type cannot
        hold or a predicate without a verdict form."""
        if pred.op not in _CMP_FNS:
            return None
        key = (pred.op, str(pred.literal))
        verdict = self._verdict_cache.get(key)
        if verdict is None:
            lit = pred.literal
            if isinstance(lit, bool) or not isinstance(
                    lit, (int, float, pydec.Decimal, np.integer, np.floating)):
                return None
            d = self.dictionary()
            try:
                lit_s = pa.scalar(pydec.Decimal(str(lit)), type=d.type)
            except (pa.ArrowInvalid, pydec.InvalidOperation, ValueError):
                return None
            verdict = np.asarray(_CMP_FNS[pred.op](d, lit_s).fill_null(False))
            self._verdict_cache[key] = verdict
        return verdict

    def try_eval_predicate(self, pred: Predicate, device
                           ) -> Optional[mops.BoolMask]:
        """Packed row mask on `device`: the per-value verdict gathered by
        code; None when `dict_verdict` has none (the caller decodes)."""
        from liquid_tpu_torch.arrays.base import validity_mask_or_full
        from liquid_tpu_torch.arrays.byteview import verdict_gather
        verdict = self.dict_verdict(pred)
        if verdict is None:
            return None
        codes, _ = self.to_device(device)
        bits = verdict_gather(torch.from_numpy(verdict).to(device), codes)
        return mops.BoolMask(bits, validity_mask_or_full(
            self.validity_np, self.length, device))

    def to_bytes(self) -> bytes:
        from liquid_tpu_torch.arrays import ipc
        return ipc.serialize_fixedlen(self)
