"""Squeezed ("hybrid") blocks: a narrow resident form plus the exact bytes
on disk (port of `liquid_tpu/arrays/hybrid.py`).

- `SqueezedPrimitiveArray`: integer offsets clamped at a sentinel of half
  the width; only predicates the clamped domain cannot decide read disk.
- `SqueezedQuantizedArray`: offsets bucketized to 2^narrow equal-width
  buckets; only rows in the literal's own bucket read disk.
- `SqueezedByteViewArray`: codes, prefix keys and fingerprints resident,
  the dictionary on disk; ambiguous entries read it once.
- `SqueezedDate32Array`: one extracted date field resident; EXTRACT of
  that field reads nothing (`to_component_array`).

The resident planes stay on the host as numpy words, as the liquid
blocks keep `planes_np`, and are uploaded when a predicate runs; every
packed compare is K1's single form (`ops/bitpack.cmp_const_op`).
`memory_bytes()` counts what the reference counts, so the budget picks
the same victims.  The IO handler protocol is
`read((offset, len) | None) -> bytes`.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import pyarrow as pa
import torch

from liquid_tpu_torch.arrays import ipc
from liquid_tpu_torch.arrays.base import (
    BLOCK_ROWS, LiquidSqueezedArray, Predicate, const_words,
    validity_mask_or_full,
)
from liquid_tpu_torch.device import words_to_tensor
from liquid_tpu_torch.ops import bitpack as bp
from liquid_tpu_torch.ops import mask as mops
from liquid_tpu_torch.utils import dates as datelib

_CMP = ("eq", "ne", "lt", "lt_eq", "gt", "gt_eq")


def _int_literal(pred: Predicate):
    """-> ("int", value) for an integral numeric literal, ("exact", None)
    for one only the exact backing can settle (fractional or not
    finite), or None for a predicate with no packed form."""
    if pred.op not in _CMP:
        return None
    lit = pred.literal
    if isinstance(lit, bool) or not isinstance(
            lit, (int, np.integer, float, np.floating)):
        return None
    if isinstance(lit, (float, np.floating)) and (
            not math.isfinite(lit) or float(lit) != int(lit)):
        return ("exact", None)
    return ("int", int(lit))


class _Backed(LiquidSqueezedArray):
    """The disk half every squeezed block shares: its IPC bytes."""

    _disk_range = None

    def disk_backing(self):
        return ("liquid", self._disk_range)

    def _read_full(self, io):
        return ipc.deserialize(io.read(self._disk_range))

    def to_arrow(self, io) -> pa.Array:
        return self._read_full(io).to_arrow()

    def _resident_bytes(self, n: int) -> int:
        if self.validity_np is not None:
            n += self.validity_np.size * 4
        return n + 64

    def _mask(self, bits: torch.Tensor, device) -> mops.BoolMask:
        return mops.BoolMask(bits, validity_mask_or_full(
            self.validity_np, self.length, device))


class SqueezedPrimitiveArray(_Backed):
    """Clamped integers: an offset at `sentinel = 2^narrow_width - 1`
    means "true value >= reference + sentinel, consult disk"."""

    def __init__(self, planes: np.ndarray, narrow_width: int,
                 reference_value: int, validity: Optional[np.ndarray],
                 length: int, arrow_type: pa.DataType, disk_range):
        self.planes_np = planes
        self.narrow_width = narrow_width
        self.reference_value = reference_value
        self.validity_np = validity
        self.length = length
        self.arrow_type = arrow_type
        self._disk_range = disk_range

    def memory_bytes(self) -> int:
        return self._resident_bytes(self.planes_np.size * 4)

    @property
    def sentinel(self) -> int:
        return (1 << self.narrow_width) - 1

    def try_eval_predicate(self, pred: Predicate, io, device):
        """Decided from the clamped domain when the verdict is uniform over
        the clamped rows' interval [ref + sentinel, inf); else exact IO."""
        lit = _int_literal(pred)
        if lit is None:
            return None
        if lit[0] == "exact":
            return self._read_full(io).try_eval_predicate(pred, device)
        lit = lit[1]
        r, s, op = self.reference_value, self.sentinel, pred.op
        floor = r + s  # every clamped value is >= this
        decided = {"eq": lit < floor, "ne": lit < floor, "lt": lit <= floor,
                   "lt_eq": lit < floor, "gt": lit < floor,
                   "gt_eq": lit <= floor}[op]
        if not decided:
            return self._read_full(io).try_eval_predicate(pred, device)
        clamped_verdict = op in ("ne", "gt", "gt_eq")
        planes = words_to_tensor(self.planes_np, device)
        u = lit - r
        is_clamped = bp.cmp_const_op(planes, s, "eq")
        if 0 <= u < s:
            exact_bits = bp.cmp_const_op(planes, u, op)
        else:
            # the literal lies below ref or at / above the clamped range:
            # the verdict is uniform over the unclamped domain [r, r + s)
            exact_true = {"eq": False, "ne": True, "lt": u >= s,
                          "lt_eq": u >= s, "gt": lit < r,
                          "gt_eq": lit <= r}[op]
            exact_bits = const_words(exact_true, device)
        c_bits = const_words(clamped_verdict, device)
        bits = (exact_bits & ~is_clamped) | (c_bits & is_clamped)
        return self._mask(bits, device)


def squeeze_primitive(arr) -> Optional[Tuple[SqueezedPrimitiveArray, bytes]]:
    """LiquidPrimitiveArray -> (clamped form without its disk range, the
    exact bytes); None at width <= 2 (nothing to gain)."""
    if arr.width <= 2:
        return None
    narrow = max(1, (arr.width + 1) // 2)
    sentinel = (1 << narrow) - 1
    off = bp.unpack_bitplanes_host(arr.planes_np)
    clamped = np.minimum(off, np.uint64(sentinel))
    sq = SqueezedPrimitiveArray(bp.pack_bitplanes_host(clamped, narrow),
                                narrow, arr.reference_value, arr.validity_np,
                                arr.length, arr.arrow_type, disk_range=None)
    return sq, arr.to_bytes()


class SqueezedQuantizedArray(_Backed):
    """Quantized integers: offsets bucketized to 2^narrow_width buckets of
    `bucket_size` values; a comparison reads disk only when a row lies in
    the literal's own bucket."""

    def __init__(self, planes: np.ndarray, narrow_width: int,
                 reference_value: int, bucket_size: int,
                 validity: Optional[np.ndarray], length: int,
                 arrow_type: pa.DataType, disk_range):
        self.planes_np = planes             # bucket ids, bit-planes
        self.narrow_width = narrow_width
        self.reference_value = reference_value
        self.bucket_size = bucket_size      # values per bucket (>= 1)
        self.validity_np = validity
        self.length = length
        self.arrow_type = arrow_type
        self._disk_range = disk_range

    def memory_bytes(self) -> int:
        return self._resident_bytes(self.planes_np.size * 4)

    def try_eval_predicate(self, pred: Predicate, io, device):
        lit = _int_literal(pred)
        if lit is None:
            return None
        if lit[0] == "exact":
            return self._read_full(io).try_eval_predicate(pred, device)
        lit = lit[1]
        op = pred.op
        b = (lit - self.reference_value) // self.bucket_size
        if b < 0 or b >= 1 << self.narrow_width:
            # outside the stored domain: the exact block answers
            return self._read_full(io).try_eval_predicate(pred, device)
        planes = words_to_tensor(self.planes_np, device)
        lt_b, eq_b = bp.cmp_const(planes, b)
        if op in ("lt", "lt_eq"):
            decided = lt_b
        elif op in ("gt", "gt_eq"):
            decided = ~(lt_b | eq_b)
        else:  # outside the literal's bucket: never equal
            decided = const_words(op == "ne", device)
        if int(mops.count(eq_b)) == 0:
            return self._mask(decided, device)
        # rows share the literal's bucket: settle them with the backing
        exact = self._read_full(io).try_eval_predicate(pred, device)
        if exact is None:
            return None
        return self._mask((decided & ~eq_b) | (exact.bits & eq_b), device)


def squeeze_primitive_quantized(arr
                                ) -> Optional[Tuple[SqueezedQuantizedArray,
                                                    bytes]]:
    """LiquidPrimitiveArray -> (quantized form without its disk range, the
    exact bytes); None at width <= 2."""
    if arr.width <= 2:
        return None
    narrow = max(1, (arr.width + 1) // 2)
    span = 1 << arr.width
    bucket_size = max(1, (span + (1 << narrow) - 1) >> narrow)
    off = bp.unpack_bitplanes_host(arr.planes_np)
    buckets = np.minimum(off // np.uint64(bucket_size),
                         np.uint64((1 << narrow) - 1))
    sq = SqueezedQuantizedArray(bp.pack_bitplanes_host(buckets, narrow),
                                narrow, arr.reference_value, bucket_size,
                                arr.validity_np, arr.length, arr.arrow_type,
                                disk_range=None)
    return sq, arr.to_bytes()


class SqueezedByteViewArray(_Backed):
    """Codes, prefix keys and fingerprints resident; the dictionary on
    disk."""

    def __init__(self, codes: np.ndarray, prefix_meta, fingerprints,
                 validity: Optional[np.ndarray], length: int,
                 arrow_type: pa.DataType, disk_range):
        self.codes_np = codes               # int32[BLOCK_ROWS]
        self.prefix_meta = prefix_meta      # prefixkeys.PrefixMeta
        self.fingerprints = fingerprints    # uint32[dict] | None
        self.validity_np = validity
        self.length = length
        self.arrow_type = arrow_type
        self._disk_range = disk_range

    def memory_bytes(self) -> int:
        pm = self.prefix_meta
        n = (self.codes_np.size * 4 + pm.prefixes.nbytes
             + pm.rest_lens.nbytes + len(pm.shared))
        if self.fingerprints is not None:
            n += self.fingerprints.nbytes
        return self._resident_bytes(n)

    def try_eval_predicate(self, pred: Predicate, io, device):
        from liquid_tpu_torch.arrays import prefixkeys as pk
        from liquid_tpu_torch.arrays.byteview import (
            LiquidByteViewArray, _as_bytes, _needle_fingerprint,
            verdict_gather)
        lit_b = _as_bytes(pred.literal)
        if lit_b is None:
            return None
        needle_fp = _needle_fingerprint(lit_b) if lit_b else 0
        verdict, ambiguous = pk.prefix_verdict(
            self.prefix_meta, pred.op, lit_b, self.fingerprints, needle_fp)
        if verdict is None:
            return self._read_full(io).try_eval_predicate(pred, device)
        if ambiguous.any():
            # read the dictionary once, settle the ambiguous entries
            amb_idx = np.flatnonzero(ambiguous)
            sub = self._read_full(io).dictionary.take(pa.array(amb_idx))
            tmp = LiquidByteViewArray(np.zeros(BLOCK_ROWS, np.int32), sub,
                                      None, len(sub), self.arrow_type)
            sub_verdict = tmp._dict_verdict(pred)
            if sub_verdict is None:
                return self._read_full(io).try_eval_predicate(pred, device)
            verdict = verdict.copy()
            verdict[amb_idx] = sub_verdict
        bits = verdict_gather(torch.from_numpy(verdict).to(device),
                              torch.from_numpy(self.codes_np).to(device))
        return self._mask(bits, device)


def squeeze_byteview(arr) -> Tuple[SqueezedByteViewArray, bytes]:
    from liquid_tpu_torch.arrays import prefixkeys as pk
    from liquid_tpu_torch.arrays.byteview import _fingerprints
    meta = (arr.prefix_meta if arr.prefix_meta is not None
            else pk.build_prefix_meta(arr.dictionary))
    fps = (arr.fingerprints if arr.fingerprints is not None
           else _fingerprints(arr.dictionary))
    sq = SqueezedByteViewArray(arr.codes_np, meta, fps, arr.validity_np,
                               arr.length, arr.arrow_type, disk_range=None)
    return sq, arr.to_bytes()


class SqueezedDate32Array(_Backed):
    """One extracted date field resident (bit-packed); the full date32
    block on disk."""

    def __init__(self, planes: np.ndarray, width: int, component_ref: int,
                 field: str, validity: Optional[np.ndarray], length: int,
                 disk_range):
        self.planes_np = planes
        self.width = width
        self.component_ref = component_ref
        self.field = field  # year | month | day | dow
        self.validity_np = validity
        self.length = length
        self.arrow_type = pa.date32()
        self._disk_range = disk_range

    def memory_bytes(self) -> int:
        return self._resident_bytes(self.planes_np.size * 4)

    def to_component_array(self, field: str, device):
        """-> (values int32[BLOCK_ROWS], packed validity int32[256] or
        None) on `device`, with no IO; None for another field."""
        if field != self.field:
            return None
        off = bp.unpack_bitplanes_many(
            words_to_tensor(self.planes_np, device)[None])[0]
        vals = off.to(torch.int32) + self.component_ref
        valid = (None if self.validity_np is None
                 else words_to_tensor(self.validity_np, device))
        return vals, valid

    def try_eval_predicate(self, pred: Predicate, io, device):
        # a predicate on the date itself needs the backing; predicates on
        # the field go through to_component_array
        return self._read_full(io).try_eval_predicate(pred, device)


def squeeze_date32(arr, field: str
                   ) -> Optional[Tuple[SqueezedDate32Array, bytes]]:
    """A date32 LiquidPrimitiveArray and an EXTRACT field -> (the field's
    resident form without its disk range, the exact bytes)."""
    if not pa.types.is_date32(arr.arrow_type):
        return None
    days = (bp.unpack_bitplanes_host(arr.planes_np).astype(np.int64)
            + arr.reference_value)
    comp = datelib.extract_field(days, field)
    ref = int(comp.min()) if comp.size else 0
    off = (comp.astype(np.int64) - ref).astype(np.uint64)
    width = bp.bit_width_for(int(off.max()) if off.size else 0)
    sq = SqueezedDate32Array(bp.pack_bitplanes_host(off, width), width, ref,
                             field, arr.validity_np, arr.length,
                             disk_range=None)
    return sq, arr.to_bytes()
