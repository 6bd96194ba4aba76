"""ALP-encoded float blocks (port of `LiquidFloatArray` in
`liquid_tpu/arrays/float_alp.py`).

Floats that are really scaled decimals are stored as bit-packed integers
enc = round(v * 10^e) minus a reference, plus exception patches (rows
that do not round-trip, kept exactly on the host).  The decode map
off -> (off + ref) * 10^-e is monotone, so a float comparison becomes an
offset threshold found on the host (`lower_bound`) and then a packed
bit-plane compare on the device (K1's single form, one launch per
threshold the operator needs).  The encoder is the reference's, line for
line, so the stored fields are identical.

`SqueezedFloatArray` is the squeezed form: the offset lane bucketized to
2^narrow buckets, the exact block on disk.  A bucket strictly below or
above a threshold's bucket is decided with no IO; only rows in the
threshold's bucket read the backing.  Exception patches stay resident.
"""
from __future__ import annotations

import math

import numpy as np
import pyarrow as pa
import torch

from liquid_tpu_torch.arrays.base import (
    BLOCK_ROWS, LiquidArray, LiquidSqueezedArray, Predicate, const_words,
    pack_validity, validity_mask_or_full,
)
from liquid_tpu_torch.device import words_to_numpy, words_to_tensor
from liquid_tpu_torch.ops import mask as mops
from liquid_tpu_torch.ops import bitpack as bp

_MAX_EXP = 18
_SAFE_INT = float(1 << 51)


def is_supported_type(t: pa.DataType) -> bool:
    return pa.types.is_float32(t) or pa.types.is_float64(t)


class LiquidFloatArray(LiquidArray):
    def __init__(self, planes, width, reference_value, exponent,
                 patch_idx, patch_vals, validity, length, arrow_type):
        self.planes_np = planes                # uint32[bucket, 256]
        self.width = width                     # logical bit width
        self.reference_value = reference_value  # int (encoded domain)
        self.exponent = exponent               # enc = round(v * 10^e)
        self.patch_idx = np.asarray(patch_idx, dtype=np.int32)
        self.patch_vals = np.asarray(patch_vals, dtype=np.float64)
        self.validity_np = validity            # uint32[256] | None
        self.length = length
        self._arrow_type = arrow_type

    @classmethod
    def from_arrow(cls, arr: pa.Array) -> "LiquidFloatArray":
        assert len(arr) <= BLOCK_ROWS
        t = arr.type
        np_dtype = np.float32 if pa.types.is_float32(t) else np.float64
        if arr.null_count:
            valid = np.asarray(arr.is_valid())
            vals = np.asarray(arr.fill_null(0)).astype(np_dtype)
        else:
            valid = None
            vals = np.asarray(arr).astype(np_dtype)
        return cls.from_numpy(vals, valid, t, len(arr))

    @classmethod
    def from_numpy(cls, vals, valid, arrow_type, length):
        np_dtype = vals.dtype
        v = np.zeros(BLOCK_ROWS, dtype=np_dtype)
        v[:length] = vals[:length]
        live_mask = np.zeros(BLOCK_ROWS, dtype=bool)
        live_mask[:length] = True if valid is None else valid[:length]

        def encode(e):
            # decode is enc * (1/scale): multiply, matching decode_host
            scale = 10.0 ** e
            inv = 1.0 / scale
            enc = np.round(v.astype(np.float64) * scale)
            ok = ((np.abs(enc) < _SAFE_INT) & np.isfinite(v)
                  & ((enc * inv).astype(np_dtype) == v))
            return enc, ok

        # rank candidate exponents on a <=512-row sample, then fully
        # verify the best few (ALP's sampling idea)
        live_idx = np.flatnonzero(live_mask)
        if live_idx.size > 512:
            samp = v[live_idx[:: max(1, live_idx.size // 512)]][:512]
        else:
            samp = v[live_idx]

        def sample_exc(e):
            scale = 10.0 ** e
            enc_s = np.round(samp.astype(np.float64) * scale)
            ok_s = ((np.abs(enc_s) < _SAFE_INT) & np.isfinite(samp)
                    & ((enc_s * (1.0 / scale)).astype(np_dtype) == samp))
            return int((~ok_s).sum())

        if samp.size:
            ranked = sorted(range(_MAX_EXP + 1),
                            key=lambda e: (sample_exc(e), e))
        else:
            ranked = [0]
        best_e, best_exc = ranked[0], None
        for e in ranked[:3]:
            _, ok = encode(e)
            n_exc = int((live_mask & ~ok).sum())
            if best_exc is None or n_exc < best_exc:
                best_e, best_exc = e, n_exc
            if n_exc == 0:
                break
        enc, ok = encode(best_e)
        live_ok = live_mask & ok
        exc_rows = np.flatnonzero(live_mask & ~ok).astype(np.int32)
        enc_i = np.where(live_ok, enc, 0.0).astype(np.int64)
        ref = int(enc_i[live_ok].min()) if live_ok.any() else 0
        off = np.where(live_ok, enc_i - ref, 0)
        width = bp.bit_width_for(int(off.max()) if off.size else 0)
        planes = bp.pack_bitplanes_host(off.astype(np.uint64), width)
        return cls(planes, width, ref, best_e, exc_rows,
                   v.astype(np.float64)[exc_rows],
                   pack_validity(valid, length), length, arrow_type)

    @property
    def arrow_type(self):
        return self._arrow_type

    @property
    def num_patches(self) -> int:
        return int(self.patch_idx.size)

    @property
    def inv(self) -> float:
        return 1.0 / (10.0 ** self.exponent)

    def memory_bytes(self) -> int:
        n = (self.planes_np.size * 4 + self.patch_idx.nbytes
             + self.patch_vals.nbytes)
        if self.validity_np is not None:
            n += self.validity_np.size * 4
        return n + 64

    def decode_host(self, off=None) -> np.ndarray:
        if off is None:
            off = bp.unpack_bitplanes_host(self.planes_np)
        enc = off.astype(np.int64) + self.reference_value
        vals = enc.astype(np.float64) * self.inv
        vals[self.patch_idx] = self.patch_vals
        return vals

    def to_device(self, device):
        # host decode for exactness, shipped once
        vals = self.decode_host()
        if pa.types.is_float32(self._arrow_type):
            vals = vals.astype(np.float32)
        valid = (None if self.validity_np is None
                 else torch.from_numpy(self.validity_np.view(np.int32)
                                       ).to(device))
        return torch.from_numpy(vals).to(device), valid

    def to_arrow(self) -> pa.Array:
        return self.decode_from_offsets(None)

    def decode_from_offsets(self, off) -> pa.Array:
        """Finish decoding from offsets unpacked elsewhere (None: unpack
        here)."""
        vals = self.decode_host(off)[: self.length]
        if pa.types.is_float32(self._arrow_type):
            vals = vals.astype(np.float32)
        if self.validity_np is not None:
            valid = mops.unpack_bits_host(self.validity_np)[: self.length]
            return pa.array(vals, type=self._arrow_type, mask=~valid)
        return pa.array(vals, type=self._arrow_type)

    # -- predicate: integer-threshold translation --------------------------

    def _dec1(self, off: int) -> float:
        """Decode a single offset exactly as decode_host does."""
        v = np.float64(off + self.reference_value) * np.float64(self.inv)
        if pa.types.is_float32(self._arrow_type):
            v = np.float64(np.float32(v))
        return float(v)

    def lower_bound(self, lit: float, strict: bool) -> int:
        """Smallest offset T with dec(T) > lit (strict) or >= lit; may
        return max_off+1 if no offset qualifies."""
        hi_off = (1 << self.width) - 1 if self.width else 0

        def above(off):
            d = self._dec1(off)
            return d > lit if strict else d >= lit

        if above(0):
            return 0
        if not above(hi_off):
            return hi_off + 1
        lo, hi = 0, hi_off
        while lo + 1 < hi:
            mid = (lo + hi) // 2
            if above(mid):
                hi = mid
            else:
                lo = mid
        return hi

    def try_eval_predicate(self, pred: Predicate, device):
        """Packed row mask of `pred` on `device`: the float literal becomes
        offset thresholds (the decode map is monotone), compared on the
        planes; patch rows are settled on the host from their exact
        values.  None without such a form."""
        if pred.op not in _FNS:
            return None
        lit = pred.literal
        if isinstance(lit, bool) or not isinstance(
                lit, (int, float, np.integer, np.floating)):
            return None
        lit = float(lit)
        op = pred.op
        if np.isnan(lit):
            bits = const_words(op == "ne", device)
        else:
            planes = words_to_tensor(self.planes_np, device)

            def lt(strict):  # off < the first offset decoding >= / > lit
                return self._off_lt(planes, self.lower_bound(lit, strict),
                                    device)
            if op == "lt":
                bits = lt(False)
            elif op == "lt_eq":
                bits = lt(True)
            elif op == "gt":
                bits = ~lt(True)
            elif op == "gt_eq":
                bits = ~lt(False)
            elif op == "eq":
                bits = ~lt(False) & lt(True)
            else:
                bits = lt(False) | ~lt(True)
        if self.num_patches:
            bits = _patch_bits(bits, self.patch_idx, self.patch_vals,
                               self._arrow_type, op, lit, pred.keep_nan,
                               device)
        return mops.BoolMask(bits, validity_mask_or_full(
            self.validity_np, self.length, device))

    def _off_lt(self, planes, t: int, device):
        max_off = (1 << self.width) - 1 if self.width else 0
        if t <= 0:
            return const_words(False, device)
        if t > max_off:
            return const_words(True, device)
        return bp.cmp_const(planes, t)[0]

    def to_bytes(self) -> bytes:
        from liquid_tpu_torch.arrays import ipc
        return ipc.serialize_float(self)

    def squeeze(self):
        return squeeze_float(self)


_FNS = {"eq": np.equal, "ne": np.not_equal, "lt": np.less,
        "lt_eq": np.less_equal, "gt": np.greater, "gt_eq": np.greater_equal}


def _patch_bits(bits, patch_idx, patch_vals, arrow_type, op, lit, keep_nan,
                device):
    """Overwrite the mask bits of the patch rows with the verdicts of
    their exact values (host side)."""
    pv = patch_vals
    if pa.types.is_float32(arrow_type):  # SQL promotes f32 to f64
        pv = pv.astype(np.float32).astype(np.float64)
    if np.isnan(lit):
        verdict = np.full(len(pv), op == "ne")
    else:
        verdict = _FNS[op](pv, np.float64(lit))
    if keep_nan:
        verdict = verdict | np.isnan(pv)  # NaN lives in patches
    host = words_to_numpy(bits).copy()
    words = patch_idx // 32
    set_bits = np.uint32(1) << (patch_idx % 32).astype(np.uint32)
    np.bitwise_and.at(host, words, ~set_bits)
    np.bitwise_or.at(host, words, np.where(verdict, set_bits, np.uint32(0)))
    return words_to_tensor(host, device)


class SqueezedFloatArray(LiquidSqueezedArray):
    """Squeezed ALP floats: the offset lane quantized to 2^narrow buckets
    of `bucket_size` offsets, patches resident, the exact block on
    disk."""

    def __init__(self, planes, narrow_width, bucket_size, width,
                 reference_value, exponent, patch_idx, patch_vals,
                 validity, length, arrow_type, disk_range=None):
        self.planes_np = planes             # bucket ids, bit-planes
        self.narrow_width = narrow_width
        self.bucket_size = bucket_size
        self.width = width                  # the original offset width
        self.reference_value = reference_value
        self.exponent = exponent
        self.patch_idx = np.asarray(patch_idx, dtype=np.int32)
        self.patch_vals = np.asarray(patch_vals, dtype=np.float64)
        self.validity_np = validity
        self.length = length
        self.arrow_type = arrow_type
        self._disk_range = disk_range

    def memory_bytes(self) -> int:
        n = (self.planes_np.size * 4 + self.patch_idx.nbytes
             + self.patch_vals.nbytes)
        if self.validity_np is not None:
            n += self.validity_np.size * 4
        return n + 64

    def disk_backing(self):
        return ("liquid", self._disk_range)

    def _read_full(self, io):
        from liquid_tpu_torch.arrays import ipc
        return ipc.deserialize(io.read(self._disk_range))

    def to_arrow(self, io) -> pa.Array:
        return self._read_full(io).to_arrow()

    def _dec1(self, off: int) -> float:
        v = np.float64(off + self.reference_value) * np.float64(
            10.0 ** (-self.exponent))
        if pa.types.is_float32(self.arrow_type):
            v = np.float64(np.float32(v))
        return float(v)

    def lower_bound(self, lit: float, strict: bool) -> int:
        """Smallest offset T with dec(T) > lit (strict) or >= lit."""
        hi_off = (1 << self.width) - 1 if self.width else 0

        def above(off):
            d = self._dec1(off)
            return d > lit if strict else d >= lit

        if above(0):
            return 0
        if not above(hi_off):
            return hi_off + 1
        lo, hi = 0, hi_off
        while lo + 1 < hi:
            mid = (lo + hi) // 2
            if above(mid):
                hi = mid
            else:
                lo = mid
        return hi

    def _bucket_lt(self, planes, t: int, device):
        """(rows certainly below offset t, rows in t's bucket that only
        the backing can settle), both packed."""
        none = const_words(False, device)
        max_off = (1 << self.width) - 1 if self.width else 0
        if t <= 0:
            return none, none
        if t > max_off:
            return const_words(True, device), none
        bt, rem = divmod(t, self.bucket_size)
        if bt >= 1 << self.narrow_width:
            return const_words(True, device), none
        lt, eq = bp.cmp_const(planes, bt)
        return lt, (eq if rem else none)

    def try_eval_predicate(self, pred: Predicate, io, device):
        if pred.op not in _FNS:
            return None
        lit = pred.literal
        if isinstance(lit, bool) or not isinstance(
                lit, (int, float, np.integer, np.floating)):
            return None
        lit = float(lit)
        op = pred.op
        none = const_words(False, device)
        if math.isnan(lit):
            bits, amb = const_words(op == "ne", device), none
        else:
            planes = words_to_tensor(self.planes_np, device)

            def lt(strict):
                return self._bucket_lt(
                    planes, self.lower_bound(lit, strict), device)
            # ambiguity only from the thresholds the operator uses
            if op == "lt":
                bits, amb = lt(False)
            elif op == "lt_eq":
                bits, amb = lt(True)
            elif op == "gt":
                bits, amb = lt(True)
                bits = ~bits
            elif op == "gt_eq":
                bits, amb = lt(False)
                bits = ~bits
            else:
                (lt_ge, a1), (lt_gt, a2) = lt(False), lt(True)
                bits = (~lt_ge & lt_gt) if op == "eq" else (lt_ge | ~lt_gt)
                amb = a1 | a2
        if int(mops.count(amb)):
            exact = self._read_full(io).try_eval_predicate(pred, device)
            if exact is None:
                return None
            bits = (bits & ~amb) | (exact.bits & amb)
        if len(self.patch_idx):
            bits = _patch_bits(bits, self.patch_idx, self.patch_vals,
                               self.arrow_type, op, lit, pred.keep_nan,
                               device)
        return mops.BoolMask(bits, validity_mask_or_full(
            self.validity_np, self.length, device))


def squeeze_float(arr: LiquidFloatArray):
    """LiquidFloatArray -> (SqueezedFloatArray without its disk range, the
    exact bytes); None when the lane is too narrow to gain anything."""
    if arr.width <= 2:
        return None
    narrow = max(1, (arr.width + 1) // 2)
    nb = 1 << narrow
    bs = max(1, ((1 << arr.width) + nb - 1) // nb)
    off = bp.unpack_bitplanes_host(arr.planes_np)
    buckets = off // np.uint64(bs)
    sq = SqueezedFloatArray(bp.pack_bitplanes_host(buckets, narrow), narrow,
                            bs, arr.width, arr.reference_value, arr.exponent,
                            arr.patch_idx, arr.patch_vals, arr.validity_np,
                            arr.length, arr.arrow_type)
    return sq, arr.to_bytes()
