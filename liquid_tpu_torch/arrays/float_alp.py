"""ALP-encoded float blocks (port of `LiquidFloatArray` in
`liquid_tpu/arrays/float_alp.py`).

Floats that are really scaled decimals are stored as bit-packed integers
enc = round(v * 10^e) minus a reference, plus exception patches (rows
that do not round-trip, kept exactly on the host).  The decode map
off -> (off + ref) * 10^-e is monotone, so a float comparison becomes an
offset threshold found on the host (`lower_bound`) and then a packed
bit-plane compare on the device.  The encoder is the reference's, line
for line, so the stored fields are identical.
"""
from __future__ import annotations

import numpy as np
import pyarrow as pa
import torch

from liquid_tpu_torch.arrays.base import (
    BLOCK_ROWS, LiquidArray, Predicate, const_words, pack_validity,
    validity_mask_or_full,
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
        if pred.op not in ("eq", "ne", "lt", "lt_eq", "gt", "gt_eq"):
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
            t_ge = self.lower_bound(lit, strict=False)
            t_gt = self.lower_bound(lit, strict=True)
            lt_ge = self._off_lt(planes, t_ge, device)
            lt_gt = self._off_lt(planes, t_gt, device)
            bits = {"lt": lambda: lt_ge, "lt_eq": lambda: lt_gt,
                    "gt": lambda: ~lt_gt, "gt_eq": lambda: ~lt_ge,
                    "eq": lambda: ~lt_ge & lt_gt,
                    "ne": lambda: lt_ge | ~lt_gt}[op]()
        if self.num_patches:
            fns = {"eq": np.equal, "ne": np.not_equal, "lt": np.less,
                   "lt_eq": np.less_equal, "gt": np.greater,
                   "gt_eq": np.greater_equal}
            # SQL promotes an f32 column to f64 before comparing
            pv = self.patch_vals
            if pa.types.is_float32(self._arrow_type):
                pv = pv.astype(np.float32).astype(np.float64)
            verdict = fns[op](pv, np.float64(lit))
            if pred.keep_nan:
                verdict = verdict | np.isnan(pv)  # NaN lives in patches
            host = words_to_numpy(bits).copy()
            words = self.patch_idx // 32
            set_bits = np.uint32(1) << (self.patch_idx % 32).astype(np.uint32)
            np.bitwise_and.at(host, words, ~set_bits)
            np.bitwise_or.at(host, words, np.where(verdict, set_bits,
                                                   np.uint32(0)))
            bits = words_to_tensor(host, device)
        return mops.BoolMask(bits, validity_mask_or_full(
            self.validity_np, self.length, device))

    def _off_lt(self, planes, t: int, device):
        max_off = (1 << self.width) - 1 if self.width else 0
        if t <= 0:
            return const_words(False, device)
        if t > max_off:
            return const_words(True, device)
        return bp.cmp_const(planes, t)[0]
