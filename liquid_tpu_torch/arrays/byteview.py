"""Dictionary-encoded string / binary blocks with an FSST-compressed
backing (port of `liquid_tpu/arrays/byteview.py`).

One code per row indexes the block's dictionary.  The codes and the
validity words are host numpy (the reference's exact values) until a
caller asks for them on a device; the dictionary, irregular bytes, stays
on the host.  A predicate is decided once per distinct value (a verdict
over the dictionary), and the row mask is one device gather
`verdict[codes]` packed into words, so the per-row cost does not depend
on string length.  The dictionary has two backings:

- raw: a pyarrow array; verdicts run through pyarrow's compute kernels;
- fsst: native-FSST-compressed bytes (`arrays/fsst.py`) plus
  order-preserving prefix keys and the shared prefix
  (`arrays/prefixkeys.py`); verdicts settle on the prefix keys and
  decompress only the ambiguous entries.

Substring fingerprints (a 32-bit character-class mask per dictionary
entry) prune `contains` candidates before any decompression.  The
serialized (`to_bytes`) and squeezed forms belong to the IPC and hybrid
encodings, which are not ported yet, and raise NotImplementedError.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import torch

from liquid_tpu_torch.arrays import prefixkeys as pk
from liquid_tpu_torch.arrays.base import (
    BLOCK_ROWS, LiquidArray, Predicate, pack_validity,
)
from liquid_tpu_torch.device import words_to_tensor
from liquid_tpu_torch.ops import mask as mops

#: dictionaries at least this large get FSST-compressed on transcode
FSST_THRESHOLD_BYTES = 2048

#: dictionary entries fully compared (decompressed) during predicate
#: evaluation (instrumentation read by tests)
FULL_COMPARE_COUNTER = 0


def is_supported_type(t: pa.DataType) -> bool:
    return (pa.types.is_string(t) or pa.types.is_large_string(t)
            or pa.types.is_binary(t) or pa.types.is_large_binary(t)
            or pa.types.is_string_view(t) or pa.types.is_binary_view(t)
            or pa.types.is_dictionary(t))


def _fingerprints(dict_values: pa.Array) -> np.ndarray:
    """Per entry: bit (byte % 32) set for every byte it holds (a needle's
    buckets must all be present for the entry to contain it)."""
    buf = dict_values.cast(pa.large_binary())
    offsets = np.frombuffer(buf.buffers()[1], dtype=np.int64,
                            count=len(buf) + 1, offset=buf.offset * 8)
    data = np.frombuffer(buf.buffers()[2] or b"", dtype=np.uint8)
    bits = np.uint32(1) << (data % np.uint8(32)).astype(np.uint32)
    # segment OR via reduceat (empty strings stay 0); one zero byte of
    # padding keeps an offset equal to data.size a valid index
    out = np.zeros(len(buf), dtype=np.uint32)
    nonempty = offsets[1:] > offsets[:-1]
    if data.size:
        bits_p = np.concatenate([bits, np.zeros(1, np.uint32)])
        ors = np.bitwise_or.reduceat(bits_p, offsets[:-1])
        out[nonempty] = ors[nonempty]
    return out


def _needle_fingerprint(needle: bytes) -> int:
    fp = 0
    for b in needle:
        fp |= 1 << (b % 32)
    return fp


def _as_bytes(lit) -> Optional[bytes]:
    if isinstance(lit, str):
        return lit.encode()
    if isinstance(lit, bytes):
        return lit
    return None


class LiquidByteViewArray(LiquidArray):
    """One 8192-row block of a string column: codes + dictionary."""

    def __init__(self, codes: np.ndarray, dictionary: Optional[pa.Array],
                 validity: Optional[np.ndarray], length: int,
                 arrow_type: pa.DataType,
                 fingerprints: Optional[np.ndarray] = None,
                 fsst=None, prefix_meta: Optional[pk.PrefixMeta] = None):
        if dictionary is None and fsst is None:
            raise ValueError("a byte-view block needs a raw or FSST "
                             "dictionary")
        self.codes_np = codes           # int32[BLOCK_ROWS] dictionary codes
        self._dict_raw = dictionary     # pa.Array | None when FSST-backed
        self.fsst = fsst                # arrays.fsst.FsstBuffer | None
        self.prefix_meta = prefix_meta  # set when FSST-backed
        self.validity_np = validity     # uint32[256] | None
        self.length = length
        self._arrow_type = arrow_type
        self._fingerprints = fingerprints
        #: (op, literal) -> bool[dict] verdict, kept per block
        self._verdict_cache: dict = {}

    @classmethod
    def from_arrow(cls, arr: pa.Array, with_fingerprints: bool = False,
                   compressor=None, compress: str = "auto"
                   ) -> "LiquidByteViewArray":
        if len(arr) > BLOCK_ROWS:
            raise ValueError(f"{len(arr)} rows > {BLOCK_ROWS}")
        t = arr.type
        logical = t
        if pa.types.is_dictionary(t):
            denc = arr
            logical = t.value_type
        else:
            denc = pc.dictionary_encode(arr)
        length = len(arr)
        dict_values = denc.dictionary
        idx = denc.indices
        if idx.null_count:
            valid = np.asarray(idx.is_valid())
            codes_np = np.asarray(idx.fill_null(0)).astype(np.int32)
        else:
            valid = None
            codes_np = np.asarray(idx).astype(np.int32)
        codes = np.zeros(BLOCK_ROWS, dtype=np.int32)
        codes[:length] = codes_np
        fps = _fingerprints(dict_values) if with_fingerprints else None

        dict_bytes = sum(b.size for b in dict_values.buffers() if b is not None)
        use_fsst = (compress == "always"
                    or (compress == "auto"
                        and (compressor is not None
                             or dict_bytes >= FSST_THRESHOLD_BYTES)))
        if use_fsst and len(dict_values):
            from liquid_tpu_torch.arrays.fsst import FsstBuffer
            meta = pk.build_prefix_meta(dict_values)
            buf = FsstBuffer.from_arrow(dict_values, compressor)
            return cls(codes, None, pack_validity(valid, length), length,
                       logical, fps, fsst=buf, prefix_meta=meta)
        return cls(codes, dict_values, pack_validity(valid, length), length,
                   logical, fps)

    # -- LiquidArray ---------------------------------------------------------

    @property
    def arrow_type(self) -> pa.DataType:
        return self._arrow_type

    @property
    def is_fsst(self) -> bool:
        return self.fsst is not None and self._dict_raw is None

    @property
    def fingerprints(self) -> Optional[np.ndarray]:
        return self._fingerprints

    @property
    def dictionary(self) -> pa.Array:
        """Dictionary values; decompresses when FSST-backed (the full
        decode path -- predicates avoid it)."""
        if self._dict_raw is not None:
            return self._dict_raw
        vt = self._arrow_type
        if pa.types.is_dictionary(vt):
            vt = vt.value_type
        if not (pa.types.is_binary(vt) or pa.types.is_large_binary(vt)
                or pa.types.is_string(vt) or pa.types.is_large_string(vt)):
            vt = pa.large_binary()
        return self.fsst.to_arrow(vt)

    @property
    def dict_size(self) -> int:
        if self._dict_raw is not None:
            return len(self._dict_raw)
        return len(self.fsst)

    def memory_bytes(self) -> int:
        n = self.codes_np.size * 4
        if self.validity_np is not None:
            n += self.validity_np.size * 4
        if self.is_fsst:
            n += self.fsst.memory_bytes()
            n += (self.prefix_meta.prefixes.nbytes
                  + self.prefix_meta.rest_lens.nbytes)
            n += len(self.prefix_meta.shared)
        else:
            n += sum(b.size for b in self._dict_raw.buffers()
                     if b is not None)
        if self._fingerprints is not None:
            n += self._fingerprints.nbytes
        return n + 64

    def to_device(self, device) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(codes int32[BLOCK_ROWS], packed validity int32[256] or None)."""
        codes = torch.from_numpy(self.codes_np).to(device)
        valid = (None if self.validity_np is None
                 else words_to_tensor(self.validity_np, device))
        return codes, valid

    def to_arrow(self) -> pa.Array:
        codes = self.codes_np[: self.length]
        if self.validity_np is not None:
            valid = mops.unpack_bits_host(self.validity_np)[: self.length]
            idx = pa.array(codes, type=pa.int32(), mask=~valid)
        else:
            idx = pa.array(codes, type=pa.int32())
        return pa.DictionaryArray.from_arrays(idx, self.dictionary)

    def to_arrow_flat(self) -> pa.Array:
        return self.to_arrow().cast(self._arrow_type)

    # -- encoded predicate evaluation ------------------------------------------

    def _dict_verdict_raw(self, pred: Predicate, d: pa.Array
                          ) -> Optional[np.ndarray]:
        """Predicate over raw dictionary entries via pyarrow kernels."""
        lit = pred.literal
        lit_b = _as_bytes(lit)
        if lit_b is None:
            return None
        op = pred.op
        pat = lit if isinstance(lit, str) else lit_b.decode("utf-8", "replace")
        if op in ("contains", "not_contains"):
            if self._fingerprints is not None and len(lit_b) > 0:
                need = np.uint32(_needle_fingerprint(lit_b))
                candidates = (self._fingerprints & need) == need
                verdict = np.zeros(len(d), dtype=bool)
                if candidates.any():
                    cand_idx = np.flatnonzero(candidates)
                    sub = d.take(pa.array(cand_idx))
                    verdict[cand_idx] = np.asarray(
                        pc.match_substring(sub, pat).fill_null(False))
            else:
                verdict = np.asarray(pc.match_substring(d, pat).fill_null(False))
            return ~verdict if op == "not_contains" else verdict
        if op == "starts_with":
            return np.asarray(pc.starts_with(d, pat).fill_null(False))
        if op == "ends_with":
            return np.asarray(pc.ends_with(d, pat).fill_null(False))
        fns = {"eq": pc.equal, "ne": pc.not_equal, "lt": pc.less,
               "lt_eq": pc.less_equal, "gt": pc.greater,
               "gt_eq": pc.greater_equal}
        if op not in fns:
            return None
        lit_arr = (pa.scalar(lit_b, type=d.type) if pa.types.is_binary(d.type)
                   else pa.scalar(lit, type=d.type))
        return np.asarray(fns[op](d, lit_arr).fill_null(False))

    def _settle_ambiguous(self, op: str, lit_b: bytes,
                          amb_idx: np.ndarray) -> np.ndarray:
        """Exact compare of the ambiguous entries: decompress only those."""
        global FULL_COMPARE_COUNTER
        FULL_COMPARE_COUNTER += len(amb_idx)
        vals: List[bytes] = self.fsst.take_bytes(amb_idx)
        tests = {"eq": lambda v: v == lit_b, "ne": lambda v: v != lit_b,
                 "lt": lambda v: v < lit_b, "lt_eq": lambda v: v <= lit_b,
                 "gt": lambda v: v > lit_b, "gt_eq": lambda v: v >= lit_b,
                 "contains": lambda v: lit_b in v,
                 "not_contains": lambda v: lit_b not in v,
                 "starts_with": lambda v: v.startswith(lit_b),
                 "ends_with": lambda v: v.endswith(lit_b)}
        return np.array([tests[op](v) for v in vals], dtype=bool)

    def _dict_verdict_fsst(self, pred: Predicate) -> Optional[np.ndarray]:
        lit_b = _as_bytes(pred.literal)
        if lit_b is None:
            return None
        op = pred.op
        if op == "ends_with" and self._fingerprints is not None and lit_b:
            # the fingerprint prune applies to any containment shape
            need = np.uint32(_needle_fingerprint(lit_b))
            candidates = (self._fingerprints & need) == need
            verdict = np.zeros(self.dict_size, dtype=bool)
            idx = np.flatnonzero(candidates)
            if len(idx):
                verdict[idx] = self._settle_ambiguous(op, lit_b, idx)
            return verdict
        needle_fp = _needle_fingerprint(lit_b) if lit_b else 0
        verdict, amb = pk.prefix_verdict(self.prefix_meta, op, lit_b,
                                         self._fingerprints, needle_fp)
        if verdict is None:
            # no prefix / fingerprint route: decompress once, raw path
            return self._dict_verdict_raw(pred, self.dictionary)
        amb_idx = np.flatnonzero(amb)
        if len(amb_idx):
            verdict = verdict.copy()
            verdict[amb_idx] = self._settle_ambiguous(op, lit_b, amb_idx)
        return verdict

    def _dict_verdict(self, pred: Predicate) -> Optional[np.ndarray]:
        if self.is_fsst:
            return self._dict_verdict_fsst(pred)
        return self._dict_verdict_raw(pred, self._dict_raw)

    def dict_verdict(self, pred: Predicate) -> Optional[np.ndarray]:
        """bool[dict_size] verdict of `pred` per dictionary entry, cached
        per (op, literal); None when the predicate has no verdict form."""
        key = (pred.op, pred.literal)
        verdict = self._verdict_cache.get(key)
        if verdict is None:
            verdict = self._dict_verdict(pred)
            if verdict is not None:
                self._verdict_cache[key] = verdict
        return verdict

    def try_eval_predicate(self, pred: Predicate, device
                           ) -> Optional[mops.BoolMask]:
        """Packed row mask of `pred` on `device`, or None when the
        predicate has no verdict form."""
        verdict = self.dict_verdict(pred)
        if verdict is None:
            return None
        return self._mask_from_verdict(verdict, device)

    def _mask_from_verdict(self, verdict: np.ndarray, device
                           ) -> mops.BoolMask:
        """Per-dictionary-entry verdicts -> packed row mask (one gather)."""
        codes, valid = self.to_device(device)
        bits = verdict_gather(torch.from_numpy(verdict).to(device), codes)
        if valid is None:
            valid = words_to_tensor(mops.all_set_host(BLOCK_ROWS,
                                                      self.length), device)
        return mops.BoolMask(bits, valid)

    def to_bytes(self) -> bytes:
        raise NotImplementedError("byte-view IPC serialization is not "
                                  "ported yet")

    def squeeze(self):
        raise NotImplementedError("the squeezed (hybrid) byte-view form is "
                                  "not ported yet")


def verdict_gather(verdict: torch.Tensor, codes: torch.Tensor
                   ) -> torch.Tensor:
    """bool[dict] verdict, int32[N] codes -> packed int32[N/32] row mask
    (one gather, then the bits packed into words)."""
    return mops.pack_bools(verdict[codes.to(torch.int64)])


def _verdict_gather_many(verdicts: torch.Tensor, codes: torch.Tensor
                         ) -> torch.Tensor:
    """The row-group form: bool[B, max_dict] verdicts (each block's padded
    to the widest dictionary) and int32[B, N] codes -> packed int32[B,
    N/32] row masks from one gather."""
    return mops.pack_bools(torch.gather(verdicts, 1, codes.to(torch.int64)))
