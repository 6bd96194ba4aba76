"""Prefix-key comparison machinery for dictionary values (host copy of
`liquid_tpu/arrays/prefixkeys.py`).

Each dictionary value keeps its first 8 bytes after a prefix shared by
all values as an order-preserving big-endian u64; most comparisons settle
on the prefix key alone, and only entries whose prefix ties the needle
are decompressed ("ambiguous").  A needle that disagrees with the shared
prefix settles the whole dictionary at once.  Substring needles prune
candidates with the 32-bit character-class fingerprints.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import pyarrow as pa

MAX_SHARED_PREFIX = 64


@dataclass
class PrefixMeta:
    shared: bytes            # prefix common to every value
    prefixes: np.ndarray     # uint64[dict]: first 8B after `shared`, BE, 0-pad
    rest_lens: np.ndarray    # int32[dict]: len(value) - len(shared)


def _offsets_data(values: pa.Array) -> Tuple[np.ndarray, np.ndarray]:
    d = values.cast(pa.large_binary())
    offsets = np.frombuffer(d.buffers()[1], dtype=np.int64, count=len(d) + 1,
                            offset=d.offset * 8)
    buf = d.buffers()[2]
    data = (np.frombuffer(buf, dtype=np.uint8) if buf is not None
            else np.zeros(0, np.uint8))
    return offsets, data


def _shared_prefix(offsets: np.ndarray, data: np.ndarray) -> bytes:
    """Common byte prefix of all values = common prefix of the
    bytewise-lexicographic min and max values (an O(n) scan over entries
    was the transcode hotspot; min/max reduce vectorizes it)."""
    n = len(offsets) - 1
    if n == 0:
        return b""
    lens = offsets[1:] - offsets[:-1]
    cap = min(int(lens.min()), MAX_SHARED_PREFIX)
    if cap <= 0:
        return b""
    # first `cap` bytes of every value as a [n, cap] matrix
    idx = offsets[:-1, None] + np.arange(cap)[None, :]
    mat = data[idx]
    lo = mat.min(axis=0)
    hi = mat.max(axis=0)
    same = lo == hi
    k = int(same.argmin()) if not same.all() else cap
    return mat[0, :k].tobytes()


def build_prefix_meta(values: pa.Array, with_shared: bool = True) -> PrefixMeta:
    offsets, data = _offsets_data(values)
    n = len(offsets) - 1
    shared = _shared_prefix(offsets, data) if (with_shared and n > 1) else b""
    s = len(shared)
    starts = offsets[:-1] + s
    lens = (offsets[1:] - starts).astype(np.int32)
    prefixes = np.zeros(n, dtype=np.uint64)
    for shift in range(8):  # vectorized over entries, 8 passes
        has = lens > shift
        idx = starts + shift
        if data.size:
            byte = np.where(has, data[np.clip(idx, 0, data.size - 1)], 0)
        else:
            byte = np.zeros(n, dtype=np.uint8)
        prefixes |= byte.astype(np.uint64) << np.uint64((7 - shift) * 8)
    return PrefixMeta(shared, prefixes, lens)


def _uniform(n: int, value: bool) -> Tuple[np.ndarray, np.ndarray]:
    return np.full(n, value, dtype=bool), np.zeros(n, dtype=bool)


def prefix_verdict(meta: PrefixMeta, op: str, lit_b: bytes,
                   fingerprints: Optional[np.ndarray] = None,
                   needle_fp=None
                   ) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
    """-> (verdict bool[dict], ambiguous bool[dict]) or (None, None) when
    the op can't use prefixes.  `ambiguous` entries need a full compare.
    """
    n = len(meta.prefixes)
    shared, p, ln = meta.shared, meta.prefixes, meta.rest_lens
    s = len(shared)

    if op in ("contains", "not_contains"):
        if fingerprints is None:
            return None, None
        need = np.uint32(needle_fp)
        candidates = (fingerprints & need) == need
        # fingerprint miss is definitive: cannot contain the needle
        verdict = ~candidates if op == "not_contains" else np.zeros(n, bool)
        return verdict, candidates

    if op == "starts_with":
        if len(lit_b) <= s:
            return _uniform(n, shared[:len(lit_b)] == lit_b)
        if not lit_b.startswith(shared):
            return _uniform(n, False)
        m = lit_b[s:]
        if len(m) <= 8:
            # value starts with needle iff rest starts with m: compare the
            # top len(m) bytes of the prefix key, and rest must be long enough
            sh = np.uint64((8 - len(m)) * 8)
            m_top = np.uint64(int.from_bytes(m.ljust(8, b"\0"), "big")) >> sh
            verdict = ((p >> sh) == m_top) & (ln >= len(m))
            return verdict, np.zeros(n, bool)
        sh = np.uint64(0)
        m_top = np.uint64(int.from_bytes(m[:8], "big"))
        cand = (p == m_top) & (ln >= len(m))
        return np.zeros(n, bool), cand

    if op in ("eq", "ne"):
        if len(lit_b) < s or not lit_b.startswith(shared[:len(lit_b)]):
            return _uniform(n, op == "ne")
        if not lit_b.startswith(shared):
            return _uniform(n, op == "ne")
        m = lit_b[s:]
        lit_prefix = np.uint64(int.from_bytes(m[:8].ljust(8, b"\0"), "big"))
        both_long = (ln > 8) & (len(m) > 8)
        prefix_eq = (p == lit_prefix) & ((ln == len(m)) | both_long)
        amb = prefix_eq & both_long
        verdict = prefix_eq & ~amb
        if op == "ne":
            verdict = ~prefix_eq | amb
            verdict &= ~amb
        return verdict, amb

    if op in ("lt", "lt_eq", "gt", "gt_eq"):
        # first settle against the shared prefix: if the needle deviates
        # from `shared` within the shared region, ALL values compare alike
        k = min(len(lit_b), s)
        if lit_b[:k] != shared[:k]:
            all_lt = shared[:k] < lit_b[:k]  # v < needle for every v
            if op in ("lt", "lt_eq"):
                return _uniform(n, all_lt)
            return _uniform(n, not all_lt)
        if len(lit_b) <= s:
            # needle is a prefix of `shared`: every value >= needle, equal
            # only when the value IS the needle (rest empty and s == len)
            is_needle = (ln == 0) & np.bool_(len(lit_b) == s)
            zeros = np.zeros(n, bool)
            if op == "lt":
                return zeros, zeros.copy()
            if op == "lt_eq":
                return is_needle & np.ones(n, bool), zeros
            if op == "gt":
                return ~(is_needle & np.ones(n, bool)), zeros
            return np.ones(n, bool), zeros  # gt_eq
        m = lit_b[s:]
        lit_prefix = np.uint64(int.from_bytes(m[:8].ljust(8, b"\0"), "big"))
        p_lt = p < lit_prefix
        p_gt = p > lit_prefix
        tie = ~p_lt & ~p_gt
        exact_tie = tie & (ln <= 8) & (len(m) <= 8)
        if op == "lt":
            verdict = p_lt | (exact_tie & (ln < len(m)))
        elif op == "lt_eq":
            verdict = p_lt | (exact_tie & (ln <= len(m)))
        elif op == "gt":
            verdict = p_gt | (exact_tie & (ln > len(m)))
        else:
            verdict = p_gt | (exact_tie & (ln >= len(m)))
        amb = tie & ~exact_tie
        return verdict, amb

    return None, None
