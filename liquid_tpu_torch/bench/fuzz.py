"""Differential fuzz cases for the encoded compares (port of the
generators and pyarrow comparisons of the reference's
`tests/test_fuzz_differential.py:37-133`, kept in the package so that
the card runs them without the test tree).

- `check_case(seed, device)`: random strings (NULLs, empty strings,
  shared prefixes, multi-byte UTF-8) in a `LiquidByteViewArray` with or
  without fingerprints, four random compares or substring tests against a
  needle drawn from the values or at random.
- `check_primitive_case(seed, device)`: random int64 values with NULLs
  in a `LiquidPrimitiveArray` (bit-plane compares: K1's single form on
  the card), four compares against literals inside, at and outside the
  value range.

Each compare's row mask must equal pyarrow compute's on the same array:
the same NULL rows, the same truth value on every other row.  A
divergence raises AssertionError naming the seed, the op and the literal;
each function returns its compares as (op, literal, bits, valid) with
bool[n] rows.  Both draw from `np.random.default_rng(seed)` exactly as
the reference does, so a seed names the same case in both packages.
`fuzz/fuzz_byteview_torch.py` runs the open-ended loop.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

OPS = ["eq", "ne", "lt", "lt_eq", "gt", "gt_eq",
       "contains", "not_contains", "starts_with", "ends_with"]

_PC = {
    "eq": pc.equal, "ne": pc.not_equal, "lt": pc.less, "lt_eq": pc.less_equal,
    "gt": pc.greater, "gt_eq": pc.greater_equal,
    "contains": pc.match_substring,
    "not_contains": lambda a, n: pc.invert(pc.match_substring(a, n)),
    "starts_with": pc.starts_with, "ends_with": pc.ends_with,
}

#: the integer compares of `check_primitive_case`, in the reference's order
INT_OPS = ["eq", "ne", "lt", "lt_eq", "gt", "gt_eq"]

ALPHABETS = [
    list("ab"),                          # heavy prefix sharing
    list("abcdefgh \t"),                 # small
    [chr(c) for c in range(33, 127)],    # printable ascii
    list("日本語中文한국어αβγ"),           # multi-byte utf-8
]

Compare = Tuple[str, object, np.ndarray, np.ndarray]


def random_strings(rng, n, max_len=24):
    alphabet = ALPHABETS[int(rng.integers(0, len(ALPHABETS)))]
    shared = "".join(rng.choice(alphabet, int(rng.integers(0, 9))))
    out = []
    for _ in range(n):
        r = rng.random()
        if r < 0.05:
            out.append(None)
        elif r < 0.10:
            out.append("")
        else:
            ln = int(rng.integers(0, max_len))
            out.append(shared + "".join(rng.choice(alphabet, ln)))
    return out


def pick_needle(rng, values):
    present = [v for v in values if v]
    r = rng.random()
    if r < 0.4 and present:
        v = present[int(rng.integers(0, len(present)))]
        if rng.random() < 0.5 or len(v) < 2:
            return v  # exact value
        a = int(rng.integers(0, len(v)))
        b = int(rng.integers(a, len(v) + 1))
        return v[a:b]  # substring of a value
    alphabet = ALPHABETS[int(rng.integers(0, len(ALPHABETS)))]
    return "".join(rng.choice(alphabet, int(rng.integers(0, 8))))


def byteview_case(seed: int):
    """-> (string array, with_fingerprints, [(op, needle)]) of a seed; an
    empty needle's substring test is left out, as in the reference."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 2000))
    vals = random_strings(rng, n)
    with_fp = bool(rng.random() < 0.5)
    preds = []
    for _ in range(4):
        op = OPS[int(rng.integers(0, len(OPS)))]
        needle = pick_needle(rng, vals)
        if not needle and op in ("contains", "not_contains"):
            continue  # empty needle: degenerate, DataFusion rejects it
        preds.append((op, needle))
    return pa.array(vals, pa.string()), with_fp, preds


def primitive_case(seed: int):
    """-> (int64 array with NULLs, [(op, literal)]) of a seed."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 3000))
    lo = int(rng.integers(-1_000_000, 1_000_000))
    span = int(rng.integers(1, 1 << int(rng.integers(1, 40))))
    vals = rng.integers(lo, lo + span, n)
    nulls = rng.random(n) < 0.1
    arr = pa.array(np.where(nulls, 0, vals), pa.int64())
    arr = pc.if_else(pa.array(~nulls), arr, pa.scalar(None, pa.int64()))
    preds = []
    for _ in range(4):
        op = INT_OPS[int(rng.integers(0, 6))]
        # literal: in range, out of range, or an exact value
        if rng.random() < 0.5:
            lit = int(vals[int(rng.integers(0, n))])
        else:
            lit = int(rng.integers(lo - span, lo + 2 * span))
        preds.append((op, lit))
    return arr, preds


def _rows(mask, n: int) -> Tuple[np.ndarray, np.ndarray]:
    from liquid_tpu_torch.ops import mask as mops
    bits = mops.unpack_bits(mask.bits).cpu().numpy()[:n]
    valid = mops.unpack_bits(mask.valid).cpu().numpy()[:n]
    return bits, valid


def _check(seed: int, liquid, arr: pa.Array, preds, pcs, device
           ) -> List[Compare]:
    from liquid_tpu_torch.arrays.base import Predicate
    out = []
    for op, lit in preds:
        got = liquid.try_eval_predicate(Predicate(op, lit), device)
        assert got is not None, f"seed={seed} op={op} literal={lit!r}: " \
            f"no encoded evaluation"
        bits, valid = _rows(got, len(arr))
        expect = pcs[op](arr, lit)
        evalid = np.asarray(pc.is_valid(expect))
        ebits = np.asarray(expect.fill_null(False))
        assert (valid == evalid).all(), \
            f"seed={seed} op={op} literal={lit!r}: validity diverged"
        assert (bits[evalid] == ebits[evalid]).all(), \
            f"seed={seed} op={op} literal={lit!r}: rows " \
            f"{np.flatnonzero(bits[evalid] != ebits[evalid])[:5]}"
        out.append((op, lit, bits, valid))
    return out


def check_case(seed: int, device) -> List[Compare]:
    """Byte-view compares of one seed on `device` against pyarrow."""
    from liquid_tpu_torch.arrays.byteview import LiquidByteViewArray
    arr, with_fp, preds = byteview_case(seed)
    liquid = LiquidByteViewArray.from_arrow(arr, with_fingerprints=with_fp)
    return _check(seed, liquid, arr, preds, _PC, device)


def check_primitive_case(seed: int, device) -> List[Compare]:
    """Bit-plane integer compares of one seed on `device` against
    pyarrow."""
    from liquid_tpu_torch.arrays.primitive import LiquidPrimitiveArray
    arr, preds = primitive_case(seed)
    liquid = LiquidPrimitiveArray.from_arrow(arr)
    return _check(seed, liquid, arr, preds, _PC, device)
