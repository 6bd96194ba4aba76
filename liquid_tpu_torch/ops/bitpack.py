"""Bit-plane packing and packed-domain compares (port of
`liquid_tpu/ops/bitpack.py`).

For bit-width w over N rows, `planes[b]` packs bit b of rows 32j..32j+31
into word j (LSB first).  A compare against a constant runs MSB-first
over the planes with three word operations per plane and never decodes.
Physical plane counts are quantised to WIDTH_BUCKETS (zero planes above
the logical width are transparent), exactly as in the reference, so the
stored format is identical.

Device words are int32 tensors with the reference's uint32 bits;
constants are u64 values carried as int64 bit images.  The batched
compare with per-block constants runs the hand-written CUDA kernel
(`bitpack_cuda.cmp_const_many`) on the card.
"""
from __future__ import annotations

import numpy as np
import torch

from liquid_tpu_torch.device import FULL, WORD_BITS
from liquid_tpu_torch.ops import bitpack_cuda

#: Physical plane-count buckets (identical to the reference's).
WIDTH_BUCKETS = (0, 1, 2, 3, 4, 5, 6, 8, 10, 12, 14, 16, 20, 24, 28, 32,
                 40, 48, 56, 64)


def bucket_for(width: int) -> int:
    for b in WIDTH_BUCKETS:
        if b >= width:
            return b
    raise ValueError(f"width {width} > 64")


def bit_width_for(max_value: int) -> int:
    """Minimal bit-width to represent values in [0, max_value]."""
    if max_value <= 0:
        return 0
    return int(max_value).bit_length()


def pack_bitplanes_host(values, width: int) -> np.ndarray:
    """Unsigned values[N] (N % 32 == 0; bits at or above `width` zero)
    -> uint32[bucket(width), N/32], the reference's layout bit for bit."""
    v = np.asarray(values, dtype=np.uint64)
    n = v.shape[0]
    assert n % WORD_BITS == 0, n
    bucket = bucket_for(width)
    w = n // WORD_BITS
    if bucket == 0:
        return np.zeros((0, w), dtype=np.uint32)
    vw = v.reshape(w, WORD_BITS)
    lane = np.uint32(1) << np.arange(WORD_BITS, dtype=np.uint32)
    out = np.empty((bucket, w), dtype=np.uint32)
    for b in range(bucket):
        bits = ((vw >> np.uint64(b)) & np.uint64(1)).astype(np.uint32)
        out[b] = (bits * lane).sum(axis=1, dtype=np.uint32)
    return out


def unpack_bitplanes_host(planes) -> np.ndarray:
    """uint32[bucket, W] -> uint64[W*32]."""
    p = np.asarray(planes, dtype=np.uint32)
    bucket, w = p.shape
    n = w * WORD_BITS
    if bucket == 0:
        return np.zeros(n, dtype=np.uint64)
    shifts = np.arange(WORD_BITS, dtype=np.uint32)
    acc = np.zeros((w, WORD_BITS), dtype=np.uint64)
    for b in range(bucket):
        bits = (p[b][:, None] >> shifts[None, :]) & 1
        acc |= bits.astype(np.uint64) << np.uint64(b)
    return acc.reshape(n)


def unpack_bitplanes_many(planes_stack: torch.Tensor) -> torch.Tensor:
    """int32[B, w, W] -> int64[B, W*32] offsets (the int64 bit image of
    the reference's u64 values).  Accumulates plane by plane: the
    reference's [B, w, W, 32] broadcast would need gigabytes at SF1."""
    bsz, width, w_words = planes_stack.shape
    dev = planes_stack.device
    acc = torch.zeros((bsz, w_words, WORD_BITS), dtype=torch.int64,
                      device=dev)
    shifts = torch.arange(WORD_BITS, dtype=torch.int32, device=dev)
    for b in range(width):
        bits = (planes_stack[:, b, :, None] >> shifts) & 1
        acc |= bits.to(torch.int64) << b
    return acc.reshape(bsz, w_words * WORD_BITS)


def _bit_mask(c: int, b: int) -> int:
    return FULL if (c >> b) & 1 else 0


def cmp_const(planes: torch.Tensor, c: int):
    """Compare one packed column (int32[w, W]) against an unsigned
    constant c in [0, 2^64) -> packed (lt, eq).  gt = ~(lt | eq)."""
    bucket, n_words = planes.shape
    c = int(c)
    assert 0 <= c < (1 << 64), c
    lt = torch.zeros(n_words, dtype=torch.int32, device=planes.device)
    eq = torch.full((n_words,), FULL, dtype=torch.int32,
                    device=planes.device)
    for b in range(bucket - 1, -1, -1):   # MSB first
        pb, cb = planes[b], _bit_mask(c, b)
        lt = lt | (eq & ~pb & cb)
        eq = eq & ~(pb ^ cb)
    if bucket < 64 and c >> bucket:
        # constant bits above the stored width: every value is smaller
        lt = torch.full_like(lt, FULL)
        eq = torch.zeros_like(eq)
    return lt, eq


def combine_op(lt: torch.Tensor, eq: torch.Tensor, op: str) -> torch.Tensor:
    if op == "eq":
        return eq
    if op == "ne":
        return ~eq
    if op == "lt":
        return lt
    if op == "lt_eq":
        return lt | eq
    if op == "gt":
        return ~(lt | eq)
    if op == "gt_eq":
        return ~lt
    raise ValueError(f"unknown op {op}")


def cmp_const_op(planes: torch.Tensor, c: int, op: str) -> torch.Tensor:
    """Packed comparison against one constant -> one packed mask."""
    return combine_op(*cmp_const(planes, c), op)


def cmp_const_op_many(planes_stack: torch.Tensor, cs: torch.Tensor,
                      op: str) -> torch.Tensor:
    """Batched packed compare: planes int32[B, w, 256] (one 8192-row
    block per b), per-block constants cs int64[B] (u64 bit images)
    -> packed masks int32[B, 256].  Runs the CUDA kernel on the card."""
    return combine_op(*bitpack_cuda.cmp_const_many(planes_stack, cs), op)
