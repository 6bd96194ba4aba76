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
(`bitpack_cuda.cmp_const_many`) on the card; a single block's compare
is the same kernel at B = 1.  `in_range` is K1's interval form over a
column's blocks.  `pack_bitplanes` / `unpack_bitplanes` are the tensor
twins of the host functions, on the tensor's device.
"""
from __future__ import annotations

import numpy as np
import torch

from liquid_tpu_torch.device import WORD_BITS, srl, to_i32_bits, wrap_i64
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
    -> uint32[bucket(width), N/32], the reference's layout bit for bit:
    each value's bytes unpacked to bits (LSB first), transposed, and each
    plane's bits packed back into words."""
    v = np.ascontiguousarray(values, dtype=np.uint64)
    n = v.shape[0]
    assert n % WORD_BITS == 0, n
    bucket = bucket_for(width)
    if bucket == 0:
        return np.zeros((0, n // WORD_BITS), dtype=np.uint32)
    by = v.view(np.uint8).reshape(n, 8)[:, :(bucket + 7) // 8]
    bits = np.unpackbits(by, axis=1, bitorder="little")[:, :bucket]
    return np.packbits(np.ascontiguousarray(bits.T), axis=1,
                       bitorder="little").view(np.uint32)


def unpack_bitplanes_host(planes, out_dtype=None) -> np.ndarray:
    """uint32[bucket, W] -> uint64[W*32] (or `out_dtype`): the planes'
    bits unpacked, every eight planes summed into one byte of each
    value."""
    p = np.ascontiguousarray(planes, dtype=np.uint32)
    bucket, w = p.shape
    n = w * WORD_BITS
    if bucket == 0:
        return np.zeros(n, dtype=out_dtype or np.uint64)
    nb = (bucket + 7) // 8
    bits = np.zeros((nb * 8, n), dtype=np.uint8)
    bits[:bucket] = np.unpackbits(p.view(np.uint8), axis=1, bitorder="little")
    by = (bits.reshape(nb, 8, n) * _BYTE_WEIGHTS[None, :, None]).sum(
        axis=1, dtype=np.uint8)
    out = np.zeros((n, 8), dtype=np.uint8)
    out[:, :nb] = by.T
    out = out.view("<u8").reshape(n)
    return out if out_dtype is None else out.astype(out_dtype)


_BYTE_WEIGHTS = np.uint8(1) << np.arange(8, dtype=np.uint8)


def pack_bitplanes(values: torch.Tensor, width: int) -> torch.Tensor:
    """Unsigned values[N] (N % 32 == 0; an int64 tensor holds u64 bit
    images; bits at or above `width` zero) -> int32[bucket(width), N/32]
    on the values' device, the layout of `pack_bitplanes_host` bit for
    bit (reference `:69-80`)."""
    n = values.shape[0]
    assert n % WORD_BITS == 0, n
    bucket = bucket_for(width)
    v = values.to(torch.int64).reshape(n // WORD_BITS, WORD_BITS)
    lane = torch.arange(WORD_BITS, dtype=torch.int64, device=values.device)
    planes = [((v >> b) & 1) << lane for b in range(bucket)]
    if not planes:
        return torch.zeros((0, n // WORD_BITS), dtype=torch.int32,
                           device=values.device)
    return to_i32_bits(torch.stack(planes).sum(-1))


def unpack_bitplanes(planes: torch.Tensor, out_dtype=torch.int64
                     ) -> torch.Tensor:
    """int32[bucket, W] -> out_dtype[W*32] values (int64: the u64 bit
    images) on the planes' device (reference `:128-140`); `out_dtype` as
    in `unpack_bitplanes_many`."""
    return unpack_bitplanes_many(planes[None], out_dtype)[0]


def unpack_bitplanes_many(planes_stack: torch.Tensor, out_dtype=torch.int64
                          ) -> torch.Tensor:
    """int32[B, w, W] -> out_dtype[B, W*32] offsets, by default int64:
    the bit image of the reference's u64 values.  `out_dtype` is a torch
    dtype or one of the reference's numpy / JAX dtypes, converted as its
    `astype` converts them (`_values_as`); tensors here hold no unsigned
    integer wider than a byte, so uint16 / uint32 / uint64 come back as
    the bit image of the reference's values in the signed type of their
    width.  Accumulates plane by plane: the reference's [B, w, W, 32]
    broadcast would need gigabytes at SF1."""
    bsz, width, w_words = planes_stack.shape
    dev = planes_stack.device
    acc = torch.zeros((bsz, w_words, WORD_BITS), dtype=torch.int64,
                      device=dev)
    shifts = torch.arange(WORD_BITS, dtype=torch.int32, device=dev)
    for b in range(width):
        bits = (planes_stack[:, b, :, None] >> shifts) & 1
        acc |= bits.to(torch.int64) << b
    return _values_as(acc.reshape(bsz, w_words * WORD_BITS), out_dtype)


_SIGNED_OF = {8: torch.int8, 16: torch.int16, 32: torch.int32,
              64: torch.int64}
_FLOAT_OF = {16: torch.float16, 32: torch.float32, 64: torch.float64}


def _values_as(images: torch.Tensor, out_dtype) -> torch.Tensor:
    """u64 values held as int64 bit images -> `out_dtype` (a torch dtype,
    or a numpy / JAX dtype), as the reference's `unpack_bitplanes` gives
    them: an integer is the value's low bits (uint8 exactly, a wider
    unsigned type as its signed bit image); a bool or float narrower than
    eight bytes is taken from the value's low 32 bits, since the
    reference accumulates those in uint32, and a float64 from all 64."""
    if isinstance(out_dtype, torch.dtype):
        out_dtype = torch.empty(0, dtype=out_dtype).numpy().dtype
    dt = np.dtype(out_dtype)
    bits = dt.itemsize * 8
    if dt.kind == "b":
        return (images & 0xFFFFFFFF) != 0
    if dt.kind in "ui":
        if bits == 64:
            return images
        low = images & ((1 << bits) - 1)
        if dt == np.uint8:
            return low.to(torch.uint8)
        half = 1 << (bits - 1)
        return ((low ^ half) - half).to(_SIGNED_OF[bits])
    if dt.kind != "f" or bits not in _FLOAT_OF:
        raise ValueError(f"unpack to {dt}: not an integer, float or bool")
    if bits < 64:
        return (images & 0xFFFFFFFF).to(_FLOAT_OF[bits])
    # the high word scaled by 2^32 is exact: the sum rounds once
    return (srl(images, 32).to(torch.float64) * 2.0 ** 32
            + (images & 0xFFFFFFFF).to(torch.float64))


def cmp_const(planes: torch.Tensor, c: int):
    """Compare one packed block (int32[w, 256]) against an unsigned
    constant c in [0, 2^64) -> packed (lt, eq).  gt = ~(lt | eq).  Runs
    K1's single form at B = 1 (`bitpack_cuda.cmp_const_many`): the kernel
    on a CUDA tensor, its plain version on a CPU tensor."""
    c = int(c)
    assert 0 <= c < (1 << 64), c
    cs = torch.tensor([wrap_i64(c)], dtype=torch.int64, device=planes.device)
    lt, eq = bitpack_cuda.cmp_const_many(planes[None], cs)
    return lt[0], eq[0]


def in_range(planes: torch.Tensor, lo_hi) -> torch.Tensor:
    """Packed int32[W] mask of lo <= value <= hi for one column's planes
    int32[w, W] (unsigned lo, hi in [0, 2^64)): K1's interval form, one
    launch over the column's 256-word blocks, the last one zero-padded
    (reference `:205-211`)."""
    width, n_words = planes.shape
    nb = max(1, -(-n_words // bitpack_cuda.BLOCK_WORDS))
    flat = torch.zeros((width, nb * bitpack_cuda.BLOCK_WORDS),
                       dtype=torch.int32, device=planes.device)
    flat[:, :n_words] = planes
    stack = flat.reshape(width, nb, bitpack_cuda.BLOCK_WORDS).transpose(
        0, 1).contiguous()
    lo, hi = (torch.full((nb,), wrap_i64(int(c)), dtype=torch.int64,
                         device=planes.device) for c in lo_hi)
    return bitpack_cuda.in_interval_many(stack, lo, hi).reshape(-1)[
        :n_words]


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
