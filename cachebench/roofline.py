"""The card's peaks and the bytes each hand-written kernel must move, kept
with the benchmark so that a roofline reads the same work whatever
implements the kernel.  Each input byte is counted read once and each
output byte written once.
"""
from __future__ import annotations

#: NVIDIA H100 SXM data sheet: HBM3 bandwidth at the 700 W limit
HBM_BYTES_PER_S = 3.35e12


def k1_bytes(blocks: int, width: int, interval: bool) -> int:
    """K1 (`ops/csrc/cmp_const_many.cu`) over `blocks` packed blocks of
    `width` bit planes of 256 words: the planes and the per-block
    constants read (two for the interval form), the masks written (one
    for the interval form, lt and eq for the single form)."""
    planes = blocks * width * 256 * 4
    if interval:
        return planes + 2 * blocks * 8 + blocks * 256 * 4
    return planes + blocks * 8 + 2 * blocks * 256 * 4


def k2_bytes(slot_bytes: int, col_bytes: int, m: int, cols: int) -> int:
    """K2 (`ops/csrc/group_accumulate.cu`): the slots and the value columns
    read, the (m + 1)-entry u64 table of each column written."""
    return slot_bytes + col_bytes + 8 * (m + 1) * cols


def share_pct(nbytes: int, seconds: float):
    """The least time the bytes take at the HBM peak, as a percentage of
    the kernel time; None where nothing ran."""
    if nbytes <= 0 or seconds <= 0:
        return None
    return 100.0 * nbytes / HBM_BYTES_PER_S / seconds
