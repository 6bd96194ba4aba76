"""Packed selection masks (port of `liquid_tpu/ops/mask.py`).

A selection over an 8192-row block is 256 words (row r -> word r//32,
bit r%32, LSB first).  Device words are int32 tensors holding the
reference's uint32 bits (see `liquid_tpu_torch.device`); host twins stay
numpy uint32, bit-identical to the reference's.  Boolean algebra,
including Kleene AND/OR with null tracking, runs on the packed words.
`and_then` composes a selection with a mask over its selected rows and
`compact_indices` turns a selection into gather indices, both by a
prefix sum of the selection bits (reference `:219-260`).  Constructors
(`tail_mask`, `all_set`, `none_set`) take the device explicitly.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from liquid_tpu_torch.device import WORD_BITS, popcount32, to_i32_bits

BLOCK_ROWS = 8192  # canonical block size (the reference's batch size)


def num_words(n_rows: int) -> int:
    return (n_rows + WORD_BITS - 1) // WORD_BITS


def _bit_weights(device) -> torch.Tensor:
    return torch.ones(WORD_BITS, dtype=torch.int64, device=device) << \
        torch.arange(WORD_BITS, dtype=torch.int64, device=device)


def pack_bools(bools: torch.Tensor) -> torch.Tensor:
    """bool[..., N] -> int32[..., N/32] (N a multiple of 32)."""
    n = bools.shape[-1]
    assert n % WORD_BITS == 0, n
    b = bools.reshape(*bools.shape[:-1], n // WORD_BITS, WORD_BITS)
    words = (b.to(torch.int64) * _bit_weights(bools.device)).sum(-1)
    return to_i32_bits(words)


def unpack_bits(words: torch.Tensor) -> torch.Tensor:
    """int32[..., W] -> bool[..., W*32].  An arithmetic shift followed by
    `& 1` reads every bit correctly, so no mask is needed here."""
    shifts = torch.arange(WORD_BITS, dtype=torch.int32, device=words.device)
    bits = (words[..., None] >> shifts) & 1
    return bits.reshape(*words.shape[:-1], -1).to(torch.bool)


def pack_bools_host(bools: np.ndarray) -> np.ndarray:
    """Host twin of pack_bools: bool[N] -> uint32[N/32]."""
    b = np.asarray(bools, dtype=bool)
    n = b.shape[0]
    assert n % WORD_BITS == 0, n
    w = b.reshape(n // WORD_BITS, WORD_BITS).astype(np.uint32)
    weights = np.uint32(1) << np.arange(WORD_BITS, dtype=np.uint32)
    return (w * weights).sum(axis=1, dtype=np.uint32)


def unpack_bits_host(words: np.ndarray) -> np.ndarray:
    """Host twin of unpack_bits: uint32[W] -> bool[W*32]."""
    w = np.asarray(words, dtype=np.uint32)
    bits = (w[:, None] >> np.arange(WORD_BITS, dtype=np.uint32)) & 1
    return bits.reshape(-1).astype(bool)


@functools.lru_cache(maxsize=1024)
def all_set_host(n_rows: int, length=None) -> np.ndarray:
    """uint32 words with the first `length` bits set.  Read-only (cached)."""
    if length is None:
        length = n_rows
    w = num_words(n_rows)
    host = np.zeros(w, dtype=np.uint32)
    full_words = min(length // WORD_BITS, w)
    host[:full_words] = 0xFFFFFFFF
    rem = length - full_words * WORD_BITS
    if 0 < rem and full_words < w:
        host[full_words] = (1 << rem) - 1
    host.setflags(write=False)
    return host


def tail_mask(length, n_rows: int, *, device) -> torch.Tensor:
    """int32[num_words(n_rows)] with the first `length` bits set; `length`
    is an int or a 0-d integer tensor (reference `:69-80`)."""
    base = torch.arange(num_words(n_rows), dtype=torch.int64,
                        device=device) * WORD_BITS
    k = (torch.as_tensor(length, device=device).to(torch.int64) - base
         ).clamp(0, WORD_BITS)
    return to_i32_bits((torch.ones_like(k) << k) - 1)


def all_set(n_rows: int, length=None, *, device) -> torch.Tensor:
    """Selection of the first `length` rows (all `n_rows` by default)."""
    return tail_mask(n_rows if length is None else length, n_rows,
                     device=device)


def none_set(n_rows: int, *, device) -> torch.Tensor:
    return torch.zeros(num_words(n_rows), dtype=torch.int32, device=device)


def unpack_many(stacked: torch.Tensor) -> torch.Tensor:
    """int32[B, W] packed selections -> bool[B, W*32]."""
    return unpack_bits(stacked)


def and_(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a & b


def or_(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a | b


def not_(a: torch.Tensor) -> torch.Tensor:
    return ~a


def and_then(selection: torch.Tensor, filtered: torch.Tensor
             ) -> torch.Tensor:
    """`selection` (int32[W] over N rows, k set) with the rows cleared
    that `filtered` rejects: `filtered`'s first k bits belong, in order,
    to the selected rows.  A row's rank is the exclusive prefix sum of the
    selection bits, and it survives iff selection[r] & filtered[rank[r]]
    (reference `:219-237`)."""
    sel = unpack_bits(selection)
    filt = unpack_bits(filtered)
    rank = torch.cumsum(sel.to(torch.int32), 0) - 1
    take = filt[rank.clamp(0, filt.shape[0] - 1)]
    return pack_bools(sel & take)


def compact_indices(selection: torch.Tensor, n_rows: int):
    """Packed selection -> (int32[n_rows] gather indices, int32 0-d count
    k): indices[j] is the j-th selected row for j < k; the tail repeats
    the last selected row (0 when none), so gathers stay in bounds
    (reference `:240-260`)."""
    sel = unpack_bits(selection)[:n_rows]
    dev = selection.device
    pos = torch.cumsum(sel.to(torch.int32), 0) - 1
    k = pos[-1] + 1
    slot = torch.where(sel, pos.to(torch.int64), n_rows)
    out = torch.zeros(n_rows + 1, dtype=torch.int32, device=dev)
    out.scatter_(0, slot, torch.arange(n_rows, dtype=torch.int32,
                                       device=dev))
    out = out[:n_rows]
    last = out[(k - 1).clamp(min=0)]
    return torch.where(torch.arange(n_rows, device=dev) < k, out, last), k


def count(words: torch.Tensor) -> torch.Tensor:
    """Set bits over a packed mask -> int64 scalar tensor."""
    return popcount32(words).to(torch.int64).sum()


def count_many(stacked: torch.Tensor) -> torch.Tensor:
    """Set bits per row of packed masks int32[B, W] -> int64[B]."""
    return popcount32(stacked).to(torch.int64).sum(-1)


def _pad_words(bools: torch.Tensor) -> torch.Tensor:
    """bool[N] -> bool[32 * ceil(N / 32)], FALSE past N."""
    b = bools.to(torch.bool)
    pad = -b.shape[0] % WORD_BITS
    return torch.cat([b, b.new_zeros(pad)]) if pad else b


def count_host(words: np.ndarray) -> int:
    return int(np.unpackbits(np.asarray(words).view(np.uint8)).sum())


@dataclass(frozen=True)
class BoolMask:
    """Three-valued (Kleene) boolean column in packed form: `bits` is the
    truth value where `valid` is set; valid=0 rows are NULL."""

    bits: torch.Tensor   # int32[W]
    valid: torch.Tensor  # int32[W]; all-ones => no nulls

    @staticmethod
    def from_bools(bools: torch.Tensor, valid_bools=None) -> "BoolMask":
        """Packed from bool[N] truth values and their validity (None: no
        NULLs), on the tensors' device.  N need not be a multiple of 32:
        the rows past it pad as FALSE, valid where `valid_bools` is None
        and NULL otherwise (the reference asks for the padding)."""
        bits = pack_bools(_pad_words(bools))
        if valid_bools is None:
            return BoolMask(bits, torch.full_like(bits, -1))
        return BoolMask(bits, pack_bools(_pad_words(valid_bools)))

    def and_kleene(self, other: "BoolMask") -> "BoolMask":
        # false AND x = false; true AND null = null
        out_false = (self.valid & ~self.bits) | (other.valid & ~other.bits)
        out_true = (self.bits & self.valid) & (other.bits & other.valid)
        return BoolMask(out_true, out_true | out_false)

    def or_kleene(self, other: "BoolMask") -> "BoolMask":
        # true OR x = true; false OR null = null
        out_true = (self.bits & self.valid) | (other.bits & other.valid)
        out_false = (self.valid & ~self.bits) & (other.valid & ~other.bits)
        return BoolMask(out_true, out_true | out_false)

    def not_(self) -> "BoolMask":
        return BoolMask(~self.bits, self.valid)

    def to_selection(self) -> torch.Tensor:
        """NULL -> excluded (SQL filter semantics)."""
        return self.bits & self.valid
