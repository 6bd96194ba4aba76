"""Packed selection masks (port of `liquid_tpu/ops/mask.py`).

A selection over an 8192-row block is 256 words (row r -> word r//32,
bit r%32, LSB first).  Device words are int32 tensors holding the
reference's uint32 bits (see `liquid_tpu_torch.device`); host twins stay
numpy uint32, bit-identical to the reference's.  Boolean algebra,
including Kleene AND/OR with null tracking, runs on the packed words.
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


def count(words: torch.Tensor) -> torch.Tensor:
    """Set bits over a packed mask -> int64 scalar tensor."""
    return popcount32(words).to(torch.int64).sum()


def count_many(words: torch.Tensor) -> torch.Tensor:
    """Set bits per row of packed masks int32[B, W] -> int64[B]."""
    return popcount32(words).to(torch.int64).sum(-1)


def count_host(words: np.ndarray) -> int:
    return int(np.unpackbits(np.asarray(words).view(np.uint8)).sum())


@dataclass(frozen=True)
class BoolMask:
    """Three-valued (Kleene) boolean column in packed form: `bits` is the
    truth value where `valid` is set; valid=0 rows are NULL."""

    bits: torch.Tensor   # int32[W]
    valid: torch.Tensor  # int32[W]; all-ones => no nulls

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
