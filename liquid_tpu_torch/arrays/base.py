"""LiquidArray: one encoded 8192-row column block (port of
`liquid_tpu/arrays/base.py`).

The port keeps each block's encoded fields on the HOST (numpy, the
reference's exact words); the fused path stacks many blocks into one
device tensor per column.  `to_device(device)` decodes one block for
tests and callers that want a single block on a device.
"""
from __future__ import annotations

import abc
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import pyarrow as pa
import torch

from liquid_tpu_torch.ops import mask as mops

BLOCK_ROWS = mops.BLOCK_ROWS

#: comparison operators a predicate may carry (the reference's set)
CMP_OPS = ("eq", "ne", "lt", "lt_eq", "gt", "gt_eq", "contains",
           "not_contains", "starts_with", "ends_with")


@dataclass(frozen=True)
class Predicate:
    """Column-vs-literal predicate admitted to encoded evaluation."""

    op: str  # one of CMP_OPS
    literal: object
    #: NaN rows count as matching (DESC top-k thresholds)
    keep_nan: bool = False

    def __post_init__(self):
        assert self.op in CMP_OPS, self.op


class LiquidArray(abc.ABC):
    """One encoded 8192-row column block."""

    length: int  # valid rows (<= BLOCK_ROWS); rows beyond are padding

    @abc.abstractmethod
    def memory_bytes(self) -> int:
        """Bytes this encoding occupies (budget accounting)."""

    @abc.abstractmethod
    def to_arrow(self) -> pa.Array:
        """Decode the first `length` rows to a pyarrow array."""

    @abc.abstractmethod
    def to_device(self, device) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(values[BLOCK_ROWS], packed validity int32[256] or None)."""

    @property
    @abc.abstractmethod
    def arrow_type(self) -> pa.DataType: ...


def pack_validity(valid_bools: Optional[np.ndarray], length: int):
    """Host bools[length] -> packed uint32 validity over BLOCK_ROWS, or
    None when every row of a full block is valid (padding rows are
    marked invalid)."""
    if valid_bools is None or bool(np.all(valid_bools)):
        if length == BLOCK_ROWS:
            return None
        v = np.zeros(BLOCK_ROWS, dtype=bool)
        v[:length] = True
        return mops.pack_bools_host(v)
    v = np.zeros(BLOCK_ROWS, dtype=bool)
    v[:length] = valid_bools[:length]
    return mops.pack_bools_host(v)


def validity_mask_or_full(validity: Optional[np.ndarray], length: int,
                          device) -> torch.Tensor:
    """A block's packed validity on `device`: its own words, or the first
    `length` rows set when it has none."""
    from liquid_tpu_torch.device import words_to_tensor
    if validity is None:
        validity = mops.all_set_host(BLOCK_ROWS, length)
    return words_to_tensor(validity, device)


def const_words(value: bool, device) -> torch.Tensor:
    """int32[256]: every row's bit set (value) or none."""
    return torch.full((BLOCK_ROWS // 32,), -1 if value else 0,
                      dtype=torch.int32, device=device)


def np_dtype_for(t: pa.DataType) -> np.dtype:
    if pa.types.is_boolean(t):
        return np.dtype(np.bool_)
    if pa.types.is_date32(t):
        return np.dtype(np.int32)
    if pa.types.is_timestamp(t) or pa.types.is_date64(t):
        return np.dtype(np.int64)
    return np.dtype(t.to_pandas_dtype())


def arrow_with_validity(host: np.ndarray, t: pa.DataType, validity,
                        length: int) -> pa.Array:
    """First `length` decoded values as an arrow array of type t."""
    host = host[:length].astype(np_dtype_for(t))
    if validity is not None:
        valid = mops.unpack_bits_host(validity)[:length]
        return pa.array(host, type=t, mask=~valid)
    return pa.array(host, type=t)
