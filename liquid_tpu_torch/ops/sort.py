"""Device sorts (port of `liquid_tpu/ops/sort.py`).

The reference takes `lax.sort`, `lax.top_k` and `jnp.lexsort`, which are
XLA operations, not Pallas kernels.  Here they are stable `torch.sort`s:
`torch.topk` does not promise `lax.top_k`'s lower-index-first order among
equal keys, and a stable sort does.  `radix_sort_pairs` gives the
permutation of the reference's LSD radix sort in one stable sort of the
digits its passes cover.  Unsigned keys wider than the
signed type ride as their bit images (u64 in int64, u32 in int32), and
PyTorch's unsigned dtypes are taken as such images too.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

RADIX_BITS = 8
RADIX = 1 << RADIX_BITS

_SIGNED = {torch.uint8: torch.int8, torch.uint16: torch.int16,
           torch.uint32: torch.int32, torch.uint64: torch.int64}


def _signed_order(keys: torch.Tensor) -> torch.Tensor:
    """A tensor that sorts as `keys` do: an unsigned dtype's bit image
    with its top bit flipped, which orders as a signed value exactly as
    the unsigned value does; any other dtype unchanged."""
    st = _SIGNED.get(keys.dtype)
    return keys if st is None else keys.view(st) ^ torch.iinfo(st).min


def sort_pairs(keys: torch.Tensor, values: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(keys, values) sorted by keys ascending, ties in row order
    (reference `:25-28`)."""
    order = torch.sort(_signed_order(keys), stable=True).indices
    return keys[order], values[order]


def radix_sort_pairs(keys: torch.Tensor, values: torch.Tensor,
                     key_bits: Optional[int] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's LSD radix sort of unsigned integer keys (int32 /
    int64 tensors holding u32 / u64 bit images) with their payload
    (reference `:30-58`): its passes of 8 bits, least significant first,
    each stable, order the rows by the low 8 * ceil(key_bits / 8) bits of
    the key, ties in row order, so one stable sort by those bits gives
    the same permutation."""
    k = keys.view(_SIGNED.get(keys.dtype, keys.dtype))
    assert k.dtype in (torch.int32, torch.int64), keys.dtype
    width = torch.iinfo(k.dtype).bits
    bits = min(width, -(-(key_bits or width) // RADIX_BITS) * RADIX_BITS)
    digits = (k ^ torch.iinfo(k.dtype).min if bits == width
              else k & ((1 << bits) - 1))
    order = torch.sort(digits, stable=True).indices
    return keys[order], values[order]


def _reversed_key(keys: torch.Tensor) -> torch.Tensor:
    """Order-reversing bijection: bitwise complement for integers (~x =
    -x-1 is decreasing and never overflows; unsigned dtypes first take
    their signed order), negation for floats."""
    if keys.dtype.is_floating_point:
        return -keys
    return ~_signed_order(keys)


def argsort_selected(keys: torch.Tensor, descending: bool = False
                     ) -> torch.Tensor:
    """Stable argsort (ties keep row order) -> int32 row indices;
    descending sorts `_reversed_key(keys)` ascending, so ties keep row
    order there too (reference `:79-89`)."""
    k = _reversed_key(keys) if descending else _signed_order(keys)
    return torch.sort(k, stable=True).indices.to(torch.int32)


def top_k_rows(keys: torch.Tensor, k: int, descending: bool = True
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(top-k keys, their row indices): ORDER BY key LIMIT k, ties in row
    order."""
    vals, idx = torch.sort(keys, descending=descending, stable=True)
    return vals[:k], idx[:k]


def lexsort(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """Stable multi-key argsort; the LAST key is primary (numpy's and
    jnp's convention): one stable sort per key, least significant first."""
    perm = torch.arange(keys[0].shape[0], device=keys[0].device)
    for k in keys:
        perm = perm[torch.sort(k[perm], stable=True).indices]
    return perm
