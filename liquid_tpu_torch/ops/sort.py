"""Device sorts for ORDER BY (port of the parts of `liquid_tpu/ops/sort.py`
that `sql/device_sort.py` uses).

The reference takes `lax.top_k` and `jnp.lexsort`, which are XLA
operations, not Pallas kernels.  Here both are stable `torch.sort`s:
`torch.topk` does not promise `lax.top_k`'s lower-index-first order among
equal keys, and a stable sort does.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch


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
