"""Global (no GROUP BY) reductions (port of `liquid_tpu/ops/groupby.py`,
`scalar_reduce` and `_neutral`)."""
from __future__ import annotations

from typing import Sequence, Tuple

import torch


def _neutral(dtype: torch.dtype, kind: str):
    if dtype.is_floating_point:
        return float("inf") if kind == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if kind == "min" else info.min


def scalar_reduce(valid: torch.Tensor, vals: Sequence[torch.Tensor],
                  vnulls: Sequence[torch.Tensor], kinds: Sequence[str]
                  ) -> Tuple[Tuple[torch.Tensor, ...], Tuple[torch.Tensor, ...]]:
    """Per slot: (reduced value, non-null contribution count) over the
    rows where `valid` holds.  kind in {sum, min, max}."""
    outs, counts = [], []
    for v, vn, kind in zip(vals, vnulls, kinds):
        contrib = valid & ~vn
        counts.append(contrib.sum(dtype=torch.int64))
        if kind == "sum":
            outs.append(torch.where(contrib, v, torch.zeros((), dtype=v.dtype,
                                                            device=v.device)).sum())
        elif kind in ("min", "max"):
            neutral = torch.full((), _neutral(v.dtype, kind), dtype=v.dtype,
                                 device=v.device)
            masked = torch.where(contrib, v, neutral)
            outs.append(masked.min() if kind == "min" else masked.max())
        else:
            raise ValueError(f"kind {kind}")
    return tuple(outs), tuple(counts)
