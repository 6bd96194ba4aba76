"""Grouped and global reductions (port of `liquid_tpu/ops/groupby.py`).

`group_reduce` is the sort-based GROUP BY: the key columns sorted
lexicographically (least significant first, by stable sorts), segment
boundaries from adjacent differences, dense group ids from a cumsum, and
the payloads scatter-reduced by group id.  NULL keys form their own
group through a per-key null flag that takes part in the sort; invalid
rows (padding) sort last and land in a trash band past the n kept rows,
which is sliced off (the reference drops them with out-of-bounds
scatters).  `scalar_reduce` is the no-GROUP-BY form over one chunk.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

#: rows of the trash band that takes dead rows' scatters (a power of 2)
_TRASH = 4096


def pad_pow2(n: int, floor: int = 1024) -> int:
    """Next power of two >= n (at least `floor`)."""
    m = floor
    while m < n:
        m <<= 1
    return m


def _band(idx: torch.Tensor, keep: torch.Tensor, n: int) -> torch.Tensor:
    """int64 scatter indices: kept rows at `idx`, row r otherwise in the
    trash band at n + (r & (_TRASH - 1))."""
    r = torch.arange(idx.shape[0], dtype=torch.int64, device=idx.device)
    return torch.where(keep, idx.to(torch.int64), n + (r & (_TRASH - 1)))


def group_reduce(codes: Sequence[torch.Tensor],
                 knulls: Sequence[torch.Tensor], valid: torch.Tensor,
                 vals: Sequence[torch.Tensor],
                 vnulls: Sequence[torch.Tensor], kinds: Sequence[str]):
    """One-shot grouped reduction.

    codes / knulls: per key, int64 [N] code images and bool [N] NULL
    flags (a NULL is its own group); valid: bool [N] (False = padding,
    dropped); vals / vnulls: per slot, the payload in its accumulation
    dtype and its NULL flags (NULL inputs do not contribute); kinds: per
    slot "sum" | "min" | "max".

    -> (n_groups int32 0-d, ukeys, uknulls, outs, vcounts): per key and
    per slot [N] arrays with the groups packed at [0, n_groups); outs hold
    the neutral element where nothing contributed, vcounts the int64
    count of non-null contributions."""
    n = valid.shape[0]
    dev = valid.device
    inv = ~valid
    # lexsort, last key primary: stable sorts from the least significant
    perm = torch.arange(n, dtype=torch.int64, device=dev)
    for k in [x for c, nl in zip(codes, knulls) for x in (c, nl)] + [inv]:
        kk = k[perm]
        if kk.dtype == torch.bool:
            kk = kk.to(torch.int8)
        perm = perm[torch.sort(kk, stable=True).indices]
    sc = [c[perm] for c in codes]
    snl = [nl[perm] for nl in knulls]
    sv = valid[perm]
    if codes:
        diff = torch.zeros(max(n - 1, 0), dtype=torch.bool, device=dev)
        for c, nl in zip(sc, snl):
            diff = diff | (c[1:] != c[:-1]) | (nl[1:] != nl[:-1])
        first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), diff])
    else:
        first = torch.zeros(n, dtype=torch.bool, device=dev)
        first[:1] = True
    first = first & sv
    seg = torch.cumsum(first.to(torch.int32), 0, dtype=torch.int32) - 1
    n_groups = first.sum(dtype=torch.int32)
    # group id back in row order; invalid rows to the trash band
    gid_sorted = _band(seg, sv, n)
    gid = torch.empty(n, dtype=torch.int64, device=dev)
    gid[perm] = gid_sorted
    lead = _band(seg, first, n)
    ukeys, uknulls = [], []
    for c, nl in zip(sc, snl):
        uk = torch.zeros(n + _TRASH, dtype=c.dtype, device=dev)
        uk[lead] = c
        un = torch.zeros(n + _TRASH, dtype=torch.bool, device=dev)
        un[lead] = nl
        ukeys.append(uk[:n])
        uknulls.append(un[:n])
    outs, vcounts = [], []
    for v, vn, kind in zip(vals, vnulls, kinds):
        contrib = valid & ~vn
        cnt = torch.zeros(n + _TRASH, dtype=torch.int64, device=dev)
        cnt.index_add_(0, gid, contrib.to(torch.int64))
        vcounts.append(cnt[:n])
        if kind == "sum":
            z = torch.where(contrib, v, torch.zeros((), dtype=v.dtype,
                                                    device=dev))
            out = torch.zeros(n + _TRASH, dtype=v.dtype, device=dev)
            out.index_add_(0, gid, z)
        elif kind in ("min", "max"):
            neutral = _neutral(v.dtype, kind)
            z = torch.where(contrib, v, torch.full((), neutral,
                                                   dtype=v.dtype, device=dev))
            out = torch.full((n + _TRASH,), neutral, dtype=v.dtype,
                             device=dev)
            out.scatter_reduce_(0, gid, z, "amin" if kind == "min"
                                else "amax", include_self=True)
        else:
            raise ValueError(f"kind {kind}")
        outs.append(out[:n])
    return n_groups, tuple(ukeys), tuple(uknulls), tuple(outs), \
        tuple(vcounts)


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
