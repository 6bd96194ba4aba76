"""Equi-joins of host tables, sort-merge on the device (port of
`liquid_tpu/sql/device_join.py`).

Key tuples of both sides are encoded to int64 code images with one
shared `device_agg.KeyCodec` per key pair (string vocabulary ids agree
across the sides), dense-ranked over the union and packed into ONE int64
sort key.  The sort-merge build and probe run on the engine's device
(`ops/join.py`: a stable sort, two searchsorted, a prefix-sum
expansion); the key codes go up once and the matched row indices come
back once, and the rows are taken on the host.  A NULL key never
matches: each side's NULL rows get a sentinel code the other side lacks.

Inner, left, right and full joins; the output carries both sides' key
columns (outer rows null-extend the missing side), a same-name key pair
coalesced.  Below HOST_JOIN_MAX rows in all the sort and probe run in
numpy, as in the reference.  Colliding non-key column names or a key
tuple too wide to pack return None (the caller joins with pyarrow).
The reference sends every such join to pyarrow on a TPU (`_prefer_host`,
a TPU-era measurement); the port keeps the device route on every device.

Row order: probe-major (left-major for inner and left, right-major for
right), matches in build sort order, unmatched outer rows after in side
order.
"""
from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import torch

from liquid_tpu_torch.sql.device_agg import DeviceUnsupported, KeyCodec

#: joins by route: "device_joins" sort and probe on the engine's device,
#: "host_joins" in numpy (small), "fallback_joins" go to pyarrow
STATS = {"device_joins": 0, "host_joins": 0, "fallback_joins": 0}

#: below this many rows in all the sort and probe run in numpy: a device
#: round trip per small dimension join costs more than the join
HOST_JOIN_MAX = 1 << 16

_PACK_BITS = 62  # packed rank budget; the two sentinels live above it


def try_device_join(left: pa.Table, right: pa.Table, lkeys: List[str],
                    rkeys: List[str], kind: str, device="cpu"
                    ) -> Optional[pa.Table]:
    """The joined table, or None (the caller joins with pyarrow)."""
    try:
        return _device_join(left, right, lkeys, rkeys, kind,
                            torch.device(device))
    except DeviceUnsupported:
        STATS["fallback_joins"] += 1
        return None


def _device_join(left: pa.Table, right: pa.Table, lkeys: List[str],
                 rkeys: List[str], kind: str, device) -> pa.Table:
    if kind not in ("inner", "left", "right", "full"):
        raise DeviceUnsupported(kind)
    # non-key name collisions are ambiguous; same-name key pairs coalesce
    coalesce = {lk for lk, rk in zip(lkeys, rkeys) if lk == rk}
    shared = (set(left.column_names) & set(right.column_names)) - coalesce
    if shared:
        raise DeviceUnsupported(f"colliding columns {shared}")
    packed = _pack_ranks(*_encode_keys(left, right, lkeys, rkeys))
    if packed is None:
        raise DeviceUnsupported("key cardinality exceeds the pack budget")
    lpacked, rpacked = packed
    # the probe side leads the output's order
    probe, build = (rpacked, lpacked) if kind == "right" \
        else (lpacked, rpacked)
    n_b, n_p = len(build), len(probe)
    b_matched = None
    if n_b + n_p < HOST_JOIN_MAX:
        STATS["host_joins"] += 1
        perm = np.argsort(build, kind="stable")
        skeys = build[perm]
        lo = np.searchsorted(skeys, probe, side="left")
        hi = np.searchsorted(skeys, probe, side="right")
        counts = hi - lo
        total = int(counts.sum())
        p_idx = np.repeat(np.arange(n_p, dtype=np.int64), counts)
        offs = (np.arange(total, dtype=np.int64)
                - np.repeat(np.cumsum(counts) - counts, counts))
        b_idx = perm[np.repeat(lo, counts) + offs]
        if kind == "full":
            diff = np.zeros(n_b + 1, np.int32)
            np.add.at(diff, lo, 1)
            np.add.at(diff, hi, -1)
            b_matched = np.zeros(n_b, bool)
            b_matched[perm] = np.cumsum(diff[:n_b]) > 0
    else:
        STATS["device_joins"] += 1
        p_idx, b_idx, counts, b_matched = _sort_merge(build, probe, kind,
                                                      device)
    if kind == "right":
        l_idx, r_idx = b_idx, p_idx
    else:
        l_idx, r_idx = p_idx, b_idx
    if kind in ("left", "right"):
        unmatched = np.flatnonzero(counts == 0).astype(np.int64)
        if len(unmatched):
            miss = np.full(len(unmatched), -1, np.int64)
            if kind == "left":
                l_idx = np.concatenate([l_idx, unmatched])
                r_idx = np.concatenate([r_idx, miss])
            else:
                l_idx = np.concatenate([l_idx, miss])
                r_idx = np.concatenate([r_idx, unmatched])
    elif kind == "full":
        un_p = np.flatnonzero(counts == 0).astype(np.int64)
        un_b = np.flatnonzero(~b_matched).astype(np.int64)
        l_idx = np.concatenate([l_idx, un_p, np.full(len(un_b), -1,
                                                     np.int64)])
        r_idx = np.concatenate([r_idx, np.full(len(un_p), -1, np.int64),
                                un_b])
    return _take_join(left, right, l_idx, r_idx, coalesce)


def _sort_merge(build: np.ndarray, probe: np.ndarray, kind: str, device):
    """The sort-merge on `device` -> (probe rows, build rows, matches per
    probe row, build rows matched [full joins only]) as numpy."""
    from liquid_tpu_torch.ops import join as jops
    n_b = len(build)
    skeys, perm = jops.sort_build(torch.from_numpy(build).to(device))
    lo, hi = jops.probe_bounds(skeys, torch.from_numpy(probe).to(device))
    counts_d = hi - lo
    counts = counts_d.cpu().numpy()
    total = int(counts.sum())
    if total:
        cap = 1 << max(0, math.ceil(math.log2(total)))
        p_d, bpos_d, valid_d = jops.expand_matches(lo, counts_d, cap)
        # one fetch of the matched pairs, the build rows mapped on the card
        pairs = torch.stack([p_d.to(torch.int64)[:total],
                             perm.to(torch.int64)[bpos_d.to(torch.int64)
                                                  [:total]]]).cpu().numpy()
        p_idx, b_idx = pairs[0], pairs[1]
    else:
        p_idx = b_idx = np.empty(0, np.int64)
    b_matched = None
    if kind == "full":
        flags = jops.matched_flags(skeys, lo, hi).cpu().numpy()
        b_matched = np.zeros(n_b, bool)
        b_matched[perm.cpu().numpy()] = flags
    return p_idx, b_idx, counts, b_matched


def _encode_keys(left, right, lkeys, rkeys):
    """Per key pair: int64 codes and NULL flags of both sides through ONE
    shared codec (string vocabulary ids must agree across the sides)."""
    lcodes, lnulls, rcodes, rnulls = [], [], [], []
    for lk, rk in zip(lkeys, rkeys):
        la = left.column(lk).combine_chunks()
        ra = right.column(rk).combine_chunks()
        codec = KeyCodec(la.type)
        if KeyCodec(ra.type)._kind != codec._kind:
            raise DeviceUnsupported(f"key kinds differ: {la.type} vs "
                                    f"{ra.type}")
        lc, ln = codec.encode(la) if len(la) else (
            np.empty(0, np.int64), np.empty(0, bool))
        rc, rn = codec.encode(ra) if len(ra) else (
            np.empty(0, np.int64), np.empty(0, bool))
        lcodes.append(lc)
        lnulls.append(ln)
        rcodes.append(rc)
        rnulls.append(rn)
    return lcodes, lnulls, rcodes, rnulls


def _pack_ranks(lcodes, lnulls, rcodes, rnulls):
    """Dense-rank each key column over the union of both sides and pack
    the ranks into one int64 per row; a row with any NULL key gets its
    side's sentinel above the pack budget (never matched).  None when
    the ranks need more than 62 bits."""
    n_l = len(lcodes[0]) if lcodes else 0
    n_r = len(rcodes[0]) if rcodes else 0
    lpack = np.zeros(n_l, np.int64)
    rpack = np.zeros(n_r, np.int64)
    used_bits = 0
    for lc, rc in zip(lcodes, rcodes):
        uniq, inv = np.unique(np.concatenate([lc, rc]), return_inverse=True)
        bits = max(1, max(len(uniq), 1).bit_length())
        used_bits += bits
        if used_bits > _PACK_BITS:
            return None
        lpack = (lpack << bits) | inv[:n_l].astype(np.int64)
        rpack = (rpack << bits) | inv[n_l:].astype(np.int64)
    lnull = np.zeros(n_l, bool)
    rnull = np.zeros(n_r, bool)
    for ln, rn in zip(lnulls, rnulls):
        lnull |= ln
        rnull |= rn
    lpack = np.where(lnull, np.int64(1) << 62, lpack)
    rpack = np.where(rnull, (np.int64(1) << 62) | 1, rpack)
    return lpack, rpack


def _take_join(left, right, l_idx, r_idx, coalesce):
    lmask = l_idx < 0
    rmask = r_idx < 0
    lt = pa.array(l_idx, pa.int64(), mask=lmask if lmask.any() else None)
    rt = pa.array(r_idx, pa.int64(), mask=rmask if rmask.any() else None)
    cols = {name: left.column(name).take(lt) for name in left.column_names}
    for name in right.column_names:
        rcol = right.column(name).take(rt)
        if name in coalesce:
            # a same-name key pair: the left value where present
            if lmask.any():
                cols[name] = pc.if_else(pa.array(~lmask), cols[name], rcol)
        else:
            cols[name] = rcol
    return pa.table(cols)
