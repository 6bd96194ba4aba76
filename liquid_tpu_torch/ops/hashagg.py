"""Device grouped reduction: direct addressing and the hash ladder (port
of `liquid_tpu/ops/hashagg.py`).

`direct_reduce_packed` maps each key tuple to a mixed-radix slot when
every key's domain is densely bounded: the map is bijective, so there are
no collisions.  Its exact integer sums run K2
(`grouphist_cuda.group_accumulate`) when the planner passes
`pallas_seg`.  `hash_rounds_reduce_packed` hashes key tuples into a
power-of-two table; a slot is clean iff every key's per-slot min equals
its max, dirty rows re-scatter with a fresh salt next round, and `clean`
False tells the caller to retry with a bigger table.  Answers never
depend on hash quality.

Both return the reference's packed single-fetch output: an int64 matrix
[1 + 2*nk + 2*nv, w] (row 0 the header [clean, n_groups, 0, ...], groups
prefix-packed, f64 rows as bit images), plus the slot-ordered columns
for a re-pack when there are more than PACK_CAP groups.

`hash_group_reduce[_packed]` is the classic aggregators' single-table
form: one salt, one table, `clean` False when any slot collides (the
caller retries or sorts).

The reference's scatters drop out-of-bounds indices (`mode="drop"`);
`index_add_` and `scatter_reduce_` have no such mode, so every scatter
table here has a band of TRASH rows past its m slots: dead row r lands in
row m + (r & (TRASH - 1)), and the band is sliced off after.  Spread over
the band, the dead rows of a selective filter no longer serialize their
atomics on one address.
u64 hashing runs on int64 bit images: the product wraps as the u64
product does, and every right shift is logical (`device.srl`).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from liquid_tpu_torch.device import srl, wrap_i64
from liquid_tpu_torch.ops import floatbits
from liquid_tpu_torch.ops import grouphist as gh
from liquid_tpu_torch.ops import grouphist_cuda
from liquid_tpu_torch.ops.groupby import _neutral

_I64 = torch.int64

#: largest slot table (2^21 slots)
MAX_SLOTS = 1 << 21

#: packed-fetch width: more groups re-fetch the slot-ordered columns
PACK_CAP = 1 << 16

#: direct-address table cap (slots x columns x 8 B)
DIRECT_CAP = 1 << 21

#: the reference's tiers below the scatter: masked full-array reductions
#: per slot, unrolled up to SMALL slots and looped up to STREAM_ELEMS
#: slot-columns (TPU crossovers; eager PyTorch runs both as one loop)
SMALL = 64
STREAM_ELEMS = 6144

#: rows of the trash band appended to every scatter table (a power of 2)
TRASH = 4096

#: reduction tiers taken, counted where they are chosen: "k2" per direct
#: reduction through K2, "stream" and "scatter" per (op, dtype) batch of
#: the other direct reductions, "hash" per hash-ladder call
TIERS = {"k2": 0, "stream": 0, "scatter": 0, "hash": 0}

_MIX1 = wrap_i64(0xBF58476D1CE4E5B9)
_MIX2 = wrap_i64(0x94D049BB133111EB)
_GOLDEN = 0x9E3779B97F4A7C15


def pick_slots(n_rows: int) -> int:
    """Initial table size: 2x the row count, capped at MAX_SLOTS."""
    h = 1024
    while h < 2 * n_rows and h < MAX_SLOTS:
        h <<= 1
    return h


def _mix(h: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """64-bit mix fold (splitmix64 finalizer shape) on int64 bit images."""
    h = h ^ v
    h = (h ^ srl(h, 30)) * _MIX1
    h = (h ^ srl(h, 27)) * _MIX2
    return h ^ srl(h, 31)


def _fill(dt: torch.dtype, op: str):
    return 0 if op == "add" else _neutral(dt, op)


def _dropped(slot: torch.Tensor, live: torch.Tensor, m: int) -> torch.Tensor:
    """int64 scatter indices with the dead rows sent to the trash band:
    row r to m + (r & (TRASH - 1)), never a kept slot."""
    band = torch.arange(slot.shape[0], dtype=_I64, device=slot.device) \
        & (TRASH - 1)
    return torch.where(live, slot.to(_I64), band + m)


def _scatter(slot: torch.Tensor, stackv: torch.Tensor, m: int,
             op: str) -> torch.Tensor:
    """Per-slot reduction of stackv [n, K] into [m, K]; `slot` from
    `_dropped`, whose indices m .. m + TRASH - 1 land in the trash band."""
    dt = stackv.dtype
    tbl = torch.full((m + TRASH, stackv.shape[1]), _fill(dt, op), dtype=dt,
                     device=stackv.device)
    idx = slot.to(torch.int64)
    if op == "add":
        tbl.index_add_(0, idx, stackv)
    else:
        tbl.scatter_reduce_(0, idx[:, None].expand_as(stackv), stackv,
                            "amin" if op == "min" else "amax",
                            include_self=True)
    return tbl[:m]


def _stream(slot: torch.Tensor, stackv: torch.Tensor, m: int,
            op: str) -> torch.Tensor:
    """One masked full-array reduction per slot (the reference's unrolled
    and fori_loop tiers)."""
    neutral = torch.full((), _fill(stackv.dtype, op), dtype=stackv.dtype,
                         device=stackv.device)
    rows = []
    for s in range(m):
        masked = torch.where((slot == s)[:, None], stackv, neutral)
        rows.append(masked.sum(0) if op == "add" else
                    masked.amin(0) if op == "min" else masked.amax(0))
    return torch.stack(rows)


def _batch_cols(vals, vnulls, kinds, live, add_cols, min_cols, max_cols):
    """Per-slot payload columns batched by (op, dtype): null and dead rows
    fold into the payload as 0 for adds and the neutral for min/max."""
    n = live.shape[0]
    add_cols.setdefault(_I64, []).append(
        (("occ", 0), torch.ones(n, dtype=_I64, device=live.device)))
    for j, (v, vn, kind) in enumerate(zip(vals, vnulls, kinds)):
        contrib = live & ~vn
        add_cols.setdefault(_I64, []).append((("cnt", j), contrib.to(_I64)))
        if kind == "sum":
            z = torch.where(contrib, v, torch.zeros((), dtype=v.dtype,
                                                    device=v.device))
            add_cols.setdefault(v.dtype, []).append((("acc", j), z))
        else:
            z = torch.where(contrib, v, torch.full(
                (), _neutral(v.dtype, kind), dtype=v.dtype, device=v.device))
            (min_cols if kind == "min" else max_cols).setdefault(
                v.dtype, []).append((("acc", j), z))


def direct_reduce_packed(codes: Sequence[torch.Tensor],
                         knulls: Sequence[torch.Tensor],
                         valid: torch.Tensor,
                         vals: Sequence[torch.Tensor],
                         vnulls: Sequence[torch.Tensor],
                         kinds: Sequence[str], los: torch.Tensor,
                         spans: Sequence[int], pallas_seg=(), having=()):
    """Grouped reduction by direct addressing: slot = mixed-radix index of
    (code - lo) per key, a NULL key taking index span_i + 1.  `los`
    int64[nk]; `spans` per key (max - min).  `pallas_seg` = (seg, ntab,
    wide) routes every sum through K2, wide[j] marking accumulators that
    ride as hi/lo i32 halves; `having` = (rslot, op, literal) drops
    failing groups before the pack.  Output as hash_rounds_reduce_packed
    (clean always True)."""
    n = valid.shape[0]
    dev = valid.device
    nk = len(codes)
    strides: List[int] = []
    m = 1
    for s in reversed(spans):
        strides.append(m)
        m *= s + 2
    strides.reverse()
    slot = torch.zeros(n, dtype=_I64, device=dev)
    for i, (c, nl) in enumerate(zip(codes, knulls)):
        idx = torch.where(nl, torch.full_like(c, spans[i] + 1), c - los[i])
        slot = slot + idx * strides[i]
    # K2's contract: slot m is its trash column
    slot = torch.where(valid, slot, torch.full_like(slot, m)).to(torch.int32)
    dropped = None

    add_cols: Dict[torch.dtype, list] = {}
    min_cols: Dict[torch.dtype, list] = {}
    max_cols: Dict[torch.dtype, list] = {}
    # the occupancy column counts every row: dead rows sit past slot m
    _batch_cols(vals, vnulls, kinds, valid, add_cols, min_cols, max_cols)
    got: Dict[tuple, torch.Tensor] = {}

    def run_batch(groups, op):
        nonlocal dropped
        for dt, cols in groups.items():
            stackv = torch.stack([v for _, v in cols], dim=1)
            if m <= SMALL or m * len(cols) <= STREAM_ELEMS:
                TIERS["stream"] += 1
                tbl = _stream(slot, stackv, m, op)
            else:
                TIERS["scatter"] += 1
                if dropped is None:
                    dropped = _dropped(slot, valid, m)
                tbl = _scatter(dropped, stackv, m, op)
            for k, (tag, _) in enumerate(cols):
                got[(op,) + tag] = tbl[:, k]

    if pallas_seg and not min_cols and not max_cols \
            and list(add_cols) == [_I64]:
        # K2: one pass over the rows for every bound-safe sum column
        _seg, _ntab, wide = pallas_seg
        parts, k2_cols = [], []
        for tag, v in add_cols[_I64]:
            if tag[0] == "acc" and wide[tag[1]]:
                hi, lo = gh.split_hilo(v)
                k2_cols += [hi, lo]
                parts += [(tag, "hi"), (tag, "lo")]
            else:
                k2_cols.append(v.to(torch.int32))
                parts.append((tag, "plain"))
        # the kernel reads the columns in place: no [n, C] stack
        TIERS["k2"] += 1
        tb = grouphist_cuda.group_accumulate(slot, k2_cols, m)
        acc_map: Dict[tuple, torch.Tensor] = {}
        for k2, (tag, part) in enumerate(parts):
            col = tb[:m, k2]
            if part == "hi":
                acc_map[tag] = col << gh.SPLIT
            elif part == "lo":
                acc_map[tag] = acc_map[tag] + col
            else:
                acc_map[tag] = col
        for tag, v in acc_map.items():
            got[("add",) + tag] = v
    else:
        run_batch(add_cols, "add")
        run_batch(min_cols, "min")
        run_batch(max_cols, "max")

    occ = got[("add", "occ", 0)] > 0
    if having:
        # device HAVING over one aggregate slot: failing groups never
        # reach the packed output (the host re-applies the predicate)
        hj, hop, hlit = having
        hacc = got[("add", "acc", hj)].to(torch.float64)
        hcnt = got[("add", "cnt", hj)]
        ok = {"gt": hacc > hlit, "ge": hacc >= hlit, "lt": hacc < hlit,
              "le": hacc <= hlit, "eq": hacc == hlit,
              "ne": hacc != hlit}[hop]
        occ = occ & ok & (hcnt > 0)
    # keys decode from the slot index (bijective)
    iota = torch.arange(m, dtype=_I64, device=dev)
    kreps, nreps = [], []
    for i in range(nk):
        idx = torch.div(iota, strides[i], rounding_mode="floor") \
            % (spans[i] + 2)
        isnull = idx == spans[i] + 1
        kreps.append(torch.where(isnull, torch.zeros_like(idx),
                                 idx + los[i]))
        nreps.append(isnull)

    pos = torch.cumsum(occ.to(torch.int32), 0, dtype=torch.int32)
    n_groups = pos[-1]
    kcat, ncat = tuple(kreps), tuple(nreps)
    ocat = tuple(got[("add" if kinds[j] == "sum" else kinds[j], "acc", j)]
                 for j in range(len(vals)))
    ccat = tuple(got[("add", "cnt", j)] for j in range(len(vals)))
    w = min(m, PACK_CAP)
    ukeys, uknulls, outs, vcounts = _pack_by_search(
        pos, kcat, ncat, ocat, ccat, w)
    clean = torch.ones((), dtype=torch.bool, device=dev)
    mat = _pack_outputs(clean, n_groups, ukeys, uknulls, outs, vcounts, w)
    return (mat, clean, n_groups, (occ,) + kcat + ncat + ocat + ccat)


def hash_rounds_reduce_packed(codes: Sequence[torch.Tensor],
                              knulls: Sequence[torch.Tensor],
                              valid: torch.Tensor,
                              vals: Sequence[torch.Tensor],
                              vnulls: Sequence[torch.Tensor],
                              kinds: Sequence[str], n_slots: int, salt: int,
                              rounds: int = 3):
    """Multi-round collision-resolved grouped reduction with the packed
    single-fetch output.  Rows whose slot got two distinct key tuples
    re-scatter with a fresh salt next round; each key tuple resolves in
    exactly one round.  `clean` False: `rounds` did not converge."""
    TIERS["hash"] += 1
    n = valid.shape[0]
    dev = valid.device
    live = valid
    occs, kreps_r, nreps_r, outs_r, cnts_r = [], [], [], [], []
    for r in range(rounds):
        rsalt = wrap_i64(salt + r * _GOLDEN)
        if codes:
            h = torch.full((n,), rsalt, dtype=_I64, device=dev)
            for c, nl in zip(codes, knulls):
                h = _mix(h, c)
                h = _mix(h, nl.to(_I64))
        else:
            h = torch.zeros(n, dtype=_I64, device=dev)
        slot = _dropped(h & (n_slots - 1), live, n_slots)

        add_cols: Dict[torch.dtype, list] = {}
        min_cols: Dict[torch.dtype, list] = {}
        max_cols: Dict[torch.dtype, list] = {}
        for i, (c, nl) in enumerate(zip(codes, knulls)):
            min_cols.setdefault(c.dtype, []).append((("kmin", i), c))
            max_cols.setdefault(c.dtype, []).append((("kmax", i), c))
            valid_flag = (~nl).to(_I64)
            min_cols.setdefault(_I64, []).append((("nmin", i), valid_flag))
            max_cols.setdefault(_I64, []).append((("nmax", i), valid_flag))
        _batch_cols(vals, vnulls, kinds, live, add_cols, min_cols, max_cols)

        got: Dict[tuple, torch.Tensor] = {}
        for groups, op in ((add_cols, "add"), (min_cols, "min"),
                           (max_cols, "max")):
            for dt, cols in groups.items():
                tbl = _scatter(slot, torch.stack([v for _, v in cols], 1),
                               n_slots, op)
                for k, (tag, _) in enumerate(cols):
                    got[(op,) + tag] = tbl[:, k]

        occ = got[("add", "occ", 0)] > 0
        dirty = torch.zeros(n_slots, dtype=torch.bool, device=dev)
        kreps, nreps = [], []
        for i in range(len(codes)):
            cmin, cmax = got[("min", "kmin", i)], got[("max", "kmax", i)]
            nmin, nmax = got[("min", "nmin", i)], got[("max", "nmax", i)]
            dirty = dirty | (occ & ((cmin != cmax) | (nmin != nmax)))
            kreps.append(cmin)
            # a clean slot has nmin == nmax: nmin == 0 <-> the key is NULL
            nreps.append(nmin == 0)
        occs.append(occ & ~dirty)
        kreps_r.append(kreps)
        nreps_r.append(nreps)
        outs_r.append([got[("add" if kind == "sum" else kind, "acc", j)]
                       for j, kind in enumerate(kinds)])
        cnts_r.append([got[("add", "cnt", j)] for j in range(len(vals))])
        live = live & dirty[slot.clamp(0, n_slots - 1).to(torch.int64)]

    clean = live.sum() == 0
    m = rounds * n_slots
    nk = len(codes)
    occ_all = torch.cat(occs)
    pos = torch.cumsum(occ_all.to(torch.int32), 0, dtype=torch.int32)
    n_groups = pos[-1]
    kcat = tuple(torch.cat([kreps_r[r][i] for r in range(rounds)])
                 for i in range(nk))
    ncat = tuple(torch.cat([nreps_r[r][i] for r in range(rounds)])
                 for i in range(nk))
    ocat = tuple(torch.cat([outs_r[r][j] for r in range(rounds)])
                 for j in range(len(vals)))
    ccat = tuple(torch.cat([cnts_r[r][j] for r in range(rounds)])
                 for j in range(len(vals)))
    w = min(m, PACK_CAP)
    ukeys, uknulls, outs, vcounts = _pack_by_search(
        pos, kcat, ncat, ocat, ccat, w)
    mat = _pack_outputs(clean, n_groups, ukeys, uknulls, outs, vcounts, w)
    return (mat, clean, n_groups, (occ_all,) + kcat + ncat + ocat + ccat)


def hash_group_reduce(codes: Sequence[torch.Tensor],
                      knulls: Sequence[torch.Tensor], valid: torch.Tensor,
                      vals: Sequence[torch.Tensor],
                      vnulls: Sequence[torch.Tensor], kinds: Sequence[str],
                      n_slots: int, salt: int):
    """Grouped reduction by hashing into one table of `n_slots` slots: the
    contract of `groupby.group_reduce` plus a leading `clean` flag.

    -> (clean, n_groups, ukeys, uknulls, outs, vcounts), every per-group
    array [n_slots] with the groups packed at [0, n_groups).  `clean`
    False means a slot took two distinct key tuples: the other outputs
    are garbage and the caller retries (another salt, a bigger table) or
    sorts.  Invalid rows land in the trash band."""
    n = valid.shape[0]
    dev = valid.device
    if codes:
        h = torch.full((n,), wrap_i64(salt), dtype=_I64, device=dev)
        for c, nl in zip(codes, knulls):
            h = _mix(h, c)
            h = _mix(h, nl.to(_I64))
    else:
        h = torch.zeros(n, dtype=_I64, device=dev)
    slot = h & (n_slots - 1)
    drop = _dropped(slot, valid, n_slots)
    occ = torch.zeros(n_slots + TRASH, dtype=torch.bool, device=dev)
    occ[drop] = True
    occ = occ[:n_slots]
    # exact collision check: per slot, every key column's code (and NULL
    # flag) has min == max
    clean = torch.ones((), dtype=torch.bool, device=dev)
    kreps, nreps = [], []
    for c, nl in zip(codes, knulls):
        cmin = _scatter(drop, c[:, None], n_slots, "min")[:, 0]
        cmax = _scatter(drop, c[:, None], n_slots, "max")[:, 0]
        nl8 = nl.to(torch.int32)[:, None]
        nmin = torch.full((n_slots + TRASH, 1), 2, dtype=torch.int32,
                          device=dev)
        nmin.scatter_reduce_(0, drop[:, None], nl8, "amin", include_self=True)
        nmax = torch.full((n_slots + TRASH, 1), -1, dtype=torch.int32,
                          device=dev)
        nmax.scatter_reduce_(0, drop[:, None], nl8, "amax", include_self=True)
        nmin, nmax = nmin[:n_slots, 0], nmax[:n_slots, 0]
        clean = clean & torch.where(occ, (cmin == cmax) & (nmin == nmax),
                                    True).all()
        kreps.append(cmin)
        nreps.append(nmin == 1)
    # occupied slots packed to the prefix
    pos = torch.cumsum(occ.to(torch.int32), 0, dtype=torch.int32) - 1
    n_groups = occ.sum(dtype=torch.int32)
    dest = _dropped(pos, occ, n_slots)

    def packed(r, dt):
        out = torch.zeros(n_slots + TRASH, dtype=dt, device=dev)
        out[dest] = r
        return out[:n_slots]

    ukeys = tuple(packed(r, c.dtype) for c, r in zip(codes, kreps))
    uknulls = tuple(packed(r, torch.bool) for r in nreps)
    outs, vcounts = [], []
    for v, vn, kind in zip(vals, vnulls, kinds):
        contrib = valid & ~vn
        cslot = _dropped(slot, contrib, n_slots)
        cnt = _scatter(cslot, torch.ones(n, 1, dtype=_I64, device=dev),
                       n_slots, "add")[:, 0]
        acc = _scatter(cslot, v[:, None], n_slots,
                       "add" if kind == "sum" else kind)[:, 0]
        outs.append(packed(acc, v.dtype))
        vcounts.append(packed(cnt, _I64))
    return clean, n_groups, ukeys, uknulls, tuple(outs), tuple(vcounts)


def hash_group_reduce_packed(codes, knulls, valid, vals, vnulls, kinds,
                             n_slots: int, salt: int):
    """`hash_group_reduce` with every output in ONE int64 matrix
    [1 + 2*nk + 2*nv, min(n_slots, PACK_CAP)] for a single bounded fetch
    (row 0 the header [clean, n_groups, 0, ...]; f64 rows as bit images).
    -> (matrix, clean, n_groups, ukeys, uknulls, outs, vcounts); with
    more groups than the cap the caller fetches the full arrays."""
    clean, ng, ukeys, uknulls, outs, vcounts = hash_group_reduce(
        codes, knulls, valid, vals, vnulls, kinds, n_slots, salt)
    w = min(n_slots, PACK_CAP)
    mat = _pack_outputs(clean, ng, ukeys, uknulls, outs, vcounts, w)
    return mat, clean, ng, ukeys, uknulls, outs, vcounts


def _pack_by_search(pos, kcat, ncat, ocat, ccat, w: int):
    """Gather the first `w` occupied groups: src[j] = first slot whose
    inclusive occupancy cumsum reaches j + 1 (binary search, no scatter)."""
    want = torch.arange(1, w + 1, dtype=pos.dtype, device=pos.device)
    src = torch.searchsorted(pos, want).clamp(0, pos.shape[0] - 1)
    return (tuple(k[src] for k in kcat), tuple(n[src] for n in ncat),
            tuple(o[src] for o in ocat), tuple(c[src] for c in ccat))


def repack_groups(cols, nk: int, nv: int, w: int):
    """Re-pack a reduction's slot-ordered outputs at a larger width:
    cols is (occ, *ukeys[nk], *uknulls[nk], *outs[nv], *vcounts[nv])."""
    occ = cols[0]
    pos = torch.cumsum(occ.to(torch.int32), 0, dtype=torch.int32)
    return _pack_by_search(pos, cols[1:1 + nk], cols[1 + nk:1 + 2 * nk],
                           cols[1 + 2 * nk:1 + 2 * nk + nv],
                           cols[1 + 2 * nk + nv:], w)


def as_i64(x: torch.Tensor) -> torch.Tensor:
    """Reversible int64 image of an output row (f64 as its bit image)."""
    if x.dtype == torch.float64:
        return floatbits.f64_bits(x)
    return x if x.dtype == _I64 else x.to(_I64)


def _pack_outputs(clean, ng, ukeys, uknulls, outs, vcounts,
                  w: int) -> torch.Tensor:
    """Every output in ONE int64 matrix for a single bounded device-to-host
    transfer (row 0 header [clean, n_groups, 0, ...])."""
    hdr = torch.zeros(w, dtype=_I64, device=ng.device)
    hdr[0] = clean.to(_I64)
    hdr[1] = ng.to(_I64)
    rows = [hdr] + [as_i64(x)[:w] for x in
                    tuple(ukeys) + tuple(uknulls) + tuple(outs)
                    + tuple(vcounts)]
    return torch.stack(rows)
