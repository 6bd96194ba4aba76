"""Multi-device execution: the mesh, sharded scans and the all-to-all
shuffle (port of `liquid_tpu/parallel/dist.py`).

The reference is single-controller: one process holds one shard per
mesh device and runs one `shard_map` program across them.  The port
keeps that model without JAX:

- a `Mesh` is a list of `torch.device`s, one per shard; a device may
  repeat (four shards on one card, or eight on the CPU in the tests);
- a sharded value is a list of tensors, shard i on `mesh.devices[i]`;
- `psum` / `pmin` / `pmax` reduce the shards' partial tables onto the
  first shard's device (the replicated result of the reference's
  collectives), and `all_to_all` hands each destination the buckets the
  sources packed for it, copied to its device.

On one host with several cards the same code puts one shard on each
card; on one card the shards share it.

A shard's bit-plane predicates on integer columns run as K4's fused
form (`bitpack_cuda.select_planes`): one launch per shard per table scan
(one per 16 descriptors) on a CUDA tensor, its plain version on a CPU
tensor.  The primitives below keep K4's single form
(`bitpack_cuda.cmp_const_planes`).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from liquid_tpu_torch.device import resolve_device, srl, wrap_i64
from liquid_tpu_torch.ops import bitpack_cuda
from liquid_tpu_torch.ops import mask as mops
from liquid_tpu_torch.ops.bitpack import combine_op

#: structural scaling diagnostics, reset per statement by
#: `DistributedSession.sql`: collectives and their bytes (per-shard
#: operand size, as the reference counts them at trace time), the
#: exchanges with their rows, bytes and destination balance (max over
#: mean), and the K4 launches the statement's plans call for
#: (`k4_launches`: ceil(D / 16) per shard per table scan with at least
#: one bit-plane predicate, D its descriptors, on a shard with rows)
DIAG = {"collectives": 0, "collective_bytes": 0, "exchanges": 0,
        "exchange_rows": 0, "exchange_bytes": 0, "exchange_balance": 1.0,
        "exchange_overflow": 0, "k4_planned": 0}


def reset_diag() -> None:
    DIAG.update(collectives=0, collective_bytes=0, exchanges=0,
                exchange_rows=0, exchange_bytes=0, exchange_balance=1.0,
                exchange_overflow=0, k4_planned=0)


class MeshUnsupported(NotImplementedError):
    """A query shape the mesh planner does not take.  The one exception
    `DistributedSession.sql` answers on the single-device engine; every
    other error propagates."""


class Mesh:
    """One shard per entry of `devices` (entries may repeat)."""

    def __init__(self, devices: Sequence):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")

    @property
    def n(self) -> int:
        return len(self.devices)

    def __repr__(self):
        return f"Mesh({[str(d) for d in self.devices]})"


def make_mesh(n: Optional[int] = None, devices=None,
              n_devices: Optional[int] = None) -> Mesh:
    """A mesh over `devices` (each resolved as an entry point resolves its
    device: CUDA without a card raises), or over the first `n` visible
    CUDA devices, every one of them by default.  `n_devices` is the
    reference's name for `n`."""
    if n_devices is not None:
        if n is not None and n != n_devices:
            raise ValueError(f"n={n} but n_devices={n_devices}")
        n = n_devices
    if devices is not None:
        devs = [resolve_device(d) for d in devices]
        if n is not None and n != len(devs):
            raise ValueError(f"n={n} but {len(devs)} devices given")
        return Mesh(devs)
    resolve_device(None)  # raises without a card
    count = torch.cuda.device_count()
    if n is not None and n > count:
        raise ValueError(
            f"requested a {n}-device mesh but only {count} CUDA device(s) "
            f"are visible; pass devices=['cuda:0'] * {n} to put several "
            f"shards on one card, or devices=['cpu'] * {n}")
    return Mesh([torch.device("cuda", i) for i in range(n or count)])


def shard_rows(mesh: Mesh, arr, axis: int = 0) -> List[torch.Tensor]:
    """Split `arr` (numpy or tensor) into `mesh.n` equal contiguous parts
    along `axis` (rows by default; bit-plane stacks shard on axis 1), part
    i on `mesh.devices[i]`."""
    t = torch.as_tensor(arr)
    if t.shape[axis] % mesh.n:
        raise ValueError(f"axis {axis} of {tuple(t.shape)} does not split "
                         f"into {mesh.n} shards")
    return [p.contiguous().to(d) for p, d in
            zip(torch.chunk(t, mesh.n, dim=axis) if t.shape[axis]
                else [t] * mesh.n, mesh.devices)]


def replicate(mesh: Mesh, arr) -> List[torch.Tensor]:
    t = torch.as_tensor(arr)
    return [t.to(d) for d in mesh.devices]


# -- collectives ---------------------------------------------------------------

def _diag_count(x: torch.Tensor) -> None:
    DIAG["collectives"] += 1
    DIAG["collective_bytes"] += x.numel() * x.element_size()


def _reduce(parts: Sequence[torch.Tensor], op) -> torch.Tensor:
    _diag_count(parts[0])
    acc = parts[0].clone()
    for p in parts[1:]:
        acc = op(acc, p.to(acc.device))
    return acc


def psum(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """Sum of the shards' tensors, on the first shard's device."""
    return _reduce(parts, torch.add)


def pmin(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    return _reduce(parts, torch.minimum)


def pmax(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    return _reduce(parts, torch.maximum)


def all_to_all(mesh: Mesh, bufs: Sequence[torch.Tensor], cap: int
               ) -> List[torch.Tensor]:
    """Source s packed `bufs[s]` as n buckets of `cap` rows, bucket d for
    destination d; destination d receives [n * cap] rows, source-major
    (the reference's `all_to_all(..., 0, 0, tiled=False)`)."""
    n = mesh.n
    return [torch.cat([bufs[s][d * cap:(d + 1) * cap].to(mesh.devices[d])
                       for s in range(n)]) for d in range(n)]


# -- the shard-local predicate (K4) ---------------------------------------------

def cmp_planes_op(planes: torch.Tensor, c: int, op: str) -> torch.Tensor:
    """Packed mask of one shard's bit-planes int32[w, W] against the
    unsigned constant c (op in eq, ne, lt, lt_eq, gt, gt_eq): the
    reference's `bp.cmp_const_op`, through K4."""
    return combine_op(*bitpack_cuda.cmp_const_planes(planes, int(c)), op)


def k4_launches(sel: torch.Tensor, preds) -> int:
    """K4 launches one shard's fused selection over these bit-plane
    predicates makes on a CUDA tensor (`bitpack_cuda.select_launches`)."""
    return bitpack_cuda.select_launches(sel, preds)


# -- distributed fused filter + aggregate -----------------------------------------

def dist_filter_count(mesh: Mesh):
    """Distributed ClickBench-q1 shape: per shard, K4 against c and a
    popcount of the valid rows whose value is not c; psum merges.
    `planes` shard on the words axis, `valid` is the packed validity in
    the same sharding (padding rows masked out).  -> int32[1]."""

    def step(planes, valid, c):
        parts = []
        for p, v in zip(planes, valid):
            _lt, eq = bitpack_cuda.cmp_const_planes(p, int(c))
            parts.append(mops.count(~eq & v).to(torch.int32).reshape(1))
        return psum(parts)

    return step


def dist_filter_agg(mesh: Mesh, num_groups: int):
    """Distributed fused decode + filter + group count + group sum: per
    shard, K4 selects the values > c and dense group tables add them;
    psum merges the tables.  -> (counts int32[G], sums int64[G])."""

    def step(planes, codes, values, c):
        counts, sums = [], []
        for p, cd, v in zip(planes, codes, values):
            lt, eq = bitpack_cuda.cmp_const_planes(p, int(c))
            selb = mops.unpack_bits(~(lt | eq))
            gid = cd.to(torch.int64)
            counts.append(torch.zeros(num_groups, dtype=torch.int32,
                                      device=p.device).index_add_(
                0, gid, selb.to(torch.int32)))
            sums.append(torch.zeros(num_groups, dtype=torch.int64,
                                    device=p.device).index_add_(
                0, gid, torch.where(selb, v.to(torch.int64), 0)))
        return psum(counts), psum(sums)

    return step


# -- hash-partitioned shuffle ----------------------------------------------------

_M1 = wrap_i64(0xBF58476D1CE4E5B9)
_M2 = wrap_i64(0x94D049BB133111EB)


def _hash64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64 finalizer over the int64 bit image (logical shifts,
    wrapping products): the reference's u64 hash, bit for bit."""
    x = x.to(torch.int64)
    x = (x ^ srl(x, 30)) * _M1
    x = (x ^ srl(x, 27)) * _M2
    return x ^ srl(x, 31)


def _umod(h: torch.Tensor, n: int) -> torch.Tensor:
    """The UNSIGNED h % n of an int64 bit image (a signed % sends a
    negative image elsewhere than the reference's u64 modulo)."""
    return ((srl(h, 1) % n) * 2 + (h & 1)) % n


def dest_of(keys: torch.Tensor, n: int) -> torch.Tensor:
    """The destination shard of each key: unsigned hash64(key) % n."""
    return _umod(_hash64(keys), n)


def _rank_in_bucket(dest: torch.Tensor, buckets: int) -> torch.Tensor:
    """Each row's position among the rows of its bucket, in row order (the
    reference's one-hot cumsum, as a stable sort)."""
    order = torch.sort(dest, stable=True).indices
    counts = torch.bincount(dest, minlength=buckets)
    starts = torch.cumsum(counts, 0) - counts
    ranks = torch.empty_like(dest)
    ranks[order] = torch.arange(dest.shape[0], device=dest.device) \
        - starts[dest[order]]
    return ranks


def _exchange_by_dest(mesh: Mesh, cap: int, keys, payloads=(), valid=None):
    """Hash each shard's keys to destinations, rank-pack each destination's
    bucket to `cap` rows and exchange.  `payloads` are row-aligned
    sharded values shipped with the keys; rows with valid=False are not
    sent.  -> (keys, *payloads, mask, overflow): per destination [n * cap]
    rows and their mask, and per source the rows that did not fit."""
    n = mesh.n
    out_k, out_p, out_m, ovf = [], [[] for _ in payloads], [], []
    for s in range(n):
        k = keys[s]
        dev = k.device
        dest = dest_of(k, n)
        if valid is not None:
            dest = torch.where(valid[s], dest, n)
        rank = _rank_in_bucket(dest, n + 1)
        ok = rank < cap
        if valid is not None:
            ok = ok & valid[s]
        tgt = torch.where(ok, dest * cap + rank, n * cap)
        sent = valid[s] if valid is not None else torch.ones_like(ok)
        ovf.append((sent & ~ok).sum().reshape(1))

        def pack(x):
            buf = torch.zeros(n * cap + 1, dtype=x.dtype, device=dev)
            buf[tgt] = x
            return buf[:n * cap]

        out_k.append(pack(k))
        for i, p in enumerate(payloads):
            out_p[i].append(pack(p[s]))
        out_m.append(pack(ok))
    return ((all_to_all(mesh, out_k, cap),)
            + tuple(all_to_all(mesh, b, cap) for b in out_p)
            + (all_to_all(mesh, out_m, cap), ovf))


def dist_shuffle_by_key(mesh: Mesh, rows_per_device: int):
    """All-to-all repartition of (key, value) rows by key hash, each
    destination bucket padded to 2x the fair share; rows past it are
    counted in `overflow`.  -> (keys, values, mask, overflow), each a list
    per shard."""
    n = mesh.n
    cap = max(1, (2 * rows_per_device) // n)

    def step(keys, values):
        return _exchange_by_dest(mesh, cap, keys, (values,))

    return step


_I64_MAX = torch.iinfo(torch.int64).max


def dist_lookup_join(mesh: Mesh, probe_rows_per_device: int,
                     build_rows_per_device: int):
    """Distributed equi-join of a probe side against a build side with
    UNIQUE keys: both repartition by key hash, then each shard sorts its
    build keys and binary-searches its probes.  -> (probe_keys,
    probe_vals, joined_build_vals, hit, overflow) per shard.  Build keys
    must be below the int64 maximum (the empty-slot sentinel)."""
    n = mesh.n
    pcap = max(1, (2 * probe_rows_per_device) // n)
    bcap = max(1, (2 * build_rows_per_device) // n)

    def step(probe_keys, probe_vals, build_keys, build_vals):
        pk, pv, pm, povf = _exchange_by_dest(mesh, pcap, probe_keys,
                                             (probe_vals,))
        bk, bv, bm, bovf = _exchange_by_dest(mesh, bcap, build_keys,
                                             (build_vals,))
        joined, hits, ovf = [], [], []
        for d in range(n):
            bks = torch.where(bm[d], bk[d], _I64_MAX)
            bks, order = torch.sort(bks)
            bvs = bv[d][order]
            pos = torch.searchsorted(bks, pk[d]).clamp(0, bks.shape[0] - 1)
            hit = (bks[pos] == pk[d]) & pm[d]
            joined.append(torch.where(hit, bvs[pos], 0))
            hits.append(hit)
            ovf.append(povf[d] + bovf[d].to(povf[d].device))
        return pk, pv, joined, hits, ovf

    return step


def _local_combine(keys: torch.Tensor, values: torch.Tensor,
                   valid: torch.Tensor):
    """Sort + segment-sum one shard's rows to (unique key, partial sum)
    pairs packed at the front; rows past the unique count hold the
    sentinel and 0."""
    k = torch.where(valid, keys, _I64_MAX)
    ks, order = torch.sort(k)
    vs = torch.where(valid, values, 0)[order]
    first = torch.ones_like(ks, dtype=torch.bool)
    first[1:] = ks[1:] != ks[:-1]
    seg = torch.cumsum(first.to(torch.int64), 0) - 1
    m = ks.shape[0]
    uk = torch.full((m,), _I64_MAX, dtype=ks.dtype, device=ks.device
                    ).scatter_reduce_(0, seg, ks, "amin")
    us = torch.zeros(m, dtype=vs.dtype, device=vs.device).index_add_(
        0, seg, vs)
    return uk, us, uk != _I64_MAX


def dist_agg_by_key(mesh: Mesh, rows_per_device: int):
    """Distributed SUM by key, skew-resistant: each shard combines its
    own rows to one partial per key BEFORE the shuffle, so a heavy key
    ships at most one row per source; the owners combine the partials.
    -> (keys, sums, mask, overflow) per shard.  Keys must be below the
    int64 maximum."""
    n = mesh.n
    cap = max(1, (2 * rows_per_device) // n)

    def step(keys, values):
        uk, us, uv = zip(*(_local_combine(k, v, torch.ones_like(
            k, dtype=torch.bool)) for k, v in zip(keys, values)))
        rk, rv, rm, ovf = _exchange_by_dest(mesh, cap, list(uk), (list(us),),
                                            valid=list(uv))
        fk, fs, fv = zip(*(_local_combine(k, v, m)
                           for k, v, m in zip(rk, rv, rm)))
        return list(fk), list(fs), list(fv), ovf

    return step
