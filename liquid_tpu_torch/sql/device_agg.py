"""Classic-path aggregation on the device, and the group-key codecs (port
of `liquid_tpu/sql/device_agg.py`).

`DeviceGroupedAggregator` and `DeviceScalarAggregator` have the
interfaces of `physical.GroupedAggregator` / `ScalarAggregator` and run
the grouping and the reductions on the engine's device: the hash table
first (`ops.hashagg.hash_group_reduce_packed`, one packed fetch), a
second salt on a bigger table, then the sort-based `ops.groupby.
group_reduce`.  Key and value columns cross from arrow to the device as
int64 code images with NULL flags (`KeyCodec`); strings group by
incremental global dictionary codes, built per chunk from arrow
dictionary indices.

`HybridGroupedAggregator` / `HybridScalarAggregator` take the device
aggregator when every aggregate kind and column type has a device form
(`DEVICE_KINDS`) and the pyarrow one otherwise (count(DISTINCT), median,
string min/max).  The reference sends both to pyarrow on a TPU
(`_prefer_host`, a TPU-era measurement); the port runs them on whatever
device the engine runs on, the card included.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import torch

from liquid_tpu_torch.ops import groupby as gops
from liquid_tpu_torch.ops import hashagg as hops
from liquid_tpu_torch.utils.tracing import TRACER, to_device, to_host

#: aggregate kinds the device path implements
DEVICE_KINDS = frozenset(
    {"count_star", "count", "sum", "avg", "min", "max", "stddev", "var"})

#: module counters (tests and the smoke assert routing on them):
#: device updates in all and of the grouped aggregator, pyarrow
#: aggregators chosen, rows, hash tables defeated (sorted instead)
STATS = {"device_agg_updates": 0, "device_grouped_updates": 0,
         "fallback_agg_updates": 0, "device_agg_rows": 0,
         "hash_agg_fallbacks": 0}


class DeviceUnsupported(Exception):
    """A column type with no code image."""


class KeyCodec:
    """Encode an arrow column as (int64 code image, NULL flags); decode
    packed group keys back to an arrow array of the original type.
    Integers and dates code as their values, floats as canonical IEEE
    bits, strings as ids of a global vocabulary grown per chunk."""

    def __init__(self, typ: pa.DataType):
        self.type = typ
        t = typ
        if pa.types.is_dictionary(t):
            t = t.value_type
        self._vt = t
        if pa.types.is_string(t) or pa.types.is_large_string(t):
            self._kind = "str"
            self._vocab: Dict[str, int] = {}
            self._vocab_list: List[str] = []
        elif pa.types.is_integer(t):
            self._kind = "int"
        elif pa.types.is_floating(t):
            self._kind = "float"
        elif pa.types.is_date32(t):
            self._kind = "date32"
        elif pa.types.is_date64(t) or pa.types.is_timestamp(t):
            self._kind = "i64like"
        elif pa.types.is_boolean(t):
            self._kind = "bool"
        else:
            raise DeviceUnsupported(f"group key type {t}")

    def encode(self, arr: pa.Array) -> Tuple[np.ndarray, np.ndarray]:
        if pa.types.is_dictionary(arr.type):
            arr = arr.cast(arr.type.value_type)
        nulls = np.asarray(arr.is_null())
        k = self._kind
        if k == "str":
            enc = pc.dictionary_encode(arr)
            if isinstance(enc, pa.ChunkedArray):
                enc = enc.combine_chunks()
            dict_vals = enc.dictionary.to_pylist()
            ids = np.empty(len(dict_vals), np.int64)
            for i, v in enumerate(dict_vals):
                gid = self._vocab.get(v)
                if gid is None:
                    gid = len(self._vocab_list)
                    self._vocab[v] = gid
                    self._vocab_list.append(v)
                ids[i] = gid
            idx = np.asarray(enc.indices.fill_null(0)).astype(np.int64)
            codes = ids[idx] if len(dict_vals) else np.zeros(len(arr),
                                                            np.int64)
        elif k == "int":
            if pa.types.is_uint64(arr.type):
                codes = np.asarray(arr.fill_null(0)).view(np.int64).copy()
            else:
                codes = np.asarray(
                    arr.fill_null(0).cast(pa.int64(), safe=False))
        elif k == "float":
            f = np.asarray(arr.fill_null(0.0).cast(pa.float64())).copy()
            f[np.isnan(f)] = np.nan      # canonical NaN bit pattern
            f = f + 0.0                  # -0.0 -> +0.0
            codes = f.view(np.int64)
        elif k == "date32":
            codes = np.asarray(
                arr.fill_null(0).cast(pa.int32())).astype(np.int64)
        elif k == "i64like":
            codes = np.asarray(arr.fill_null(0).view(pa.int64()))
        else:  # bool
            codes = np.asarray(
                arr.fill_null(False).cast(pa.int8())).astype(np.int64)
        codes = np.where(nulls, np.int64(0), codes)
        return np.ascontiguousarray(codes, np.int64), nulls

    def decode(self, codes: np.ndarray, nulls: np.ndarray) -> pa.Array:
        k = self._kind
        mask = nulls if nulls.any() else None
        if k == "str":
            vocab = pa.array(self._vocab_list, type=self._vt)
            out = vocab.take(pa.array(np.where(nulls, 0, codes), pa.int64()))
            if mask is not None:
                out = pc.if_else(pa.array(~nulls), out,
                                 pa.scalar(None, self._vt))
            return out
        if k == "int":
            if pa.types.is_uint64(self._vt):
                return pa.array(codes.view(np.uint64), self._vt, mask=mask)
            return pa.array(codes, pa.int64(), mask=mask).cast(
                self._vt, safe=False)
        if k == "float":
            return pa.array(codes.view(np.float64), pa.float64(),
                            mask=mask).cast(self._vt)
        if k == "date32":
            return pa.array(codes.astype(np.int32), pa.int32(),
                            mask=mask).view(pa.date32())
        if k == "i64like":
            return pa.array(codes, pa.int64(), mask=mask).view(self._vt)
        return pa.array(codes != 0, pa.bool_(), mask=mask)  # bool


def _prefer_host(device) -> bool:
    """Host-resident post-aggregate work (a sort over a result table)
    stays on the host when the engine runs on an accelerator: a round
    trip to the card per small table costs more than the work, as the
    reference finds on a TPU.  On the CPU the device path is the host
    anyway, so it stays."""
    return torch.device(device).type != "cpu"


def _sum_accum_dtype(t: pa.DataType):
    if pa.types.is_floating(t):
        return np.float64, pa.float64()
    if pa.types.is_unsigned_integer(t):
        return np.uint64, pa.uint64()
    if pa.types.is_integer(t) or pa.types.is_boolean(t):
        return np.int64, pa.int64()
    raise DeviceUnsupported(f"sum over {t}")


def _minmax_conv(t: pa.DataType):
    """(numpy accumulation dtype, decode fn) for MIN / MAX inputs.  A
    uint64 input has no device form: its order is not the int64 image's."""
    if pa.types.is_dictionary(t):
        t = t.value_type
    if pa.types.is_floating(t):
        return np.float64, lambda v, m: pa.array(v, pa.float64(),
                                                 mask=m).cast(t)
    if pa.types.is_integer(t) and not pa.types.is_uint64(t) \
            or pa.types.is_boolean(t):
        tt = pa.int64() if pa.types.is_boolean(t) else t
        return np.int64, lambda v, m: pa.array(v, pa.int64(), mask=m).cast(
            tt, safe=False)
    if pa.types.is_date32(t):
        return np.int64, lambda v, m: pa.array(
            v.astype(np.int32), pa.int32(), mask=m).view(pa.date32())
    if pa.types.is_date64(t) or pa.types.is_timestamp(t):
        return np.int64, lambda v, m: pa.array(v, pa.int64(), mask=m).view(t)
    raise DeviceUnsupported(f"min/max over {t}")


def _np_values(arr: pa.Array, dtype) -> Tuple[np.ndarray, np.ndarray]:
    """(values as dtype with NULLs zeroed, NULL flags)."""
    if pa.types.is_dictionary(arr.type):
        arr = arr.cast(arr.type.value_type)
    nulls = np.asarray(arr.is_null())
    t = arr.type
    if pa.types.is_boolean(t):
        base = np.asarray(arr.fill_null(False)).astype(dtype)
    elif pa.types.is_date32(t):
        base = np.asarray(arr.fill_null(0).cast(pa.int32())).astype(dtype)
    elif pa.types.is_date64(t) or pa.types.is_timestamp(t):
        base = np.asarray(arr.fill_null(0).view(pa.int64())).astype(dtype)
    elif pa.types.is_floating(t) or pa.types.is_integer(t):
        base = np.asarray(arr.fill_null(0).cast(
            pa.float64() if dtype == np.float64 else
            pa.uint64() if dtype == np.uint64 else pa.int64(), safe=False))
        base = base.astype(dtype, copy=False)
    else:
        raise DeviceUnsupported(f"aggregate input type {t}")
    return np.where(nulls, dtype(0), base), nulls


def _to_dev(a: np.ndarray, device) -> torch.Tensor:
    """numpy -> tensor on `device`; uint64 rides as its int64 image (sums
    wrap alike)."""
    if a.dtype == np.uint64:
        a = a.view(np.int64)
    return to_device(torch.from_numpy(np.ascontiguousarray(a)), device)


def _from_dev(t: torch.Tensor, dtype) -> np.ndarray:
    a = to_host(t).numpy()
    return a.view(np.uint64) if np.dtype(dtype) == np.uint64 else a


# -- reduce-slot planning ------------------------------------------------------

class _RSlot:
    """One device reduction column derived from an AggSlot."""

    def __init__(self, agg_name: str, role: str, kind: str, dtype):
        self.agg_name = agg_name   # owning AggSlot output name
        self.role = role           # value | value_ones | sumsq | ones
        self.kind = kind           # sum | min | max
        self.dtype = dtype


def _base_type(arr: pa.Array) -> pa.DataType:
    t = arr.type
    return t.value_type if pa.types.is_dictionary(t) else t


def _plan_rslots(slots, input_arrs: Dict[str, pa.Array]):
    """AggSlots -> device reduce slots; raises DeviceUnsupported when a
    slot or type has no device form."""
    rslots: List[_RSlot] = []
    decoders: Dict[str, object] = {}
    for s in slots:
        if s.kind not in DEVICE_KINDS:
            raise DeviceUnsupported(s.kind)
        if s.kind == "count_star":
            rslots.append(_RSlot(s.name, "ones", "sum", np.int64))
        elif s.kind == "count":
            rslots.append(_RSlot(s.name, "value_ones", "sum", np.int64))
        elif s.kind == "sum":
            npdt, padt = _sum_accum_dtype(_base_type(input_arrs[s.name]))
            decoders[s.name] = padt
            rslots.append(_RSlot(s.name, "value", "sum", npdt))
        elif s.kind == "avg":
            rslots.append(_RSlot(s.name, "value", "sum", np.float64))
        elif s.kind in ("min", "max"):
            npdt, dec = _minmax_conv(input_arrs[s.name].type)
            decoders[s.name] = dec
            rslots.append(_RSlot(s.name, "value", s.kind, npdt))
        else:  # stddev, var
            rslots.append(_RSlot(s.name, "value", "sum", np.float64))
            rslots.append(_RSlot(s.name, "sumsq", "sum", np.float64))
    return rslots, decoders


def _rslot_values(r: _RSlot, inputs, n_rows: int):
    """(values, NULL flags) of one reduce slot over a chunk."""
    if r.role == "ones":
        return np.ones(n_rows, r.dtype), np.zeros(n_rows, bool)
    if r.role == "value_ones":
        _, nulls = _np_values(inputs[r.agg_name], np.int64)
        return np.ones(n_rows, r.dtype), nulls
    if r.role == "sumsq":
        v, nulls = _np_values(inputs[r.agg_name], np.float64)
        return v * v, nulls
    return _np_values(inputs[r.agg_name], r.dtype)


# -- grouped device aggregator -------------------------------------------------

class DeviceGroupedAggregator:
    """Drop-in for `physical.GroupedAggregator`: buffers converted chunks
    and runs ONE grouped reduction on the device at finalize; past
    COMPACT_ROWS buffered rows the buffer is pre-reduced, so memory stays
    proportional to the distinct groups."""

    COMPACT_ROWS = 1 << 22

    def __init__(self, key_names: List[str], slots, device):
        self.key_names = key_names
        self.slots = slots
        self.device = torch.device(device)
        self._codecs: Optional[List[KeyCodec]] = None
        self._rslots: Optional[List[_RSlot]] = None
        self._decoders: Dict[str, object] = {}
        self._key_types: Optional[List[pa.DataType]] = None
        self._input_types: Dict[str, pa.DataType] = {}
        # buffered chunks: per key code / NULL lists, per rslot value / NULL
        self._kcodes: List[List[np.ndarray]] = []
        self._knulls: List[List[np.ndarray]] = []
        self._vals: List[List[np.ndarray]] = []
        self._vnulls: List[List[np.ndarray]] = []
        self._rows = 0
        # pre-reduced partial states (kcodes, knulls, vals, vcounts)
        self._partial = None
        self._hash_dirty = False  # the hash table lost: sort from now on

    def update(self, keys: List[pa.Array], inputs: Dict[str, pa.Array],
               n_rows: int) -> None:
        if self._codecs is None:
            self._codecs = [KeyCodec(a.type) for a in keys]
            self._key_types = [_base_type(a) for a in keys]
            self._rslots, self._decoders = _plan_rslots(self.slots, inputs)
        for s in self.slots:
            if s.input is not None and s.name in inputs:
                self._input_types.setdefault(
                    s.name, _base_type(inputs[s.name]))
        kc, kn = [], []
        for codec, arr in zip(self._codecs, keys):
            c, nl = codec.encode(arr)
            kc.append(c)
            kn.append(nl)
        vs, vn = [], []
        for r in self._rslots:
            v, nl = _rslot_values(r, inputs, n_rows)
            vs.append(v)
            vn.append(nl)
        self._kcodes.append(kc)
        self._knulls.append(kn)
        self._vals.append(vs)
        self._vnulls.append(vn)
        self._rows += n_rows
        STATS["device_agg_updates"] += 1
        STATS["device_grouped_updates"] += 1
        STATS["device_agg_rows"] += n_rows
        if self._rows >= self.COMPACT_ROWS:
            self._compact()

    # -- device reduction ------------------------------------------------------

    def _gather_buffers(self):
        """Buffered chunks (and any prior partial) as flat arrays; raw rows
        count 1 per non-null input, partials carry their counts."""
        nk, nr = len(self._codecs), len(self._rslots)

        def cat(chunks, j, dtype):
            return np.concatenate([c[j] for c in chunks]) if chunks \
                else np.zeros(0, dtype)

        kcodes = [cat(self._kcodes, k, np.int64) for k in range(nk)]
        knulls = [cat(self._knulls, k, bool) for k in range(nk)]
        vals = [cat(self._vals, j, self._rslots[j].dtype) for j in range(nr)]
        vnulls = [cat(self._vnulls, j, bool) for j in range(nr)]
        counts = [(~vn).astype(np.int64) for vn in vnulls]
        if self._partial is not None:
            pk, pn, pv, pcnt = self._partial
            kcodes = [np.concatenate([a, b]) for a, b in zip(kcodes, pk)]
            knulls = [np.concatenate([a, b]) for a, b in zip(knulls, pn)]
            vals = [np.concatenate([a, b]) for a, b in zip(vals, pv)]
            # partial states are never NULL inputs: their counts tell
            vnulls = [np.concatenate([a, np.zeros(len(pv[0]), bool)])
                      for a in vnulls]
            counts = [np.concatenate([a, b]) for a, b in zip(counts, pcnt)]
        return kcodes, knulls, vals, vnulls, counts

    @TRACER.trace("agg.reduce")
    def _reduce(self):
        """One grouped reduction over everything buffered -> (g, ukeys,
        uknulls, outs, vcounts) as numpy, sliced to the g groups."""
        kcodes, knulls, vals, vnulls, counts = self._gather_buffers()
        n = len(kcodes[0]) if kcodes else (len(vals[0]) if vals else 0)
        nr = len(self._rslots)
        if n == 0:
            return (0, [np.zeros(0, np.int64)] * len(kcodes),
                    [np.zeros(0, bool)] * len(kcodes),
                    [np.zeros(0, r.dtype) for r in self._rslots],
                    [np.zeros(0, np.int64) for _ in self._rslots])
        m = gops.pad_pow2(n)
        pad = m - n
        dev = self.device

        def padc(a):
            return np.concatenate([a, np.zeros(pad, a.dtype)]) if pad else a

        valid = np.zeros(m, bool)
        valid[:n] = True
        kinds = tuple(r.kind for r in self._rslots) + ("sum",) * nr
        dvals = tuple(_to_dev(padc(v), dev) for v in vals) + tuple(
            _to_dev(padc(c), dev) for c in counts)
        dvnulls = tuple(_to_dev(padc(v), dev) for v in vnulls) + tuple(
            torch.zeros(m, dtype=torch.bool, device=dev) for _ in counts)
        dcodes = tuple(_to_dev(padc(c), dev) for c in kcodes)
        dknulls = tuple(_to_dev(padc(k), dev) for k in knulls)
        dvalid = _to_dev(valid, dev)
        nk, nv = len(dcodes), len(dvals)
        if dcodes and not self._hash_dirty:
            # the hash table first; a dirty table retries once with more
            # slots and a new salt, then the sort decides
            h0 = hops.pick_slots(n)
            for n_slots, salt in ((h0, 0x9E3779B97F4A7C15),
                                  (min(4 * h0, hops.MAX_SLOTS),
                                   0xC2B2AE3D27D4EB4F)):
                mat_d, _c, _g, ukeys, uknulls, outs, _vc = \
                    hops.hash_group_reduce_packed(
                        dcodes, dknulls, dvalid, dvals, dvnulls, kinds,
                        n_slots, salt)
                mat = to_host(mat_d).numpy()
                if mat[0, 0]:
                    g = int(mat[0, 1])
                    if g <= mat.shape[1]:
                        return self._unpack_hash(mat, nk, nv)
                    # more groups than the packed width: fetch them all
                    return (g, [to_host(u[:g]).numpy() for u in ukeys],
                            [to_host(u[:g]).numpy() for u in uknulls],
                            [_from_dev(o[:g], r.dtype)
                             for o, r in zip(outs[:nr], self._rslots)],
                            [to_host(o[:g]).numpy() for o in outs[nr:]])
                if n_slots == hops.MAX_SLOTS:
                    break
            self._hash_dirty = True
            STATS["hash_agg_fallbacks"] += 1
        ng, ukeys, uknulls, outs, _vc = gops.group_reduce(
            dcodes, dknulls, dvalid, dvals, dvnulls, kinds)
        g = int(to_host(ng))
        return (g, [to_host(u[:g]).numpy() for u in ukeys],
                [to_host(u[:g]).numpy() for u in uknulls],
                [_from_dev(o[:g], r.dtype)
                 for o, r in zip(outs[:nr], self._rslots)],
                [to_host(o[:g]).numpy() for o in outs[nr:]])

    def _unpack_hash(self, mat: np.ndarray, nk: int, nv: int):
        """Parse the packed matrix (row 0 the header, then ukeys, uknulls,
        outs, counts; f64 / u64 rows bitcast back)."""
        g = int(mat[0, 1])
        r = 1
        ukeys = [mat[r + i][:g] for i in range(nk)]
        r += nk
        uknulls = [mat[r + i][:g].astype(bool) for i in range(nk)]
        r += nk
        nr = len(self._rslots)
        outs = []
        for j in range(nv):
            row = mat[r + j][:g]
            if j < nr:
                dt = np.dtype(self._rslots[j].dtype)
                if dt in (np.float64, np.uint64):
                    row = row.view(dt)
            outs.append(row)
        return g, ukeys, uknulls, outs[:nr], outs[nr:]

    def _compact(self) -> None:
        _g, uk, un, outs, cnts = self._reduce()
        self._partial = (uk, un, outs, cnts)
        self._kcodes, self._knulls = [], []
        self._vals, self._vnulls = [], []
        self._rows = 0

    # -- finalize ----------------------------------------------------------------

    def finalize(self) -> pa.Table:
        if self._codecs is None:
            return self._empty_typed()
        _g, uk, un, outs, cnts = self._reduce()
        cols: Dict[str, pa.Array] = {}
        for nm, codec, codes, nulls in zip(self.key_names, self._codecs,
                                           uk, un):
            cols[nm] = codec.decode(codes, nulls)
        j = 0
        for s in self.slots:
            mask = cnts[j] == 0  # no non-null input: a NULL result
            if s.kind in ("count_star", "count"):
                cols[s.name] = pa.array(outs[j], pa.int64())
                j += 1
            elif s.kind == "sum":
                cols[s.name] = pa.array(outs[j], self._decoders[s.name],
                                        mask=mask if mask.any() else None)
                j += 1
            elif s.kind == "avg":
                with np.errstate(invalid="ignore", divide="ignore"):
                    v = outs[j] / cnts[j].astype(np.float64)
                cols[s.name] = pa.array(v, pa.float64(),
                                        mask=mask if mask.any() else None)
                j += 1
            elif s.kind in ("min", "max"):
                cols[s.name] = self._decoders[s.name](
                    outs[j], mask if mask.any() else None)
                j += 1
            else:  # stddev, var
                ss, qq = outs[j], outs[j + 1]
                cc = cnts[j].astype(np.float64)
                with np.errstate(invalid="ignore", divide="ignore"):
                    var = (qq - ss * ss / cc) / (cc - 1.0)
                var = np.maximum(var, 0.0)  # rounding jitter
                v = np.sqrt(var) if s.kind == "stddev" else var
                m1 = cnts[j] <= 1
                cols[s.name] = pa.array(v, pa.float64(),
                                        mask=m1 if m1.any() else None)
                j += 2
        return pa.table(cols)

    def _empty_typed(self) -> pa.Table:
        cols = {}
        kts = self._key_types or [pa.null()] * len(self.key_names)
        for nm, t in zip(self.key_names, kts):
            cols[nm] = pa.array([], t)
        for s in self.slots:
            if s.kind in ("count_star", "count"):
                cols[s.name] = pa.array([], pa.int64())
            elif s.kind in ("avg", "stddev", "var"):
                cols[s.name] = pa.array([], pa.float64())
            elif s.kind == "sum":
                cols[s.name] = pa.array(
                    [], self._decoders.get(s.name, pa.int64()))
            else:
                cols[s.name] = pa.array(
                    [], self._input_types.get(s.name, pa.null()))
        return pa.table(cols)


# -- scalar (no GROUP BY) device aggregator -------------------------------------

class DeviceScalarAggregator:
    """Drop-in for `physical.ScalarAggregator`: per-chunk device
    reductions merged on the device, fetched once at finalize."""

    def __init__(self, slots, device):
        self.slots = slots
        self.device = torch.device(device)
        self._rslots: Optional[List[_RSlot]] = None
        self._decoders: Dict[str, object] = {}
        self._state: Optional[list] = None   # per rslot device scalar
        self._counts: Optional[list] = None  # per rslot device count
        self._star_rows = 0

    def update(self, inputs: Dict[str, pa.Array], n_rows: int) -> None:
        if self._rslots is None:
            self._rslots, self._decoders = _plan_rslots(self.slots, inputs)
        STATS["device_agg_updates"] += 1
        STATS["device_agg_rows"] += n_rows
        self._star_rows += n_rows
        live = [(j, r) for j, r in enumerate(self._rslots)
                if r.role != "ones"]
        if not live or n_rows == 0:
            return
        vs, vn = [], []
        for _, r in live:
            v, nl = _rslot_values(r, inputs, n_rows)
            vs.append(_to_dev(v, self.device))
            vn.append(_to_dev(nl, self.device))
        outs, counts = gops.scalar_reduce(
            torch.ones(n_rows, dtype=torch.bool, device=self.device),
            vs, vn, tuple(r.kind for _, r in live))
        if self._state is None:
            self._state = [None] * len(self._rslots)
            self._counts = [None] * len(self._rslots)
        for (j, r), o, c in zip(live, outs, counts):
            if self._state[j] is None:
                self._state[j], self._counts[j] = o, c
                continue
            if r.kind == "sum":
                self._state[j] = self._state[j] + o
            elif r.kind == "min":
                self._state[j] = torch.minimum(self._state[j], o)
            else:
                self._state[j] = torch.maximum(self._state[j], o)
            self._counts[j] = self._counts[j] + c

    def finalize(self, input_types: Dict[str, pa.DataType]) -> pa.Table:
        if self._rslots is None:
            self._rslots, self._decoders = _plan_rslots(self.slots, {})
        state = counts = None
        if self._state is not None:
            # one fetch for every slot's value and count
            state = [None if s is None else _from_dev(s, r.dtype)[()]
                     for s, r in zip(self._state, self._rslots)]
            counts = [0 if c is None else int(to_host(c))
                      for c in self._counts]
        cols = {}
        j = 0
        for s in self.slots:
            st = None if state is None else state[j]
            cnt = 0 if st is None else counts[j]
            if s.kind == "count_star":
                cols[s.name] = pa.array([self._star_rows], pa.int64())
            elif s.kind == "count":
                cols[s.name] = pa.array([cnt], pa.int64())
            elif s.kind == "sum":
                cols[s.name] = pa.array(
                    np.array([st if cnt else 0]), self._decoders[s.name],
                    mask=np.array([cnt == 0]))
            elif s.kind == "avg":
                cols[s.name] = pa.array(
                    [None if cnt == 0 else float(st) / cnt], pa.float64())
            elif s.kind in ("min", "max"):
                v = np.array([st if cnt else 0])
                v = v.astype(np.asarray(st).dtype if st is not None
                             else np.int64)
                cols[s.name] = self._decoders[s.name](v, np.array([cnt == 0]))
            else:  # stddev, var
                v = None
                if cnt > 1:
                    ss, qq = float(st), float(state[j + 1])
                    var = max((qq - ss * ss / cnt) / (cnt - 1), 0.0)
                    v = var ** 0.5 if s.kind == "stddev" else var
                cols[s.name] = pa.array([v], pa.float64())
            j += 2 if s.kind in ("stddev", "var") else 1
        return pa.table(cols)


# -- hybrid routing ---------------------------------------------------------------

class HybridGroupedAggregator:
    """The device aggregator when every kind and type has a device form,
    else the pyarrow `physical.GroupedAggregator`; decided on the first
    update (types are stable across one query's chunks)."""

    def __init__(self, key_names: List[str], slots, device):
        self.key_names = key_names
        self.slots = slots
        self.device = device
        self._impl = None
        self._device_ok = all(s.kind in DEVICE_KINDS for s in slots)

    def update(self, keys, inputs, n_rows) -> None:
        if self._impl is None:
            if self._device_ok:
                try:
                    impl = DeviceGroupedAggregator(self.key_names, self.slots,
                                                   self.device)
                    impl.update(keys, inputs, n_rows)
                    self._impl = impl
                    return
                except DeviceUnsupported:
                    pass
            from liquid_tpu_torch.sql.physical import GroupedAggregator
            self._impl = GroupedAggregator(self.key_names, self.slots)
            STATS["fallback_agg_updates"] += 1
        self._impl.update(keys, inputs, n_rows)

    def finalize(self) -> pa.Table:
        if self._impl is None:
            # no update: the pyarrow aggregator types the empty result
            from liquid_tpu_torch.sql.physical import GroupedAggregator
            self._impl = GroupedAggregator(self.key_names, self.slots)
        return self._impl.finalize()


class HybridScalarAggregator:
    def __init__(self, slots, device):
        self.slots = slots
        self.device = device
        self._impl = None
        self._device_ok = all(s.kind in DEVICE_KINDS for s in slots)

    def update(self, inputs, n_rows) -> None:
        if self._impl is None:
            if self._device_ok:
                try:
                    impl = DeviceScalarAggregator(self.slots, self.device)
                    impl.update(inputs, n_rows)
                    self._impl = impl
                    return
                except DeviceUnsupported:
                    pass
            from liquid_tpu_torch.sql.physical import ScalarAggregator
            self._impl = ScalarAggregator(self.slots)
            STATS["fallback_agg_updates"] += 1
        self._impl.update(inputs, n_rows)

    def finalize(self, input_types) -> pa.Table:
        if self._impl is None:
            from liquid_tpu_torch.sql.physical import ScalarAggregator
            self._impl = ScalarAggregator(self.slots)
        return self._impl.finalize(input_types)
