"""Distributed SQL over encoded, row-sharded tables on a mesh (port of
`liquid_tpu/parallel/session.py`).

Columns live encoded on the mesh, one shard per device: integers, dates,
timestamps and booleans as bit-planes offset from the column's minimum
(rows padded to 32 x shards, so each shard holds whole words), strings as
int32 codes into a table-wide vocabulary, floats as float64, each with a
packed validity mask.  A query runs as per-shard steps whose partial
tables merge with `psum` / `pmin` / `pmax`:

- a shard's comparisons on integer columns are one launch of K4's fused
  form over its planes (`bitpack_cuda.select_planes`, two bounds on one
  column reading it once); float and string comparisons are packed
  elementwise masks (a string comparison is a boolean table over the
  vocabulary, evaluated once on the host);
- GROUP BY addresses small key domains directly and hashes the rest with
  exact collision detection: a slot is trusted only if the merged per-slot
  key min equals the max, and the rows of dirty slots retry with a new
  salt (`hash_rounds`);
- NULLs are first-class: comparisons exclude them, NULL keys form their
  own group, aggregates skip them.

Joins, and single-table shapes the direct planner does not take (residual
boolean conditions, projections, expression keys), run through
`parallel/join.py`.  A shape neither takes raises `MeshUnsupported`, and
`sql()` answers exactly that one on the single-device engine
(`LiquidCacheLocalBuilder`, on the mesh's first device), counting it in
`route_stats`; any other error propagates.  `LIQUID_DIST_STRICT=1` makes
`MeshUnsupported` propagate too.
"""
from __future__ import annotations

import copy
import datetime
import math
import os
import tempfile
from typing import Dict, List, Optional, Tuple

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import torch

from liquid_tpu_torch.device import srl, words_to_tensor, wrap_i64
from liquid_tpu_torch.ops import bitpack as bp
from liquid_tpu_torch.ops import bitpack_cuda
from liquid_tpu_torch.ops import mask as mops
from liquid_tpu_torch.ops.floatbits import f64_bits
from liquid_tpu_torch.ops.groupby import _neutral
from liquid_tpu_torch.parallel import dist
from liquid_tpu_torch.parallel.dist import MeshUnsupported
from liquid_tpu_torch.sql import ast
from liquid_tpu_torch.sql.physical import AGG_FUNCS, find_aggs, render, \
    substitute
from liquid_tpu_torch.sql.planner import _literal_value, split_conjuncts

#: unmodified TPC-DS queries the reference runs distributed (its strict
#: probe); the port's phase 6i and tests pin the same set
DIST_TPCDS_SUPPORTED = (3, 7, 13, 26, 37, 42, 52, 55, 82, 96)

_CMP = {"=": "eq", "<>": "ne", "!=": "ne", "<": "lt", "<=": "le",
        ">": "gt", ">=": "ge"}

#: hash-table growth schedule: (slots, salt); every stage is exact
#: (collision-checked), later ones cost more memory and scatter width.
#: The reference's three stages, then the single-device engine's fourth
#: (`fused_agg._STAGES`) and a fifth: TPC-H q18's inner GROUP BY
#: l_orderkey has 1.5M groups at SF1 (the single-device engine addresses
#: that key directly), and three rounds over 4M slots leave ~500 of them
#: unresolved, over 16M slots none
_HASH_STAGES = ((1 << 13, 0x9E3779B97F4A7C15),
                (1 << 17, 0xC2B2AE3D27D4EB4F),
                (1 << 20, 0x165667B19E3779F9),
                (1 << 22, 0x27D4EB2F165667C5),
                (1 << 24, 0x94D049BB133111EB))

#: the int64 image of bit 63: XOR-ing it into an offset makes the signed
#: order of int64 the unsigned order of the offsets (encoded min / max)
_SIGN = -(1 << 63)

#: IN (SELECT ...) results longer than this stay subqueries (as in the
#: reference)
IN_LIST_MAX = 200_000


class ShardedColumn:
    """One table column resident on the mesh in encoded form; every
    device field is a list with one tensor per shard."""

    __slots__ = ("kind", "planes", "ref", "width", "data", "codes",
                 "dictionary", "valid", "arrow_type", "has_nulls", "_vocab")

    def __init__(self, kind: str, arrow_type: pa.DataType):
        self.kind = kind              # "planes" | "float" | "dict" | "host"
        self.arrow_type = arrow_type
        self.planes = None            # int32[bucket, W/n] per shard
        self.ref = 0                  # python int reference value
        self.width = 0
        self.data = None              # float64[N/n] per shard
        self.codes = None             # int32[N/n] per shard
        self.dictionary = None        # list[str], table-wide
        self.valid = None             # int32[W/n] packed validity, or None
        self.has_nulls = False
        self._vocab = None

    def vocab(self) -> pa.Array:
        """The dictionary as an arrow array (decode by `take`)."""
        if self._vocab is None:
            self._vocab = pa.array(self.dictionary, self.arrow_type)
        return self._vocab

    def device_bytes(self) -> int:
        """Bytes a scan of this column reads over all shards (encoded
        shards read width/32 of a raw 8-byte row)."""
        n = 0
        for parts in (self.planes, self.data, self.codes, self.valid):
            if parts is not None:
                n += sum(p.numel() * p.element_size() for p in parts)
        return n


def _int_code_image(col: pa.Array) -> Tuple[np.ndarray, pa.DataType]:
    """Arrow integer-like column -> exact int64 bit image + type."""
    t = col.type
    if pa.types.is_boolean(t):
        return np.asarray(col.fill_null(False)).astype(np.int64), t
    if pa.types.is_date32(t):
        return np.asarray(col.fill_null(0).cast(pa.int32())).astype(
            np.int64), t
    if pa.types.is_date64(t) or pa.types.is_timestamp(t):
        return np.asarray(col.view(pa.int64()).fill_null(0)), t
    if pa.types.is_uint64(t):
        return np.asarray(col.fill_null(0)).view(np.int64).copy(), t
    return np.asarray(col.fill_null(0).cast(pa.int64(), safe=False)), t


def _int_like(t: pa.DataType) -> bool:
    return (pa.types.is_integer(t) or pa.types.is_boolean(t)
            or pa.types.is_date32(t) or pa.types.is_date64(t)
            or pa.types.is_timestamp(t))


def _restore_int(vals: np.ndarray, nulls: Optional[np.ndarray],
                 t: pa.DataType) -> pa.Array:
    """Decode int64 bit images back to the original arrow type."""
    mask = nulls if nulls is not None and nulls.any() else None
    vals = np.asarray(vals, dtype=np.int64)
    if pa.types.is_boolean(t):
        return pa.array(vals != 0, pa.bool_(), mask=mask)
    if pa.types.is_date32(t):
        return pa.array(vals.astype(np.int32), pa.int32(),
                        mask=mask).view(pa.date32())
    if pa.types.is_date64(t) or pa.types.is_timestamp(t):
        return pa.array(vals, pa.int64(), mask=mask).view(t)
    if pa.types.is_uint64(t):
        return pa.array(vals.view(np.uint64), t, mask=mask)
    return pa.array(vals, pa.int64(), mask=mask).cast(t, safe=False)


def _ref_i64(ref: int) -> int:
    """Reference value as a wrapped signed-64 python int (uint64 columns
    store refs above 2^63; the device add wraps identically)."""
    return wrap_i64(ref)


class DistributedTable:
    def __init__(self, mesh, table: pa.Table):
        self.mesh = mesh
        n_dev = mesh.n
        self.n_dev = n_dev
        n = table.num_rows
        # rows pad to a multiple of 32 x shards, so each shard holds whole
        # uint32 words of every packed array
        pad = (-n) % (32 * n_dev)
        self.num_rows = n
        self.padded = n + pad
        rowvalid = np.zeros(self.padded, dtype=bool)
        rowvalid[:n] = True
        self.valid = self._shard_words(mops.pack_bools_host(rowvalid))
        self.columns: Dict[str, ShardedColumn] = {}
        for name in table.column_names:
            col = table.column(name).combine_chunks()
            self.columns[name] = self._shard_column(col, pad)

    def _shard_words(self, words: np.ndarray, axis: int = 0):
        return dist.shard_rows(self.mesh, words_to_tensor(words), axis)

    def _shard_column(self, col: pa.Array, pad: int) -> ShardedColumn:
        t = col.type
        nulls = np.zeros(self.padded, bool)
        if col.null_count:
            nulls[: self.num_rows] = np.asarray(col.is_null())
        if pa.types.is_dictionary(t):
            col = col.cast(t.value_type)
            t = t.value_type
        if pa.types.is_string(t) or pa.types.is_large_string(t) \
                or pa.types.is_string_view(t):
            sc = ShardedColumn("dict", t)
            enc = pc.dictionary_encode(col)
            codes = np.asarray(enc.indices.fill_null(0), dtype=np.int32)
            codes = np.concatenate([codes, np.zeros(pad, np.int32)])
            sc.codes = dist.shard_rows(self.mesh, codes)
            sc.dictionary = enc.dictionary.to_pylist()
        elif pa.types.is_floating(t):
            sc = ShardedColumn("float", t)
            vals = np.asarray(col.fill_null(0).cast(pa.float64()))
            vals = np.concatenate([vals, np.zeros(pad)])
            sc.data = dist.shard_rows(self.mesh, vals)
        elif not _int_like(t):
            # decimals, binary, nested: nothing on the mesh; a query that
            # reads one takes the single-device route
            return ShardedColumn("host", t)
        else:
            sc = ShardedColumn("planes", t)
            img, _ = _int_code_image(col)
            img = np.concatenate([img, np.zeros(pad, np.int64)])
            live = img[: self.num_rows][~nulls[: self.num_rows]]
            lo = int(live.min()) if live.size else 0
            hi = int(live.max()) if live.size else 0
            sc.ref = lo
            sc.width = bp.bit_width_for(hi - lo)
            # the unsigned offset domain, exact for uint64 too: uint64
            # subtraction wraps mod 2^64
            enc = img.view(np.uint64) - np.uint64(lo % (1 << 64))
            enc[nulls] = 0
            if sc.width < 64:  # padding rows: bits above the width drop
                enc &= np.uint64((1 << sc.width) - 1)
            sc.planes = self._shard_words(
                bp.pack_bitplanes_host(enc, sc.width), axis=1)
        if nulls.any():
            sc.has_nulls = True
            sc.valid = self._shard_words(mops.pack_bools_host(~nulls))
        return sc

    def scan_device_bytes(self, cols: List[str]) -> int:
        return sum(self.columns[c].device_bytes() for c in set(cols))


# -- predicate planning -----------------------------------------------------------

class _Pred:
    """One planned conjunct: a packed-mask producer per shard."""

    __slots__ = ("col", "mode", "op", "value_i", "value_f", "lut")

    def __init__(self, col, mode, op=None, value_i=0, value_f=0.0, lut=None):
        self.col = col
        self.mode = mode      # planes | float | lut | all
        self.op = op
        self.value_i = value_i  # literal in the column's offset domain
        self.value_f = value_f
        self.lut = lut          # np.bool_[D] over the vocabulary


def _encode_int_literal(sc: ShardedColumn, v: int, op: str):
    """Encode a comparison literal into the column's offset domain,
    resolving out-of-range constants to all / none statically."""
    lo = sc.ref
    hi = sc.ref + (1 << sc.width) - 1 if sc.width < 64 else (1 << 63) - 1
    if v < lo:
        return {"eq": ("none",), "ne": ("all",), "lt": ("none",),
                "le": ("none",), "gt": ("all",), "ge": ("all",)}[op]
    if v > hi or (v - lo) >= (1 << 64):
        return {"eq": ("none",), "ne": ("all",), "lt": ("all",),
                "le": ("all",), "gt": ("none",), "ge": ("none",)}[op]
    return ("cmp", op, (v - lo) % (1 << 64))


def _dict_lut(dictionary: List[str], op: str, value) -> np.ndarray:
    """`entry <op> value` for every vocabulary entry, on the host."""
    d = np.asarray(dictionary, dtype=object)
    fn = {"eq": np.equal, "ne": np.not_equal, "lt": np.less,
          "le": np.less_equal, "gt": np.greater, "ge": np.greater_equal}[op]
    try:
        return np.asarray(fn(d, value), dtype=bool).reshape(len(dictionary))
    except TypeError as e:
        raise MeshUnsupported(f"string comparison with {value!r}") from e


def _spec_cols(spec) -> List[str]:
    """Column names an aggregate spec reads (a column name | ("expr", ir,
    cols, out type) | None for count_star)."""
    if spec is None:
        return []
    if isinstance(spec, str):
        return [spec]
    return list(spec[2])


def _spec_is_float(spec, columns) -> bool:
    """Does the sum / avg domain of `spec` live in float64?"""
    from liquid_tpu_torch.sql.fused_agg import _ir_dtype
    if isinstance(spec, str):
        return columns[spec].kind == "float"
    return _ir_dtype(spec[1]) == "f64"


def make_dictres(columns):
    """String-comparison resolver for the expression IR: =, LIKE and IN
    over a dict column -> the matching vocabulary ids (the table-wide
    dictionary)."""
    import re as _re

    def res(cname, op, lit):
        sc = columns.get(cname)
        if sc is None or getattr(sc, "kind", None) != "dict" \
                or sc.dictionary is None:
            return None
        vocab = sc.dictionary
        if op == "=":
            return tuple(i for i, v in enumerate(vocab) if v == lit)
        if op == "like":
            pat = _re.compile(
                "^" + _re.escape(str(lit)).replace("%", ".*")
                .replace("_", ".") + "$", _re.S)
            return tuple(i for i, v in enumerate(vocab)
                         if v is not None and pat.match(str(v)))
        return None

    return res


def kinds_of(columns):
    from liquid_tpu_torch.sql.fused_agg import KindsWithTypes
    return KindsWithTypes(
        {c: sc.kind for c, sc in columns.items()},
        lambda c: getattr(columns.get(c), "arrow_type", None))


def compile_expr(e, kinds, dictres, what: str):
    """`fused_agg._compile_expr`, its bail raised as MeshUnsupported."""
    from liquid_tpu_torch.sql.fused_agg import _Bail, _compile_expr
    try:
        return _compile_expr(e, kinds, dictres)
    except _Bail as ex:
        raise MeshUnsupported(f"{what} {render(e)}: {ex}") from ex


def compile_bool(e, kinds, dictres, what: str):
    from liquid_tpu_torch.sql.fused_agg import _Bail, _compile_bool
    try:
        return _compile_bool(e, kinds, dictres)
    except _Bail as ex:
        raise MeshUnsupported(f"{what} {render(e)}: {ex}") from ex


def plan_agg_items(q, columns):
    """SELECT-item planner shared by the single-table and join paths.

    Aggregate inputs may be plain columns or expressions (arithmetic,
    CASE, casts), compiled to the fused path's IR with string conditions
    resolved to vocabulary ids.  Items that are arithmetic over
    aggregates plan their aggregates as hidden columns and evaluate on
    the host after the merge (`finish`).

    Aggregates that only HAVING or ORDER BY read plan as hidden columns
    too.  -> (key_cols, aggs, names, post): `names` is each planned
    column's name; post = {"final": item i's output name, "exprs": [(name,
    host expr)], "aggmap": {agg expr: its column name}} (`finish`)."""
    from liquid_tpu_torch.sql.physical import substitute as _subst
    key_cols: List[str] = []
    for g in q.group_by or ():
        if not isinstance(g, ast.Column):
            raise MeshUnsupported("distributed GROUP BY: plain columns")
        if g.name not in columns and not g.name.startswith("__gk"):
            raise MeshUnsupported(f"column {g.name} not on the mesh")
        key_cols.append(g.name)
    kinds = kinds_of(columns)
    dictres = make_dictres(columns)
    aggs: List[Tuple[str, object]] = []
    names: List[str] = []
    aggmap: Dict[object, str] = {}
    post_exprs: List[Tuple[str, object]] = []
    final: List[str] = []

    def plan_one(e, name):
        names.append(name)
        if e.name not in ("count", "sum", "avg", "min", "max"):
            raise MeshUnsupported(f"distributed aggregate {e.name}")
        if e.star or not e.args:
            aggs.append(("count_star", None))
            return
        if e.distinct:
            raise MeshUnsupported("distributed DISTINCT aggregate")
        arg = e.args[0]
        if isinstance(arg, ast.Column):
            sc = columns.get(arg.name)
            if sc is None:
                raise MeshUnsupported(f"column {arg.name} not on the mesh")
            if e.name != "count" and sc.kind not in ("planes", "float"):
                raise MeshUnsupported(f"distributed {e.name} over {sc.kind}")
            aggs.append((e.name, arg.name))
            return
        ir, cols = compile_expr(arg, kinds, dictres,
                                "distributed aggregate input")
        # ::date inputs keep the date32 type on output (min / max)
        out_t = ("date32" if isinstance(arg, ast.Cast)
                 and arg.type_name == "date" else None)
        aggs.append((e.name, ("expr", ir, tuple(sorted(cols)), out_t)))

    for it in q.items:
        e = it.expr
        if isinstance(e, ast.Star):
            raise MeshUnsupported("SELECT * with aggregates")
        if isinstance(e, ast.Column) and e.name in key_cols:
            nm = it.alias or e.name
            names.append(nm)
            final.append(nm)
            aggs.append(("key:" + e.name, None))
            continue
        if isinstance(e, ast.Func) and e.name in AGG_FUNCS:
            nm = it.alias or render(e)
            final.append(nm)
            aggmap[e] = nm
            plan_one(e, nm)
            continue
        inner: List[ast.Func] = []
        find_aggs(e, inner)
        if not inner:
            raise MeshUnsupported(f"distributed item {render(e)}: "
                                  f"no aggregate")
        for f in inner:
            if f not in aggmap:
                hid = f"__h{len(aggmap)}"
                aggmap[f] = hid
                plan_one(f, hid)
        nm = it.alias or render(e)
        final.append(nm)
        post_exprs.append((nm, _subst(e, aggmap)))
    extra: List[ast.Func] = []
    if q.having is not None:
        find_aggs(q.having, extra)
    for o in q.order_by:
        find_aggs(o.expr, extra)
    for f in extra:
        if f not in aggmap:
            hid = f"__h{len(aggmap)}"
            aggmap[f] = hid
            plan_one(f, hid)
    return key_cols, aggs, names, {"final": final, "exprs": post_exprs,
                                   "aggmap": aggmap}


def _batch(table: pa.Table, extra=None):
    from liquid_tpu_torch.sql.eval import Batch
    cols = {c: table.column(c).combine_chunks() for c in table.column_names}
    cols.update(extra or {})
    return Batch(cols, table.num_rows)


def finish(q, table: pa.Table, post) -> pa.Table:
    """The aggregated table -> the answer: item arithmetic over the
    aggregate columns, HAVING, ORDER BY / OFFSET / LIMIT (aggregates and
    keys resolve to their columns, hidden ones included), then the items'
    columns in SELECT order."""
    from liquid_tpu_torch.sql.eval import Evaluator
    if post["exprs"]:
        ev = Evaluator(_batch(table)) if table.num_rows else None
        for name, e in post["exprs"]:
            v = ev.eval(e) if ev is not None else pa.array([], pa.float64())
            if isinstance(v, pa.Scalar):
                v = pa.repeat(v, table.num_rows)
            table = table.append_column(name, v)
    mapping = dict(post["aggmap"])
    for it, name in zip(q.items, post["final"]):
        mapping[it.expr] = name
        if it.alias:
            mapping[ast.Column(it.alias)] = name
    if q.having is not None and table.num_rows:
        m = Evaluator(_batch(table)).arr(substitute(q.having, mapping))
        table = table.filter(pc.fill_null(m.cast(pa.bool_()), False))
    table = order_limit(q, table, post["final"], mapping)
    return table.select(post["final"])


def order_limit(q, out: pa.Table, names, extra=None) -> pa.Table:
    """ORDER BY over the finalized table (columns, positions, aliases,
    aggregate calls and expressions over items, by substituting item
    expressions with their output columns), then OFFSET / LIMIT.  NULLS
    LAST ascending, FIRST descending, unless stated; the placement rides
    as a leading flag key (older pyarrow takes none per key)."""
    if q.order_by and out.num_rows:
        from liquid_tpu_torch.sql.eval import Evaluator
        mapping: Dict[ast.Expr, str] = dict(extra or {})
        for it in q.items:
            nm = it.alias or render(it.expr)
            if nm in out.column_names:
                mapping[it.expr] = nm
                if it.alias:
                    mapping[ast.Column(it.alias)] = nm
        ev = Evaluator(_batch(out))
        cols, keys = {}, []
        for i, o in enumerate(q.order_by):
            if isinstance(o.expr, ast.Literal) \
                    and isinstance(o.expr.value, int):
                arr = out.column(names[o.expr.value - 1]).combine_chunks()
            else:
                arr = ev.arr(substitute(o.expr, mapping))
            nf = o.desc if o.nulls_first is None else o.nulls_first
            isnull = pc.is_null(arr)
            cols[f"__n{i}"] = pc.invert(isnull) if nf else isnull
            cols[f"__s{i}"] = arr
            keys += [(f"__n{i}", "ascending"),
                     (f"__s{i}", "descending" if o.desc else "ascending")]
        out = out.take(pc.sort_indices(pa.table(cols), sort_keys=keys))
    if q.offset:
        out = out.slice(q.offset)
    if q.limit is not None:
        out = out.slice(0, q.limit)
    return out


# -- per-shard decoding -----------------------------------------------------------

def decode_column(sc: ShardedColumn, s: int):
    """Shard s of a column -> (values, nulls): int64 images for planes
    (offset + reference, the add wrapping as the reference's does),
    float64 for floats, int64 vocabulary ids for strings."""
    if sc.kind == "host":
        raise MeshUnsupported(f"a {sc.arrow_type} column on the mesh")
    if sc.kind == "float":
        v = sc.data[s]
    elif sc.kind == "dict":
        v = sc.codes[s].to(torch.int64)
    else:
        v = bp.unpack_bitplanes_many(sc.planes[s][None])[0] \
            + _ref_i64(sc.ref)
    if sc.valid is not None:
        return v, ~mops.unpack_bits(sc.valid[s])
    return v, torch.zeros(v.shape, dtype=torch.bool, device=v.device)


class IREnv:
    """Column access for `fused_agg.eval_ir_nulls` over decoded arrays."""

    def __init__(self, vals: dict, nulls: dict, device, n_rows: int):
        self.vals = vals
        self._nulls = nulls
        self.device = device
        self.n_rows = n_rows

    def decode(self, name, dtype):
        v = self.vals[name]
        if dtype == "f64" and v.dtype != torch.float64:
            v = v.to(torch.float64)
        return v

    def nulls(self, name):
        nl = self._nulls.get(name)
        if nl is None:
            return torch.zeros(self.n_rows, dtype=torch.bool,
                               device=self.device)
        return nl


def eval_ir(ir, env: IREnv):
    """Value IR over one shard -> (values, nulls), broadcast to its rows."""
    from liquid_tpu_torch.sql.fused_agg import eval_ir_nulls
    v, nl = eval_ir_nulls(ir, env)
    shape = (env.n_rows,)
    return v.expand(shape) if v.dim() == 0 else v, \
        nl.expand(shape) if nl.dim() == 0 else nl


def eval_bool(ir, env: IREnv) -> torch.Tensor:
    """Boolean IR's TRUE rows over one shard."""
    from liquid_tpu_torch.sql.fused_agg import _bool_nonnull
    m = _bool_nonnull(ir, env)
    return m.expand((env.n_rows,)) if m.dim() == 0 else m


def mm_encode(v: torch.Tensor, ref: int) -> torch.Tensor:
    """Decoded int64 values -> the order-preserving min/max domain of the
    offsets: (v - ref) with bit 63 flipped, so signed int64 order is the
    unsigned order of the offsets (full 64-bit spans included)."""
    return (v - _ref_i64(ref)) ^ _SIGN


def mm_decode(m: np.ndarray, ref: int) -> np.ndarray:
    """Inverse of `mm_encode` on the host -> int64 images."""
    enc = (np.asarray(m, np.int64) ^ np.int64(_SIGN)).view(np.uint64)
    return (enc + np.uint64(ref % (1 << 64))).view(np.int64)


def shard_env(dt, s: int, cols) -> IREnv:
    """Shard s of `dt` with the named columns decoded once."""
    vals, nulls = {}, {}
    for c in cols:
        vals[c], nulls[c] = decode_column(dt.columns[c], s)
    return IREnv(vals, nulls, dt.valid[s].device, dt.valid[s].shape[0] * 32)


def key_codes(env: IREnv, columns, key_cols):
    """One shard's group keys -> ([int64 code], [null flag]); floats key
    by their IEEE image, strings by their vocabulary id."""
    return ([f64_bits(env.vals[c] + 0.0) if columns[c].kind == "float"
             else env.vals[c] for c in key_cols],
            [env.nulls(c) for c in key_cols])


def agg_inputs(aggs, env: IREnv, columns) -> list:
    """One shard's input of every aggregate (key items skipped): {"kind",
    "v": the sum / avg domain, "mm": the min / max domain (a plain int
    column's encoded offsets, `mm_encode`; decoded values otherwise),
    "nulls"}; an expression aggregate evaluates its IR null-aware (a CASE
    arm's nulls count where it is chosen)."""
    out = []
    for kind, spec in aggs:
        if kind.startswith("key:"):
            continue
        if kind == "count_star":
            out.append({"kind": kind})
            continue
        if isinstance(spec, str):
            v, nl = env.vals[spec], env.nulls(spec)
            sc = columns[spec]
            mm = mm_encode(v, sc.ref) if sc.kind == "planes" else v
        else:
            v, nl = eval_ir(spec[1], env)
            mm = v
        if kind == "avg" and v.dtype != torch.float64:
            v = v.to(torch.float64)
        out.append({"kind": kind, "v": v, "mm": mm, "nulls": nl})
    return out


# -- per-slot tables: direct addressing and collision-resolved hashing ------------

_M1 = wrap_i64(0xBF58476D1CE4E5B9)
_M2 = wrap_i64(0x94D049BB133111EB)
_GOLD = 0x9E3779B97F4A7C15


def _mix(h: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    h = h ^ v
    h = (h ^ srl(h, 30)) * _M1
    h = (h ^ srl(h, 27)) * _M2
    return h ^ srl(h, 31)


def scatter(slots, m: int, fill, dtype, vals, reduce: str = "sum"):
    """Per shard, a table of m slots starting at `fill` that `vals` reduce
    into at `slots` (slot m is a trash slot, dropped)."""
    parts = []
    for slot, v in zip(slots, vals):
        t = torch.full((m + 1,), fill, dtype=dtype, device=slot.device)
        if reduce == "sum":
            t.index_add_(0, slot, v.to(dtype))
        else:
            t.scatter_reduce_(0, slot, v.to(dtype), reduce)
        parts.append(t[:m])
    return parts


def agg_tables(slots, m: int, live, rspecs) -> list:
    """The merged per-slot outputs of every aggregate of `rspecs`
    (`agg_inputs` per shard): [count] for a count, [acc, count]
    otherwise."""
    ones = [torch.ones_like(slot) for slot in slots]
    outs = []
    for j, kind in enumerate(sp["kind"] for sp in rspecs[0]):
        if kind == "count_star":
            outs.append(dist.psum(scatter(slots, m, 0, torch.int64, ones)))
            continue
        cslots = [torch.where(lv & ~sp[j]["nulls"], slot, m)
                  for slot, lv, sp in zip(slots, live, rspecs)]
        cnt = dist.psum(scatter(cslots, m, 0, torch.int64, ones))
        if kind in ("sum", "avg"):
            vals = [sp[j]["v"] for sp in rspecs]
            outs.append(dist.psum(scatter(cslots, m, 0, vals[0].dtype,
                                          vals)))
        elif kind in ("min", "max"):
            vals = [sp[j]["mm"] for sp in rspecs]
            dt = vals[0].dtype
            coll = dist.pmin if kind == "min" else dist.pmax
            outs.append(coll(scatter(cslots, m, _neutral(dt, kind), dt,
                                     vals, "a" + kind)))
        elif kind != "count":
            raise ValueError(kind)
        outs.append(cnt)
    return outs


def direct_tables(live, keys, rspecs, domains):
    """GROUP BY over small key domains: each key tuple addresses its own
    slot (NULL one past each domain), so no collision can happen.  ->
    (True, occupied, key reps..., null reps..., agg outs...) as one
    round of `hash_rounds`."""
    strides, m = [], 1
    for _, span in reversed(domains):
        strides.append(m)
        m *= span + 2
    strides.reverse()
    slots = []
    for lv, (codes, knulls) in zip(live, keys):
        slot = torch.zeros(lv.shape, dtype=torch.int64, device=lv.device)
        for (lo, span), stride, c, nl in zip(domains, strides, codes, knulls):
            slot = slot + torch.where(nl, span + 1, c - lo) * stride
        slots.append(torch.where(lv, slot, m))
    ones = [torch.ones_like(slot) for slot in slots]
    occ = dist.psum(scatter(slots, m, 0, torch.int64, ones)) > 0
    iota = torch.arange(m, dtype=torch.int64, device=occ.device)
    kreps, nreps = [], []
    for (lo, span), stride in zip(domains, strides):
        idx = (iota // stride) % (span + 2)
        nreps.append(idx == span + 1)
        kreps.append(torch.where(nreps[-1], 0, idx + lo))
    return (True, occ, *kreps, *nreps,
            *agg_tables(slots, m, live, rspecs))


def hash_rounds(codes, knulls, live0, rspecs, n_slots: int, salt: int,
                rounds: int):
    """Multi-round collision-resolved hash aggregation over the shards;
    per-shard scatters merge with psum / pmin / pmax.

    codes / knulls: per shard, a list of int64 key codes and bool null
    flags per key.  live0: per shard, bool rows taking part.  rspecs: per
    shard, `agg_inputs`.  -> (ok, per round [clean slot, key reps..., null
    reps..., agg outs]) with the merged tables on the first shard's
    device; a group is valid where its round's clean slot holds; ok False
    means the rounds did not converge (try the next stage).  A slot is
    clean when every merged key's min equals its max: the rows of a dirty
    slot carry to the next round, with a new salt."""
    live = list(live0)
    outs = []
    i64max = torch.iinfo(torch.int64).max
    i64min = torch.iinfo(torch.int64).min
    for r in range(rounds):
        rsalt = wrap_i64(salt + r * _GOLD)
        slots = []
        for lv, cs, ns in zip(live, codes, knulls):
            h = torch.full(lv.shape, rsalt, dtype=torch.int64,
                           device=lv.device)
            for c, nl in zip(cs, ns):
                h = _mix(_mix(h, c), nl.to(torch.int64))
            slots.append(torch.where(lv, h & (n_slots - 1), n_slots))
        ones = [torch.ones_like(slot) for slot in slots]
        occ = dist.psum(scatter(slots, n_slots, 0, torch.int64, ones)) > 0
        dirty = torch.zeros_like(occ)
        kreps, nreps = [], []
        for k in range(len(codes[0])):
            kc = [cs[k] for cs in codes]
            kn = [ns[k] for ns in knulls]
            cmin = dist.pmin(scatter(slots, n_slots, i64max, torch.int64,
                                     kc, "amin"))
            cmax = dist.pmax(scatter(slots, n_slots, i64min, torch.int64,
                                     kc, "amax"))
            nmin = dist.pmin(scatter(slots, n_slots, 2, torch.int32, kn,
                                     "amin"))
            nmax = dist.pmax(scatter(slots, n_slots, -1, torch.int32, kn,
                                     "amax"))
            dirty = dirty | (occ & ((cmin != cmax) | (nmin != nmax)))
            kreps.append(cmin)
            nreps.append(nmin == 1)
        outs += [occ & ~dirty, *kreps, *nreps,
                 *agg_tables(slots, n_slots, live, rspecs)]
        live = [lv & dirty.to(lv.device)[slot.clamp(max=n_slots - 1)]
                for lv, slot in zip(live, slots)]
    leftover = dist.psum([lv.sum().reshape(1) for lv in live])
    return (bool(leftover.item() == 0),) + tuple(outs)


# -- the session -------------------------------------------------------------------

class DistributedSession:
    """`sql()` over sharded tables; see the module docstring."""

    #: collision-resolution rounds per hash stage: rows of a dirty slot
    #: re-scatter with a fresh salt the next round
    ROUNDS = 3

    def __init__(self, mesh=None):
        self.mesh = mesh if mesh is not None else dist.make_mesh()
        self.tables: Dict[str, DistributedTable] = {}
        #: device bytes the last query's scan touched (bytes-moved metric)
        self.last_scan_bytes = 0
        #: host copies of every registered table, for the single-device
        #: route
        self._host: Dict[str, pa.Table] = {}
        self._fallback_ctx = None
        self._fallback_dirty = True
        self.route_stats = {"distributed": 0, "fallback": 0,
                            "fallback_reasons": []}

    def register_table(self, name: str, table: pa.Table) -> None:
        self.tables[name] = DistributedTable(self.mesh, table)
        self._host[name] = table
        self._fallback_dirty = True

    def register_parquet(self, name: str, path: str, columns=None) -> None:
        import pyarrow.parquet as pq
        self.register_table(name, pq.read_table(path, columns=columns))

    def _unregister(self, name: str) -> None:
        self.tables.pop(name, None)
        self._host.pop(name, None)
        self._fallback_dirty = True

    # -- the single-device route ------------------------------------------------

    def _ensure_fallback(self):
        import pyarrow.parquet as pq
        from liquid_tpu_torch.sql.session import LiquidCacheLocalBuilder
        if self._fallback_ctx is None or self._fallback_dirty:
            d = tempfile.mkdtemp(prefix="liquid_dist_route_")
            ctx, _cache = (LiquidCacheLocalBuilder(
                device=self.mesh.devices[0]).with_cache_dir(d).build())
            for name, t in self._host.items():
                path = os.path.join(d, f"{name}.parquet")
                pq.write_table(t, path)
                ctx.register_parquet(name, path)
            self._fallback_ctx = ctx
            self._fallback_dirty = False
        return self._fallback_ctx

    def _route(self, reason: MeshUnsupported) -> None:
        if os.environ.get("LIQUID_DIST_STRICT"):
            raise reason
        self.route_stats["fallback"] += 1
        self.route_stats["fallback_reasons"].append(
            f"{type(reason).__name__}: {str(reason)[:120]}")

    # -- statements -----------------------------------------------------------------

    def sql(self, query) -> pa.Table:
        """One statement, a statement list (TPC-H q15's [create view,
        select, drop view], answered by its last statement with columns)
        or SQL text.  Views and CTEs materialize on the mesh as registered
        tables; uncorrelated subqueries fold to literals.  `dist.DIAG`
        covers the whole call."""
        dist.reset_diag()
        if isinstance(query, (list, tuple)):
            out = pa.table({})
            for stmt in query:
                res = self._sql_routed(stmt)
                if res.num_columns:
                    out = res
            return out
        return self._sql_routed(query)

    def _sql_routed(self, query: str) -> pa.Table:
        try:
            out = self._sql_one(query)
        except MeshUnsupported as e:
            self._route(e)
            return self._ensure_fallback().sql(query).to_arrow()
        self.route_stats["distributed"] += 1
        return out

    def _sql_one(self, query: str) -> pa.Table:
        from liquid_tpu_torch.sql.parser import parse_statement
        stmt = parse_statement(query)
        if stmt[0] == "create_view":
            _, name, sub = stmt
            self.register_table(name, self._execute_q(sub))
            return pa.table({})
        if stmt[0] == "drop_view":
            self._unregister(stmt[1])
            return pa.table({})
        return self._execute_q(stmt[1])

    def _execute_q(self, q) -> pa.Table:
        if isinstance(q, ast.SetOp):
            raise MeshUnsupported("set operations on the mesh")
        if q.ctes:
            saved = {}
            try:
                for name, sub in q.ctes:
                    if name not in saved:
                        saved[name] = (self.tables.get(name),
                                       self._host.get(name))
                    self.register_table(name, self._execute_q(sub))
                q = copy.copy(q)
                q.ctes = []
                return self._execute_q(q)
            finally:
                for name, (t, h) in saved.items():
                    if t is None:
                        self._unregister(name)
                    else:
                        self.tables[name], self._host[name] = t, h
                        self._fallback_dirty = True
        q = copy.copy(q)
        q.where = self._fold_scalar_subqueries(q.where)
        q.having = self._fold_scalar_subqueries(q.having)
        q.where = self._fold_in_subqueries(q.where)
        from liquid_tpu_torch.sql.exec import _inline_derived
        q = _inline_derived(q)
        q = self._rewrite_select_distinct(q)
        distinct_aggs = self._find_distinct_aggs(q)
        if distinct_aggs:
            return self._exec_distinct(q, distinct_aggs)
        from liquid_tpu_torch.parallel.join import execute_dist_join
        if isinstance(q.from_, ast.Join):
            return execute_dist_join(self, q)
        if not isinstance(q.from_, ast.TableRef) \
                or q.from_.name not in self.tables:
            raise MeshUnsupported("distributed FROM: a registered table")
        dt = self.tables[q.from_.name]
        try:
            preds, never = self._plan_where(q.where, dt)
            key_cols, aggs, names, post = plan_agg_items(q, dt.columns)
        except MeshUnsupported:
            # residual conditions, projections, expression keys
            return execute_dist_join(self, q)
        scanned = [p.col for p in preds] + key_cols \
            + [c for _, s in aggs for c in _spec_cols(s)]
        self.last_scan_bytes = dt.scan_device_bytes(scanned)
        if never:
            table = self._empty_result(dt, key_cols, aggs, names)
        elif key_cols:
            table = self._execute_grouped(dt, preds, key_cols, aggs, names)
        else:
            table = self._execute_scalar(dt, preds, aggs, names)
        return finish(q, table, post)

    # -- DISTINCT ------------------------------------------------------------------

    @staticmethod
    def _rewrite_select_distinct(q):
        """SELECT DISTINCT c1, c2 ... is GROUP BY c1, c2 with no
        aggregates."""
        if not q.distinct:
            return q
        aggs: List[ast.Func] = []
        for it in q.items:
            find_aggs(it.expr, aggs)
        if aggs or q.group_by or not all(isinstance(it.expr, ast.Column)
                                         for it in q.items):
            raise MeshUnsupported("DISTINCT over aggregates or expressions")
        q2 = copy.copy(q)
        q2.distinct = False
        q2.group_by = [it.expr for it in q.items]
        return q2

    @staticmethod
    def _find_distinct_aggs(q) -> List[ast.Func]:
        aggs: List[ast.Func] = []
        for it in q.items:
            find_aggs(it.expr, aggs)
        if q.having is not None:
            find_aggs(q.having, aggs)
        return [a for a in aggs if a.distinct]

    def _exec_distinct(self, q, distinct_aggs) -> pa.Table:
        """agg(DISTINCT d) GROUP BY keys: ONE distributed aggregation
        grouped by keys + [d] (the other aggregates ride as exact
        partials), then a host fold of the per-(keys, d) rows with
        pyarrow's group_by: those rows are unique, so count(DISTINCT d) is
        the count of their non-null d."""
        from liquid_tpu_torch.sql.eval import Evaluator
        darg = distinct_aggs[0].args[0]
        if not isinstance(darg, ast.Column):
            raise MeshUnsupported(
                "distributed DISTINCT aggregate over expressions")
        for a in distinct_aggs:
            if not (a.args and a.args[0] == darg):
                raise MeshUnsupported(
                    "distributed DISTINCT: one distinct column per query")
            if a.name not in ("count", "sum", "avg", "approx_distinct"):
                raise MeshUnsupported(f"distributed DISTINCT aggregate "
                                      f"{a.name}")
        keys: List[ast.Expr] = list(q.group_by)
        for g in keys:
            if not isinstance(g, ast.Column):
                raise MeshUnsupported("distributed GROUP BY: plain columns")
        key_names = [g.name for g in keys]
        all_aggs: List[ast.Func] = []
        for it in q.items:
            find_aggs(it.expr, all_aggs)
        if q.having is not None:
            find_aggs(q.having, all_aggs)

        inner = ast.Select()
        inner.from_ = q.from_
        inner.where = q.where
        inner.group_by = keys + [darg]
        inner.items = [ast.SelectItem(g, g.name) for g in keys]
        inner.items.append(ast.SelectItem(darg, darg.name))
        # (output name, pyarrow aggregate over the inner rows) per agg
        plan: List[Tuple[ast.Func, tuple]] = []
        n_part = 0

        def partial(func: ast.Func) -> str:
            nonlocal n_part
            name = f"__p{n_part}"
            n_part += 1
            inner.items.append(ast.SelectItem(func, name))
            return name

        for a in dict.fromkeys(all_aggs):
            if a.distinct:
                kind = {"count": "dcount", "approx_distinct": "dcount",
                        "sum": "dsum", "avg": "davg"}[a.name]
                plan.append((a, (kind,)))
            elif a.name == "count" and (a.star or not a.args):
                plan.append((a, ("col", partial(ast.Func(
                    "count", (), star=True)), "sum")))
            elif a.name in ("count", "sum", "min", "max"):
                plan.append((a, ("col", partial(a), "sum"
                                 if a.name in ("count", "sum") else a.name)))
            elif a.name == "avg":
                plan.append((a, ("ratio", partial(ast.Func("sum", a.args)),
                                 partial(ast.Func("count", a.args)))))
            else:
                raise MeshUnsupported(f"distributed distinct-mix aggregate "
                                      f"{a.name}")

        res = self._execute_q(inner)
        ft = _fold_distinct(res, key_names, darg.name, plan)
        mapping: Dict[ast.Expr, str] = {a: render(a) for a, _r in plan}
        for g in keys:
            mapping[g] = g.name
        ev = Evaluator(_batch(ft))
        cols, names = {}, []
        for it in q.items:
            nm = it.alias or render(it.expr)
            v = ev.eval(substitute(it.expr, mapping))
            if isinstance(v, pa.Scalar):
                v = pa.repeat(v, ft.num_rows)
            cols[nm] = v
            names.append(nm)
        out = pa.table(cols) if cols else pa.table({})
        if q.having is not None:
            hb = _batch(ft, {n: (v.combine_chunks()
                                 if isinstance(v, pa.ChunkedArray) else v)
                             for n, v in cols.items()})
            m = Evaluator(hb).arr(substitute(q.having, mapping))
            out = out.filter(pc.fill_null(m.cast(pa.bool_()), False))
        return order_limit(q, out, names)

    # -- subquery folding --------------------------------------------------------------

    def _fold_scalar_subqueries(self, e):
        """Uncorrelated scalar subqueries -> their literal value.  One the
        mesh does not take (a correlated one fails to plan standalone)
        stays, and the statement takes the single-device route."""
        if e is None:
            return None
        from liquid_tpu_torch.sql.qualify import map_expr

        def fix(node):
            if isinstance(node, ast.Subquery):
                try:
                    res = self._execute_q(node.query)
                except MeshUnsupported:
                    return node
                if res.num_columns != 1 or res.num_rows > 1:
                    raise ValueError(f"scalar subquery returned "
                                     f"{res.num_rows} x {res.num_columns}")
                if res.num_rows == 0:
                    return ast.Literal(None)
                return ast.Literal(res.column(0)[0].as_py())
            return None

        return map_expr(e, fix)

    def _fold_in_subqueries(self, e):
        """Uncorrelated [NOT] IN (SELECT ...) -> a literal IN list (TPC-H
        q16's supplier exclusion, q18's orderkeys): the inner query runs
        once, and the outer stays on the mesh with the list as a residual
        condition, NULL items keeping SQL's three-valued NOT IN.  An empty
        result folds to FALSE (IN) or TRUE (NOT IN)."""
        if e is None:
            return None
        from liquid_tpu_torch.sql.qualify import map_expr

        def fix(node):
            if isinstance(node, ast.InSubquery):
                try:
                    res = self._execute_q(node.query)
                except MeshUnsupported:
                    return node
                if res.num_columns != 1 or res.num_rows > IN_LIST_MAX:
                    return node
                vals = res.column(0).to_pylist()
                if not vals:
                    return ast.Literal(bool(node.negated))
                return ast.InList(node.operand,
                                  tuple(ast.Literal(v) for v in vals),
                                  node.negated)
            return None

        return map_expr(e, fix)

    # -- planning ----------------------------------------------------------------------

    def _plan_where(self, where, dt) -> Tuple[List[_Pred], bool]:
        """-> (preds, never).  Every conjunct must be `column <op>
        literal`; int literals stay exact (never through float64), and
        fractional literals against int columns normalize to floor / ceil
        or prove the query empty."""
        preds: List[_Pred] = []
        never = False
        for conj in split_conjuncts(where):
            if isinstance(conj, ast.Literal):
                never = never or conj.value is not True
                continue
            if not (isinstance(conj, ast.Binary) and conj.op in _CMP):
                raise MeshUnsupported(f"WHERE conjunct {render(conj)}")
            col, lit = conj.left, conj.right
            op = _CMP[conj.op]
            if not isinstance(col, ast.Column) \
                    and isinstance(lit, ast.Column):
                col, lit = lit, col
                op = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le",
                      "eq": "eq", "ne": "ne"}[op]
            if not isinstance(col, ast.Column) or col.name not in dt.columns:
                raise MeshUnsupported(f"WHERE conjunct {render(conj)}")
            v = lit.value if isinstance(lit, ast.Literal) \
                else _literal_value(lit)
            if v is None and not isinstance(lit, ast.Literal):
                raise MeshUnsupported(f"unfoldable literal {render(lit)}")
            sc = dt.columns[col.name]
            if sc.kind == "host":
                raise MeshUnsupported(f"a {sc.arrow_type} column on the mesh")
            if v is None:
                never = True  # x <op> NULL matches nothing
                continue
            if isinstance(v, datetime.datetime):
                v = int(v.timestamp() * 1_000_000)
            elif isinstance(v, datetime.date):
                v = (v - datetime.date(1970, 1, 1)).days
            if sc.kind == "dict":
                preds.append(_Pred(col.name, "lut",
                                   lut=_dict_lut(sc.dictionary, op, v)))
                continue
            if isinstance(v, str):
                raise MeshUnsupported(f"string literal against {sc.kind}")
            if sc.kind == "float":
                preds.append(_Pred(col.name, "float", op=op,
                                   value_f=float(v)))
                continue
            if isinstance(v, float):
                if v != int(v):
                    if op == "eq":
                        never = True
                        continue
                    if op == "ne":
                        if sc.has_nulls:
                            preds.append(_Pred(col.name, "all"))
                        continue  # true on every non-null row
                    if op in ("lt", "le"):
                        v, op = math.floor(v), "le"
                    else:
                        v, op = math.ceil(v), "ge"
                v = int(v)
            plan = _encode_int_literal(sc, int(v), op)
            if plan[0] == "none":
                never = True
            elif plan[0] == "all":
                preds.append(_Pred(col.name, "all"))
            else:
                preds.append(_Pred(col.name, "planes", op=plan[1],
                                   value_i=plan[2]))
        return preds, never

    # -- per-shard steps ----------------------------------------------------------------

    def selection(self, dt, preds) -> List[torch.Tensor]:
        """The packed selection of every shard: row validity AND each
        predicate AND its column's validity.  A shard's bit-plane
        predicates, with their columns' validity, are one call of K4's
        fused form (`bitpack_cuda.select_planes`: one launch per 16
        descriptors); the float and dictionary predicates are ANDed
        after it."""
        luts = {}
        for j, p in enumerate(preds):
            if p.mode == "lut":
                lut = np.zeros(max(len(p.lut), 1), bool)
                lut[: len(p.lut)] = p.lut
                luts[j] = torch.from_numpy(lut)
        out = []
        for s in range(dt.n_dev):
            sel = dt.valid[s]
            dev = sel.device
            planes = []
            for p in preds:
                if p.mode == "planes":
                    sc = dt.columns[p.col]
                    planes.append((sc.planes[s], p.value_i,
                                   {"le": "lt_eq", "ge": "gt_eq"}.get(p.op,
                                                                     p.op),
                                   None if sc.valid is None else sc.valid[s]))
            if planes:
                dist.DIAG["k4_planned"] += dist.k4_launches(sel, planes)
                sel = bitpack_cuda.select_planes(sel, planes)
            for j, p in enumerate(preds):
                sc = dt.columns[p.col]
                if p.mode == "planes":
                    continue
                if p.mode == "float":
                    c = sc.data[s]
                    v = p.value_f
                    m = {"eq": c == v, "ne": c != v, "lt": c < v,
                         "le": c <= v, "gt": c > v, "ge": c >= v}[p.op]
                    sel = sel & mops.pack_bools(m)
                elif p.mode == "lut":
                    lut = luts[j].to(dev)
                    codes = sc.codes[s].to(torch.int64).clamp(
                        0, lut.shape[0] - 1)
                    sel = sel & mops.pack_bools(lut[codes])
                if sc.valid is not None:
                    sel = sel & sc.valid[s]
            out.append(sel)
        return out

    # -- scalar (no GROUP BY) ---------------------------------------------------------

    def _execute_scalar(self, dt, preds, aggs, names) -> pa.Table:
        sels = self.selection(dt, preds)
        selbs = [mops.unpack_bits(x) for x in sels]
        cols = {c for _, spec in aggs for c in _spec_cols(spec)}
        inputs = [agg_inputs(aggs, shard_env(dt, s, cols), dt.columns)
                  for s in range(dt.n_dev)]
        outs = []
        for j, (kind, spec) in enumerate(aggs):
            if kind == "count_star":
                outs.append(dist.psum([mops.count(x).reshape(1)
                                       for x in sels]))
                continue
            parts = [(sp[j]["v"], sp[j]["mm"], sp[j]["nulls"])
                     for sp in inputs]
            contribs = [selbs[s] & ~parts[s][2] for s in range(dt.n_dev)]
            cnt = dist.psum([c.sum().reshape(1) for c in contribs])
            if kind == "count":
                outs.append(cnt)
            elif kind in ("sum", "avg"):
                outs.append(dist.psum([
                    torch.where(c, v, torch.zeros((), dtype=v.dtype,
                                                  device=v.device)
                                ).sum().reshape(1)
                    for c, (v, _m, _n) in zip(contribs, parts)]))
                outs.append(cnt)
            else:
                red = [torch.where(c, mm, _neutral(mm.dtype, kind))
                       for c, (_v, mm, _n) in zip(contribs, parts)]
                red = [(r.min() if kind == "min" else r.max()).reshape(1)
                       if r.numel() else torch.full(
                           (1,), _neutral(r.dtype, kind), dtype=r.dtype,
                           device=r.device) for r in red]
                outs.append((dist.pmin if kind == "min" else dist.pmax)(red))
                outs.append(cnt)
        outs = [o.cpu().numpy() for o in outs]
        cols: Dict[str, pa.Array] = {}
        oi = 0
        for (kind, spec), name in zip(aggs, names):
            if kind in ("count_star", "count"):
                cols[name] = pa.array([int(outs[oi][0])], pa.int64())
                oi += 1
                continue
            v, c = outs[oi][0], int(outs[oi + 1][0])
            oi += 2
            if kind == "sum":
                cols[name] = self._decode_sum(spec, dt.columns, v, c)
            elif kind == "avg":
                cols[name] = pa.array([float(v) / c if c else None],
                                      pa.float64())
            elif not isinstance(spec, str):
                if len(spec) > 3 and spec[3] == "date32":
                    cols[name] = pa.array([None if c == 0 else int(v)],
                                          pa.int32()).view(pa.date32())
                    continue
                is_f = _spec_is_float(spec, dt.columns)
                cols[name] = pa.array(
                    [None if c == 0 else (float(v) if is_f else int(v))],
                    pa.float64() if is_f else pa.int64())
            else:
                sc = dt.columns[spec]
                if c == 0:
                    cols[name] = pa.array([None], _agg_out_type(sc))
                elif sc.kind == "float":
                    cols[name] = pa.array([float(v)], pa.float64()).cast(
                        sc.arrow_type)
                else:
                    cols[name] = _restore_int(
                        mm_decode(np.array([v]), sc.ref), None,
                        sc.arrow_type)
        return pa.table(cols)

    @staticmethod
    def _decode_sum(spec, columns, v, count: int) -> pa.Array:
        is_f = _spec_is_float(spec, columns)
        if count == 0:
            return pa.array([None], pa.float64() if is_f else pa.int64())
        if is_f:
            return pa.array([float(v)], pa.float64())
        return pa.array([int(v)], pa.int64())

    # -- grouped ----------------------------------------------------------------------

    def _execute_grouped(self, dt, preds, key_cols, aggs, names) -> pa.Table:
        selbs = [mops.unpack_bits(x) for x in self.selection(dt, preds)]
        cols = set(key_cols) | {c for _, spec in aggs
                                for c in _spec_cols(spec)}
        envs = [shard_env(dt, s, cols) for s in range(dt.n_dev)]
        keys = [key_codes(env, dt.columns, key_cols) for env in envs]
        rspecs = [agg_inputs(aggs, env, dt.columns) for env in envs]
        domains = self._key_domains(dt, key_cols)
        if domains is not None:
            from liquid_tpu_torch.ops.hashagg import DIRECT_CAP
            m = 1
            for _, span in domains:
                m *= span + 2
            if 0 < m <= DIRECT_CAP:
                res = direct_tables(selbs, keys, rspecs, domains)
                return self._finalize_grouped(dt, key_cols, aggs, names,
                                              res, rounds=1)
        return self.grouped_hash(dt, key_cols, aggs, names, selbs, keys,
                                 rspecs)

    def grouped_hash(self, dt, key_cols, aggs, names, live, keys, rspecs):
        """GROUP BY through the hash stages, each exact; `dt` gives the
        columns' decode information (a table or a joined VTable)."""
        for n_slots, salt in _HASH_STAGES:
            res = hash_rounds([k[0] for k in keys], [k[1] for k in keys],
                              live, rspecs, n_slots, salt, self.ROUNDS)
            if res[0]:
                return self._finalize_grouped(dt, key_cols, aggs, names, res)
        raise MeshUnsupported(
            "distributed GROUP BY: cardinality exceeds the hash schedule "
            f"({_HASH_STAGES[-1][0]} slots x {self.ROUNDS} rounds)")

    def _key_domains(self, dt, key_cols):
        """Per key (lo, span) for direct addressing (bijective slots, no
        collision machinery), or None."""
        out = []
        for c in key_cols:
            sc = dt.columns[c]
            if sc.kind == "dict":
                out.append((0, max(len(sc.dictionary), 1) - 1))
            elif sc.kind == "planes" and sc.width <= 44:
                out.append((_ref_i64(sc.ref), (1 << sc.width) - 1))
            else:
                return None
        return out

    def _finalize_grouped(self, dt, key_cols, aggs, names, res,
                          rounds=None) -> pa.Table:
        nkeys = len(key_cols)
        naggout = sum(0 if k.startswith("key:") else
                      1 if k in ("count_star", "count") else 2
                      for k, _ in aggs)
        per_round = 1 + 2 * nkeys + naggout
        pieces: List[pa.Table] = []
        flat = list(res[1:])
        for r in range(rounds if rounds is not None else self.ROUNDS):
            chunk = flat[r * per_round: (r + 1) * per_round]
            g = torch.nonzero(chunk[0]).reshape(-1)
            if g.numel() == 0:
                continue
            # gather the occupied slots on the device, then fetch
            got = [a[g].cpu().numpy() for a in chunk[1:]]
            pieces.append(self._decode_groups(
                dt, key_cols, aggs, names, got[:nkeys],
                got[nkeys:2 * nkeys], got[2 * nkeys:]))
        if not pieces:
            return self._empty_result(dt, key_cols, aggs, names)
        return pa.concat_tables(pieces)

    def _decode_groups(self, dt, key_cols, aggs, names, kreps, nreps,
                       rest) -> pa.Table:
        cols: Dict[str, pa.Array] = {}
        oi = 0
        for (kind, spec), name in zip(aggs, names):
            if kind.startswith("key:"):
                ki = key_cols.index(kind[4:])
                sc = dt.columns[kind[4:]]
                codes, nulls = kreps[ki], nreps[ki]
                if sc.kind == "dict":
                    vals = sc.vocab().take(pa.array(
                        np.where(nulls, 0, codes).astype(np.int64)))
                    if nulls.any():
                        vals = pc.if_else(pa.array(~nulls), vals,
                                          pa.scalar(None, sc.arrow_type))
                    cols[name] = vals
                elif sc.kind == "float":
                    cols[name] = pa.array(
                        codes.view(np.float64), pa.float64(),
                        mask=nulls if nulls.any() else None).cast(
                            sc.arrow_type)
                else:
                    cols[name] = _restore_int(codes, nulls, sc.arrow_type)
                continue
            if kind in ("count_star", "count"):
                cols[name] = pa.array(rest[oi], pa.int64())
                oi += 1
                continue
            v, c = rest[oi], rest[oi + 1]
            oi += 2
            mask = c == 0
            mask = mask if mask.any() else None
            if kind == "sum":
                if _spec_is_float(spec, dt.columns):
                    cols[name] = pa.array(v, pa.float64(), mask=mask)
                else:
                    cols[name] = pa.array(v.astype(np.int64), pa.int64(),
                                          mask=mask)
            elif kind == "avg":
                with np.errstate(invalid="ignore", divide="ignore"):
                    q = np.where(c > 0, v / c.astype(np.float64), np.nan)
                cols[name] = pa.array(q, pa.float64(), mask=mask)
            elif not isinstance(spec, str):
                if _spec_is_float(spec, dt.columns):
                    cols[name] = pa.array(v, pa.float64(), mask=mask)
                elif len(spec) > 3 and spec[3] == "date32":
                    cols[name] = pa.array(v.astype(np.int32), pa.int32(),
                                          mask=mask).view(pa.date32())
                else:
                    cols[name] = pa.array(v.astype(np.int64), pa.int64(),
                                          mask=mask)
            else:
                sc = dt.columns[spec]
                if sc.kind == "float":
                    cols[name] = pa.array(v, pa.float64(), mask=mask).cast(
                        sc.arrow_type)
                else:
                    img = np.where(c == 0, 0, mm_decode(v, sc.ref))
                    cols[name] = _restore_int(img, c == 0, sc.arrow_type)
        return pa.table(cols)

    def _empty_result(self, dt, key_cols, aggs, names) -> pa.Table:
        cols: Dict[str, pa.Array] = {}
        grouped = bool(key_cols)

        def one(t, scalar):
            return pa.array([], t) if grouped else pa.array([scalar], t)

        for (kind, spec), name in zip(aggs, names):
            if kind.startswith("key:"):
                cols[name] = pa.array([], dt.columns[kind[4:]].arrow_type)
            elif kind in ("count_star", "count"):
                cols[name] = one(pa.int64(), 0)
            elif kind == "avg":
                cols[name] = one(pa.float64(), None)
            elif not isinstance(spec, str):
                if kind in ("min", "max") and len(spec) > 3 \
                        and spec[3] == "date32":
                    cols[name] = one(pa.int32(), None).view(pa.date32())
                    continue
                cols[name] = one(pa.float64() if _spec_is_float(
                    spec, dt.columns) else pa.int64(), None)
            else:
                sc = dt.columns[spec]
                t = _agg_out_type(sc) if kind != "sum" else (
                    pa.float64() if sc.kind == "float" else pa.int64())
                cols[name] = one(t, None)
        return pa.table(cols)


def _agg_out_type(sc: ShardedColumn) -> pa.DataType:
    return pa.float64() if sc.kind == "float" else sc.arrow_type


def _fold_distinct(res: pa.Table, key_names: List[str], dname: str,
                   plan) -> pa.Table:
    """The host fold of `_exec_distinct` with pyarrow: one row per key
    tuple (NULL keys grouped), each aggregate under its rendered name.
    Without keys the fold is one row, also over no rows."""
    keyed = list(key_names)
    t = res
    if not keyed:
        t = t.append_column("__one", pa.array(np.zeros(t.num_rows,
                                                       np.int8)))
        keyed = ["__one"]
    specs: Dict[Tuple[str, str], None] = {}
    outs = []
    for a, recipe in plan:
        kind = recipe[0]
        if kind == "ratio":
            need = [(recipe[1], "sum"), (recipe[2], "sum")]
        elif kind == "col":
            need = [(recipe[1], recipe[2])]
        else:
            need = [(dname, {"dcount": "count", "dsum": "sum",
                             "davg": "mean"}[kind])]
        specs.update(dict.fromkeys(need))
        outs.append((render(a), kind, need))
    # pyarrow names each result "<column>_<function>"
    g = t.group_by(keyed, use_threads=False).aggregate(list(specs))
    got = {(c, f): g.column(f"{c}_{f}") for c, f in specs}
    if not key_names and g.num_rows == 0:
        # no rows at all: SQL still gives one row of neutrals
        got = {(c, f): pa.array(
            [0 if f == "count" else None],
            pa.int64() if f == "count" else pa.float64() if f == "mean"
            else t.schema.field(c).type) for c, f in specs}
    cols = {k: g.column(k) for k in key_names}
    for name, kind, need in outs:
        if kind == "ratio":
            s, c = (got[k].cast(pa.float64()) for k in need)
            cols[name] = pc.if_else(pc.greater(c, 0), pc.divide(s, c),
                                    pa.scalar(None, pa.float64()))
        elif kind == "dcount":
            cols[name] = got[need[0]].cast(pa.int64())
        else:
            cols[name] = got[need[0]]
    return pa.table(cols)
