"""Distributed equi-joins (port of `liquid_tpu/parallel/join.py`).

`SELECT ... FROM a JOIN b ON a.k = b.k [JOIN c ...] WHERE ... GROUP BY
...` runs as:

1. per table, the shard-local selection (K4 on every bit-plane predicate)
   and a decode of only the needed columns into int64 code images,
   float64 values or vocabulary ids (`decode_filtered`);
2. an exchange by key hash whose capacity comes from a histogram pass
   first, so skew costs time and never rows: overflow is checked to be 0
   (`exchange_by_key`);
3. a local sort + binary-search join per shard that expands non-unique
   build keys into one row per match (`join_copartitioned`);
4. the grouped aggregation of the single-table path over the joined rows
   (`session.hash_rounds`), or a projection of them.

A single table whose WHERE the direct planner does not take (IN lists,
OR groups, LIKE) runs here too, as a join of one table.

Where the reference is wrong the port departs from it: a composite join
key is named per table pair (two pairs on one table do not collide), the
first table keeps its synthetic keys, and an ORDER BY on a grouped
expression that is not a select item orders by the expression's key.
"""
from __future__ import annotations

import copy
from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import torch

from liquid_tpu_torch.ops import mask as mops
from liquid_tpu_torch.parallel import dist
from liquid_tpu_torch.parallel.dist import MeshUnsupported
from liquid_tpu_torch.parallel import session as S
from liquid_tpu_torch.sql import ast
from liquid_tpu_torch.sql.physical import collect_columns, find_aggs, render
from liquid_tpu_torch.sql.planner import split_conjuncts

_I64_MAX = torch.iinfo(torch.int64).max


def _pad_pow2(n: int, floor: int = 8) -> int:
    m = floor
    while m < n:
        m <<= 1
    return m


class VTable:
    """A virtual table of decoded, row-sharded arrays; every value is a
    list with one tensor per shard.

    cols[name]  : int64 code image, float64 values or int64 vocabulary ids
    nulls[name] : bool flags
    origin[name]: the ShardedColumn it decoded from (type decode info)
    live        : bool row mask
    """

    def __init__(self, mesh, cols, nulls, origin, live):
        self.mesh = mesh
        self.cols = cols
        self.nulls = nulls
        self.origin = origin
        self.live = live

    @property
    def columns(self):  # the session's decoders read `.columns`
        return self.origin

    @property
    def n_dev(self) -> int:
        return self.mesh.n


# -- step 1: filter + decode -----------------------------------------------------

def decode_filtered(sess, dt, preds, cols_needed: List[str]) -> VTable:
    sels = sess.selection(dt, preds)
    cols, nulls, origin = {}, {}, {}
    for c in cols_needed:
        sc = dt.columns[c]
        parts = [S.decode_column(sc, s) for s in range(dt.n_dev)]
        cols[c] = [v for v, _n in parts]
        nulls[c] = [nl for _v, nl in parts]
        origin[c] = sc
    return VTable(dt.mesh, cols, nulls, origin,
                  [mops.unpack_bits(x) for x in sels])


# -- step 2: exact-capacity exchange ------------------------------------------------

def exchange_by_key(vt: VTable, key: str) -> VTable:
    """Repartition a VTable by key hash so equal keys co-locate.  A
    histogram pass measures every (source, destination) bucket first;
    the exchange packs to the largest, rounded up to a power of two, and
    an overflow other than 0 raises."""
    mesh = vt.mesh
    n = mesh.n
    oks, dests = [], []
    for s in range(n):
        ok = vt.live[s] & ~vt.nulls[key][s]  # NULL keys never join
        oks.append(ok)
        dests.append(torch.where(ok, dist.dest_of(vt.cols[key][s], n), n))
    counts = np.stack([torch.bincount(d, minlength=n + 1)[:n].cpu().numpy()
                       for d in dests])
    cap = _pad_pow2(int(counts.max()) if counts.size else 1)
    names = sorted(vt.cols)
    tot = int(counts.sum())
    dist.DIAG["exchanges"] += 1
    dist.DIAG["exchange_rows"] += tot
    dist.DIAG["exchange_bytes"] += tot * (2 * len(names) + 1) * 8
    dest_tot = counts.sum(axis=0)
    if dest_tot.size and dest_tot.mean() > 0:
        dist.DIAG["exchange_balance"] = max(
            dist.DIAG["exchange_balance"],
            float(dest_tot.max() / dest_tot.mean()))
    payloads = []
    for c in names:
        payloads.append(vt.cols[c])
        payloads.append(vt.nulls[c])
    out = dist._exchange_by_dest(mesh, cap, vt.cols[key], payloads,
                                 valid=oks)
    ovf = int(sum(int(o.sum()) for o in out[-1]))
    dist.DIAG["exchange_overflow"] += ovf
    if ovf:
        raise RuntimeError(f"exchange on {key}: {ovf} rows past the "
                           f"measured capacity {cap}")
    rmask = out[-2]
    new_cols, new_nulls = {}, {}
    for i, c in enumerate(names):
        new_cols[c] = out[1 + 2 * i]
        new_nulls[c] = out[2 + 2 * i]
    new_cols[key] = out[0]
    new_nulls[key] = [torch.zeros_like(m) for m in rmask]
    return VTable(mesh, new_cols, new_nulls, dict(vt.origin), rmask)


# -- step 3: local expansion join ----------------------------------------------------

def join_copartitioned(probe: VTable, build: VTable, key: str,
                       out_names: Tuple[List[str], List[str]]) -> VTable:
    """Inner-join two co-partitioned VTables on `key`, shard by shard.
    Build keys may repeat: each probe row expands into one output row per
    match (the shard's output holds exactly its matches)."""
    pnames, bnames = out_names
    cols = {c: [] for c in list(pnames) + list(bnames)}
    nulls = {c: [] for c in cols}
    live = []
    for s in range(probe.n_dev):
        bk = torch.where(build.live[s], build.cols[key][s], _I64_MAX)
        bks, order = torch.sort(bk)
        pk = probe.cols[key][s]
        lo = torch.searchsorted(bks, pk, side="left")
        hi = torch.searchsorted(bks, pk, side="right")
        m = torch.where(probe.live[s], hi - lo, 0)
        total = int(m.sum())
        p_of = torch.repeat_interleave(
            torch.arange(m.shape[0], device=m.device), m)
        offs = torch.cumsum(m, 0) - m
        r = torch.arange(total, device=m.device) - offs[p_of]
        b_of = order[lo[p_of] + r]
        for c in pnames:
            cols[c].append(probe.cols[c][s][p_of])
            nulls[c].append(probe.nulls[c][s][p_of])
        for c in bnames:
            cols[c].append(build.cols[c][s][b_of])
            nulls[c].append(build.nulls[c][s][b_of])
        live.append(torch.ones(total, dtype=torch.bool, device=m.device))
    origin = {c: probe.origin[c] for c in pnames}
    origin.update({c: build.origin[c] for c in bnames})
    return VTable(probe.mesh, cols, nulls, origin, live)


# -- step 4: aggregation or projection of the joined rows ------------------------------

def _env(vt: VTable, s: int) -> S.IREnv:
    return S.IREnv({c: v[s] for c, v in vt.cols.items()},
                   {c: v[s] for c, v in vt.nulls.items()},
                   vt.live[s].device, vt.live[s].shape[0])


def aggregate_vtable(sess, vt: VTable, key_cols: List[str],
                     aggs, names) -> pa.Table:
    envs = [_env(vt, s) for s in range(vt.n_dev)]
    return sess.grouped_hash(
        vt, key_cols, aggs, names, vt.live,
        [S.key_codes(env, vt.origin, key_cols) for env in envs],
        [S.agg_inputs(aggs, env, vt.origin) for env in envs])


def scalar_aggregate_vtable(sess, vt: VTable, aggs, names) -> pa.Table:
    """No GROUP BY: one global group through one constant key."""
    vt.cols["__one"] = [torch.zeros_like(lv, dtype=torch.int64)
                        for lv in vt.live]
    vt.nulls["__one"] = [torch.zeros_like(lv) for lv in vt.live]
    vt.origin["__one"] = S.ShardedColumn("planes", pa.int64())
    out = aggregate_vtable(sess, vt, ["__one"],
                           [("key:__one", None)] + list(aggs),
                           ["__one"] + list(names)).drop_columns(["__one"])
    if out.num_rows:
        return out
    # no joined rows at all: SQL still yields one row of neutrals
    return sess._empty_result(vt, [], aggs, names)


def project_vtable(vt: VTable, q) -> pa.Table:
    """A bare SELECT of plain columns: the live rows of every shard,
    decoded to their arrow types (shard order)."""
    names, srcs = [], []
    for it in q.items:
        if not isinstance(it.expr, ast.Column) or it.expr.name not in vt.cols:
            raise MeshUnsupported(f"distributed projection of "
                                  f"{render(it.expr)}")
        names.append(it.alias or it.expr.name)
        srcs.append(it.expr.name)
    cols = {}
    for nm, c in zip(names, srcs):
        vals = np.concatenate([v[m].cpu().numpy() for v, m in
                               zip(vt.cols[c], vt.live)])
        nl = np.concatenate([v[m].cpu().numpy() for v, m in
                             zip(vt.nulls[c], vt.live)])
        sc = vt.origin[c]
        if sc.kind == "dict":
            arr = sc.vocab().take(pa.array(np.where(nl, 0, vals)))
            if nl.any():
                arr = pc.if_else(pa.array(~nl), arr,
                                         pa.scalar(None, sc.arrow_type))
        elif sc.kind == "float":
            arr = pa.array(vals, pa.float64(), mask=nl if nl.any()
                           else None).cast(sc.arrow_type)
        else:
            arr = S._restore_int(vals, nl, sc.arrow_type)
        cols[nm] = arr
    return pa.table(cols)


# -- the SQL entry point ----------------------------------------------------------------

def _flatten_joins(node) -> Tuple[List[str], List[Tuple[str, str]]]:
    """Join tree -> (table names in order, [(col_a, col_b)] equality
    edges).  Left-deep INNER / CROSS trees; comma joins contribute no
    edge here (their equalities come from WHERE)."""
    if isinstance(node, ast.TableRef):
        return [node.name], []
    if not (isinstance(node, ast.Join) and node.kind in ("inner", "cross")):
        raise MeshUnsupported("distributed joins: INNER / CROSS equi-joins")
    tables, edges = _flatten_joins(node.left)
    if not isinstance(node.right, ast.TableRef):
        raise MeshUnsupported("distributed joins: left-deep join trees")
    tables.append(node.right.name)
    if node.kind == "cross":
        return tables, edges
    for conj in split_conjuncts(node.on):
        if not (isinstance(conj, ast.Binary) and conj.op == "="
                and isinstance(conj.left, ast.Column)
                and isinstance(conj.right, ast.Column)):
            raise MeshUnsupported("distributed joins: equality ON "
                                  "conditions")
        edges.append((conj.left.name, conj.right.name))
    return tables, edges


def _synth_group_keys(q, kinds, dictres):
    """Expression GROUP BY keys (TPC-H q9's extract(year ...)): compile
    each to value IR, ship its source columns, and group by a derived
    column.  Select items and ORDER BY items naming the expression read
    the derived column; an ORDER BY on one that is no select item gets a
    hidden item.  -> (q, [(name, ir, cols)], hidden item names)."""
    synth: List[tuple] = []
    hidden: List[str] = []
    if not q.group_by or all(isinstance(g, ast.Column) for g in q.group_by):
        return q, synth, hidden
    q = copy.copy(q)
    q.items = list(q.items)
    q.order_by = list(q.order_by)
    newgb = []
    for g in q.group_by:
        if isinstance(g, ast.Column):
            newgb.append(g)
            continue
        ir, gcols = S.compile_expr(g, kinds, dictres,
                                   "distributed GROUP BY expression")
        name = f"__gk{len(synth)}"
        synth.append((name, ir, tuple(sorted(gcols))))
        gr = render(g)
        newgb.append(ast.Column(name))
        out_name = None
        for i, it in enumerate(q.items):
            if render(it.expr) == gr:
                out_name = it.alias or gr
                q.items[i] = ast.SelectItem(ast.Column(name), out_name)
        if out_name is None and any(render(o.expr) == gr
                                    for o in q.order_by):
            out_name = name
            hidden.append(name)
            q.items.append(ast.SelectItem(ast.Column(name), name))
        if out_name is not None:
            q.order_by = [ast.OrderItem(ast.Column(out_name), o.desc,
                                        o.nulls_first)
                          if render(o.expr) == gr else o
                          for o in q.order_by]
    q.group_by = newgb
    return q, synth, hidden


def execute_dist_join(sess, q) -> pa.Table:
    tables, edges = _flatten_joins(q.from_)
    for t in tables:
        if t not in sess.tables:
            raise MeshUnsupported(f"unregistered table {t}")
    if len(set(tables)) != len(tables):
        raise MeshUnsupported("distributed joins: a table joined twice")
    dts = {t: sess.tables[t] for t in tables}

    def base_owner(col: str) -> str:
        for t in tables:
            if col in dts[t].columns:
                return t
        raise MeshUnsupported(f"column {col} not in the joined tables")

    merged_scols = {}
    for t in tables:
        merged_scols.update(dts[t].columns)
    kinds = S.kinds_of(merged_scols)
    dictres = S.make_dictres(merged_scols)

    q, synth_keys, hidden = _synth_group_keys(q, kinds, dictres)
    synth_names = {n for n, _ir, _c in synth_keys}

    # split WHERE: one table's conjuncts filter it, two-table column
    # equalities are join edges, the rest is boolean IR over joined rows
    per_table: Dict[str, list] = {t: [] for t in tables}
    residual_ir: List[tuple] = []
    never_any = False
    for conj in split_conjuncts(q.where):
        if isinstance(conj, ast.Literal):
            never_any = never_any or conj.value is not True
            continue
        cols: set = set()
        collect_columns(conj, cols)
        owners = {base_owner(c) for c in cols}
        if (len(owners) == 2 and isinstance(conj, ast.Binary)
                and conj.op == "=" and isinstance(conj.left, ast.Column)
                and isinstance(conj.right, ast.Column)):
            edges.append((conj.left.name, conj.right.name))
        elif len(owners) == 1:
            per_table[owners.pop()].append(conj)
        else:
            ir, _c = S.compile_bool(conj, kinds, dictres,
                                    "distributed joins: WHERE conjunct")
            residual_ir.append(ir)

    # composite equi-joins: two edges between one table pair pack into
    # ONE synthetic key on both sides (TPC-H q9's partsupp), named per
    # pair so a table in two pairs keeps both
    synth_owner: Dict[str, str] = {}
    packed_cols: Dict[str, list] = {}  # table -> [(name, ca, cb, lo, C)]
    by_pair = defaultdict(list)
    for a, b in edges:
        by_pair[tuple(sorted((base_owner(a), base_owner(b))))].append((a, b))
    if any(len(v) > 1 for v in by_pair.values()):
        new_edges = []
        for pair, es in sorted(by_pair.items()):
            if len(es) == 1:
                new_edges.extend(es)
                continue
            if len(es) > 2:
                raise MeshUnsupported("distributed joins: 3+-column "
                                      "composite key")
            scs = {}
            for a, b in es:
                for c in (a, b):
                    sc = dts[base_owner(c)].columns[c]
                    if sc.kind != "planes" or sc.ref < 0:
                        raise MeshUnsupported(
                            "distributed composite join: integer keys")
                    scs[c] = sc
            (a1, b1), (a2, b2) = es
            if base_owner(a1) != pair[0]:
                a1, b1 = b1, a1
            if base_owner(a2) != pair[0]:
                a2, b2 = b2, a2
            lo = min(scs[a2].ref, scs[b2].ref)
            hi = max(scs[a2].ref + (1 << scs[a2].width),
                     scs[b2].ref + (1 << scs[b2].width))
            width = hi - lo
            amax = max(scs[a1].ref + (1 << scs[a1].width),
                       scs[b1].ref + (1 << scs[b1].width))
            if amax * width >= (1 << 62):
                raise MeshUnsupported("distributed composite join: packed "
                                      "key overflows")
            names = []
            for side, (c1, c2) in zip(pair, ((a1, a2), (b1, b2))):
                nm = f"__jk_{side}__{pair[0]}__{pair[1]}"
                packed_cols.setdefault(side, []).append(
                    (nm, c1, c2, lo, width))
                synth_owner[nm] = side
                names.append(nm)
            new_edges.append(tuple(names))
        edges = new_edges

    def owner(col: str) -> str:
        return synth_owner.get(col) or base_owner(col)

    # string columns hold ids into their own table's vocabulary: ids of
    # two tables do not compare
    for a, b in edges:
        for c in (a, b):
            if c not in synth_owner and merged_scols[c].kind == "dict":
                raise MeshUnsupported(f"distributed join on string column "
                                      f"{c}")

    # left-deep join order: follow edges greedily from the first table
    joins: List[Tuple[str, str, str]] = []   # (cur col, right table, its col)
    residual_eq: List[Tuple[str, str]] = []  # second keys: post filters
    placed = {tables[0]}
    pending = list(edges)
    while len(placed) < len(tables):
        progress = False
        for e in list(pending):
            a, b = e
            ta, tb = owner(a), owner(b)
            if ta in placed and tb not in placed:
                joins.append((a, tb, b))
                placed.add(tb)
            elif tb in placed and ta in placed:
                residual_eq.append((a, b))
            elif tb in placed and ta not in placed:
                joins.append((b, ta, a))
                placed.add(ta)
            else:
                continue
            pending.remove(e)
            progress = True
        if not progress:
            raise MeshUnsupported("distributed joins: join graph is "
                                  "disconnected (cross product)")
    residual_eq.extend(pending)

    # aggregates, or a bare projection
    item_aggs: List[ast.Func] = []
    for it in q.items:
        find_aggs(it.expr, item_aggs)
    project = not item_aggs and not q.group_by and q.having is None
    if project:
        key_cols, aggs, names, post = [], [], [], None
        out_cols = [it.expr.name for it in q.items
                    if isinstance(it.expr, ast.Column)]
    else:
        key_cols, aggs, names, post = S.plan_agg_items(q, merged_scols)
        out_cols = []

    # the columns each table ships forward
    needed: Dict[str, set] = {t: set() for t in tables}
    for c in out_cols:
        needed[owner(c)].add(c)
    for kc in key_cols:
        if kc not in synth_names:
            needed[owner(kc)].add(kc)
    for _n, _ir, scols in synth_keys:
        for c in scols:
            needed[owner(c)].add(c)
    for _kind, s in aggs:
        for c in S._spec_cols(s):
            needed[owner(c)].add(c)
    for lcol, rt, rcol in joins:
        if lcol not in synth_owner:
            needed[owner(lcol)].add(lcol)
        if rcol not in synth_owner:
            needed[rt].add(rcol)
    for t, plist in packed_cols.items():
        for (_nm, ca, cb, _lo, _w) in plist:
            needed[t].update((ca, cb))
    for a, b in residual_eq:
        needed[owner(a)].add(a)
        needed[owner(b)].add(b)

    from liquid_tpu_torch.sql.fused_agg import bool_ir_columns

    # per table: the direct planner's predicates; a conjunct it does not
    # take (IN list, OR group, LIKE) becomes residual IR
    preds_of, scanned = {}, []
    for t in tables:
        preds = []
        for conj in per_table[t]:
            try:
                p1, n1 = sess._plan_where(conj, dts[t])
            except MeshUnsupported:
                ir, _c = S.compile_bool(conj, kinds, dictres,
                                        "distributed WHERE conjunct")
                residual_ir.append(ir)
                continue
            preds.extend(p1)
            never_any = never_any or n1
        preds_of[t] = preds
    for ir in residual_ir:
        for c in bool_ir_columns(ir):
            needed[owner(c)].add(c)

    vts: Dict[str, VTable] = {}
    for t in tables:
        vts[t] = decode_filtered(sess, dts[t], preds_of[t],
                                 sorted(needed[t]))
        scanned.append(dts[t].scan_device_bytes(
            [p.col for p in preds_of[t]] + sorted(needed[t])))
    sess.last_scan_bytes = sum(scanned)
    if never_any:  # provably empty: every row of the first table dies
        vts[tables[0]].live = [torch.zeros_like(lv)
                               for lv in vts[tables[0]].live]

    # materialize composite packed join keys
    for t, plist in packed_cols.items():
        vt_ = vts[t]
        for (nm, ca, cb, lo, width) in plist:
            vt_.cols[nm] = [a * width + (b - lo) for a, b in
                            zip(vt_.cols[ca], vt_.cols[cb])]
            vt_.nulls[nm] = [a | b for a, b in
                             zip(vt_.nulls[ca], vt_.nulls[cb])]
            vt_.origin[nm] = S.ShardedColumn("planes", pa.int64())

    # the left-deep pipeline of shuffle joins; the first table carries its
    # own synthetic keys forward
    cur = vts[tables[0]]
    cur_cols = set(needed[tables[0]]) | {
        n for n, t in synth_owner.items() if t == tables[0]}
    for lcol, rt, rcol in joins:
        right = vts[rt]
        a = exchange_by_key(cur, lcol)
        b = exchange_by_key(right, rcol)
        pnames = sorted(cur_cols - {lcol}) + [lcol]
        rt_synth = {n for n, t2 in synth_owner.items() if t2 == rt}
        bnames = sorted((set(needed[rt]) | rt_synth) - {rcol})
        for side, col in ((a, lcol), (b, rcol)):
            side.cols["__k"] = side.cols[col]
            side.nulls["__k"] = side.nulls[col]
            side.origin["__k"] = side.origin[col]
        joined = join_copartitioned(a, b, "__k", (pnames, bnames))
        if rcol not in joined.cols and rcol in needed[rt]:
            joined.cols[rcol] = joined.cols[lcol]
            joined.nulls[rcol] = joined.nulls[lcol]
            joined.origin[rcol] = right.origin[rcol]
        cur = joined
        cur_cols = set(joined.cols) - {"__k"}
        for d in (cur.cols, cur.nulls, cur.origin):
            d.pop("__k", None)

    for a, b in residual_eq:
        if a not in cur.cols or b not in cur.cols:
            raise MeshUnsupported(f"residual join key {a} = {b}")
        cur.live = [lv & (x == y) & ~na & ~nb for lv, x, y, na, nb in zip(
            cur.live, cur.cols[a], cur.cols[b], cur.nulls[a], cur.nulls[b])]
    for ir in residual_ir:
        cur.live = [lv & S.eval_bool(ir, _env(cur, s))
                    for s, lv in enumerate(cur.live)]
    for name, ir, _scols in synth_keys:
        parts = [S.eval_ir(ir, _env(cur, s)) for s in range(cur.n_dev)]
        if parts[0][0].dtype == torch.float64:
            sc = S.ShardedColumn("float", pa.float64())
            vals = [v for v, _n in parts]
        else:
            sc = S.ShardedColumn("planes", pa.int64())
            vals = [v.to(torch.int64) for v, _n in parts]
        cur.cols[name] = [v.contiguous() for v in vals]
        cur.nulls[name] = [nl.contiguous() for _v, nl in parts]
        cur.origin[name] = sc

    if project:
        out = project_vtable(cur, q)
        return S.order_limit(q, out, list(out.column_names))
    if key_cols:
        out = aggregate_vtable(sess, cur, key_cols, aggs, names)
    else:
        out = scalar_aggregate_vtable(sess, cur, aggs, names)
    out = S.finish(q, out, post)
    return out.drop_columns(hidden) if hidden else out
