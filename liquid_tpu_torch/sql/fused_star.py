"""Fused device star/snowflake join + aggregation (port of
`liquid_tpu/sql/fused_star.py`, single-column keys).

A fact table joined to a tree of N:1 dimensions on single-column integer
or date keys runs on the device without a host Arrow round trip:

    dimension (children first): encoded scan -> packed predicates
        -> residual IR -> child-probe semijoins
        -> direct-address index table over the key domain
           (idx[key - lo] = dimension row, -1 = absent)
        -> decoded payload columns (values, global vocabulary ids)
    fact: the fused program of `sql/fused_agg.py` with a probe per
        fact-adjacent dimension (index gather, INNER-join mask), payload
        columns read through the probe, and the grouped or scalar
        reduction

The only fetches are one combined key-uniqueness flag vector on a first
run and the result.  Join semantics are guarded, never approximated:
each dimension must be unique on its join key after its filters (the
build counts duplicates on the device; a repeated key raises, since the
classic join path that would keep the row multiplicity is not ported),
NULL keys never match, and only INNER (and cross) joins are planned.

count(DISTINCT col) over a star runs as the host fold
(`fused_agg.distinct_two_level`) over one star aggregate grouped by the
keys and the DISTINCT columns.  `_MiniPlanner` gives the fused bare
SELECT (`fused_agg.try_fused_select`) this module's planner surface over
one table.

Not ported yet, each raising NotImplementedError that names it: composite
two-column keys (TPC-H q9), existence probes (EXISTS / IN subqueries;
q4, q16, q21, q22), aliased relations and self-joins (q7, q8).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import pyarrow as pa
import torch

from liquid_tpu_torch.arrays.base import BLOCK_ROWS
from liquid_tpu_torch.ops import mask as mops
from liquid_tpu_torch.sql import ast
from liquid_tpu_torch.sql.fused_agg import (
    _AGG_KINDS, STATS, _add, _as_f64, _Bail, _bool_nonnull, _build_vocab,
    _compile_bool, _compile_expr, _Decoders, _expr_key_type, _gid_stack,
    _ir_dtype, _like_regex, _Plan, _plan_cache_key, _plan_slots, _rowvalid,
    _scaled_col_info, _schema_kind, _select_blocks, _selection_packed,
    _table_prep, _value_type, execute_plan, payload_bounds, plan_having,
    plan_topk, pred_alt, probe_dims, register_col,
)
from liquid_tpu_torch.sql.physical import collect_columns, render
from liquid_tpu_torch.sql.planner import plan_scan_filters, split_conjuncts

#: index tables larger than this are refused (2^27 int32 entries, 512 MB)
MAX_DIM_SPAN = 1 << 27

#: built dimensions cached per table, and star plans per executor
_PROBE_CACHE_CAP = 4
_PLAN_CACHE_CAP = 8

#: payload-identity generations for the probe cache: `id()` can be reused
#: after a payload is freed; a generation stamped on first sight cannot
_PAYLOAD_GEN = iter(range(1, 1 << 62)).__next__


def _gen_of(pp) -> int:
    g = getattr(pp, "_liquid_gen", None)
    if g is None:
        g = pp._liquid_gen = _PAYLOAD_GEN()
    return g


# -- dimension build ----------------------------------------------------------

def _dim_build(p: _Plan, key_name: str, tblsize: int, pays, lo_ix: int
               ) -> List[torch.Tensor]:
    """One dimension's device build: filter -> residuals -> child-probe
    semijoins -> the unique-key direct-address index and the payload
    decode.  -> [idx int32[tblsize], dup bool, then vals and nulls per
    payload (pname, ptype)]."""
    arrays = p.arrays
    sel = _selection_packed(p.colmap, p.pred_groups, arrays,
                            arrays[p.rv_ix])
    selb = mops.unpack_bits(sel).reshape(-1)
    env = _Decoders(p.colmap, arrays, selb.shape[0], selb.device)
    selb = probe_dims(p.probes, arrays, env, selb)
    for ir in p.resids:
        selb = selb & _bool_nonnull(ir, env)
    rel = env.decode(key_name, "i64") - arrays[lo_ix]
    valid = selb & ~env.nulls(key_name) & (rel >= 0) & (rel < tblsize)
    # torch has no dropping scatter: filtered rows land in a spare entry
    # past the table, sliced off after
    slot = torch.where(valid, rel, torch.full_like(rel, tblsize))
    n = slot.shape[0]
    rows = torch.arange(n, dtype=torch.int32, device=slot.device)
    idx = torch.full((tblsize + 1,), -1, dtype=torch.int32,
                     device=slot.device).scatter_(0, slot, rows)[:tblsize]
    # exact in any order; a repeated key makes the scatter above pick one
    # row, and the flag stops the query
    cnt = torch.zeros(tblsize + 1, dtype=torch.int32, device=slot.device)
    cnt.index_add_(0, slot, torch.ones_like(rows))
    outs = [idx, (cnt[:tblsize] > 1).any()]
    for pname, ptype in pays:
        outs.append(env.decode(pname, "f64" if ptype == "f64" else "i64"))
        outs.append(env.nulls(pname))
    return outs


# -- planning -----------------------------------------------------------------

class _Probe:
    """Runtime handle of one built dimension (device tensors)."""

    __slots__ = ("idx", "lo", "hi", "dup", "verified", "payload", "vocabs",
                 "pay_bounds", "nbytes", "cache_key", "nrows", "cached",
                 "plans")

    def __init__(self):
        self.dup = None          # device bool scalar until verified
        self.verified = False
        self.payload = {}        # name -> (vals, nulls, ptype)
        self.vocabs = {}         # name -> vocabulary (gid payloads)
        self.pay_bounds = {}     # name -> (lo, hi) value bounds
        self.nbytes = 0
        self.nrows = 1           # dimension scan rows: j in [0, nrows)
        self.cached = False      # held by the table's probe cache, charged
        self.plans = {}          # star plan key -> the plan cache holding it

    def evict(self, budget) -> None:
        """Release the probe's charge and drop the cached star plans whose
        arrays pin its tensors, so the budget bounds what stays alive."""
        budget.release_memory(self.nbytes)
        for ck, cache in self.plans.items():
            cache.pop(ck, None)
        self.plans.clear()
        self.cached = False


class _Fields:
    """table.field(col) across every relation (for _plan_slots)."""

    def __init__(self, tables):
        self._tables = list(tables)

    def field(self, c: str) -> pa.Field:
        for t in self._tables:
            if c in t.column_names:
                return t.field(c)
        raise KeyError(c)


def _has_sub(e) -> bool:
    if isinstance(e, (ast.Subquery, ast.InSubquery, ast.Exists,
                      ast.CorrLookup)):
        return True
    for f_ in getattr(e, "__dataclass_fields__", {}):
        v = getattr(e, f_)
        if isinstance(v, ast.Expr) and _has_sub(v):
            return True
        if isinstance(v, (list, tuple)):
            for x in v:
                if isinstance(x, ast.Expr) and _has_sub(x):
                    return True
                if isinstance(x, tuple) and any(
                        isinstance(y, ast.Expr) and _has_sub(y) for y in x):
                    return True
    return False


def _and_all(exprs):
    out = None
    for e in exprs:
        out = e if out is None else ast.Binary("and", out, e)
    return out


def _next_pow2(n: int) -> int:
    m = 1
    while m < n:
        m <<= 1
    return m


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} over a star join is not ported yet")


class _StarPlanner:
    def __init__(self, executor, q, key_names, slots, rew_keys, rew_inputs,
                 where):
        self.ex = executor
        self.q = q
        self.key_names = key_names
        self.slots = slots
        self.rew_keys = rew_keys
        self.rew_inputs = rew_inputs
        self.where = where
        self.preps: Dict[Tuple[str, str], object] = {}
        self.blocks: Dict[str, tuple] = {}
        self.plans: Dict[str, object] = {}
        self.all_probes: List[_Probe] = []  # every dimension, any depth
        self.probe_by_dim: Dict[str, _Probe] = {}

    # -- shape detection ---------------------------------------------------

    def detect(self):
        leaves: List[ast.TableRef] = []
        ons: List[ast.Expr] = []

        def walk(rel):
            if isinstance(rel, ast.Join):
                if rel.kind not in ("inner", "cross"):
                    raise _Bail(f"{rel.kind} join")
                walk(rel.left)
                walk(rel.right)
                if rel.on is not None:
                    ons.extend(split_conjuncts(rel.on))
            elif isinstance(rel, ast.TableRef):
                if rel.name not in self.ex.catalog:
                    raise _Bail(f"non-parquet relation {rel.name}")
                if rel.prefix:
                    raise _not_ported(f"the aliased relation {rel.name} "
                                      f"{rel.alias or ''} (_AliasedTable, "
                                      f"self-joins)")
                leaves.append(rel)
            else:
                raise _Bail("derived-table relation")

        walk(self.q.from_)
        if len(leaves) < 2:
            raise _Bail("single relation")
        self.tables = {}
        for leaf in leaves:
            if leaf.name in self.tables:
                raise _Bail(f"duplicate relation {leaf.name}")
            self.tables[leaf.name] = self.ex.catalog[leaf.name]
        names = list(self.tables)
        self.owner: Dict[str, str] = {}
        for n in names:
            for c in self.tables[n].column_names:
                if c in self.owner:
                    raise _Bail(f"ambiguous column {c}")
                self.owner[c] = n

        edges: List[Tuple[str, str, str, str]] = []
        self.per_table: Dict[str, List[ast.Expr]] = {n: [] for n in names}
        self.cross: List[ast.Expr] = []
        for e in split_conjuncts(self.where) + ons:
            if _has_sub(e):
                raise _not_ported("a WHERE subquery (an existence probe "
                                  "for EXISTS / IN, build_exist_probe; a "
                                  "correlated scalar lookup)")
            cols: set = set()
            collect_columns(e, cols)
            owners = set()
            for c in cols:
                if c not in self.owner:
                    raise _Bail(f"unknown column {c}")
                owners.add(self.owner[c])
            is_eq = (isinstance(e, ast.Binary) and e.op == "="
                     and isinstance(e.left, ast.Column)
                     and isinstance(e.right, ast.Column))
            if is_eq and len(owners) == 2:
                a, b = e.left.name, e.right.name
                edges.append((a, b, self.owner[a], self.owner[b]))
            elif len(owners) == 1:
                self.per_table[owners.pop()].append(e)
            else:
                self.cross.append(e)

        # fact = the largest table; a BFS spanning tree over the equi
        # edges.  An edge whose child-side key domain is narrower than
        # the child's row count can never be unique (q5's c_nationkey =
        # s_nationkey attaching customer): feasible edges first, then any
        # (the runtime duplicate check still guards correctness)
        self.fact = max(names, key=lambda n: self.tables[n].num_rows)
        visited = {self.fact}
        self.tree: Dict[str, Tuple[str, str, str]] = {}
        used: set = set()
        changed = True
        while changed:
            changed = False
            for feasible_only in (True, False):
                for i, (a, b, ta, tb) in enumerate(edges):
                    if i in used:
                        continue
                    if ta in visited and tb not in visited:
                        child, par, pcol, ccol = tb, ta, a, b
                    elif tb in visited and ta not in visited:
                        child, par, pcol, ccol = ta, tb, b, a
                    else:
                        continue
                    if feasible_only and not self._edge_feasible(child, ccol):
                        continue
                    self.tree[child] = (par, pcol, ccol)
                    visited.add(child)
                    used.add(i)
                    changed = True
                if changed:
                    break
        if visited != set(names):
            raise _Bail("disconnected join graph")
        # a leftover equality between a child and its own tree parent is
        # the second column of a composite key; other leftovers (cycles)
        # stay fact-level residuals over gathered payloads
        for i, (a, b, ta, tb) in enumerate(edges):
            if i in used:
                continue
            if (ta in self.tree and self.tree[ta][0] == tb) or (
                    tb in self.tree and self.tree[tb][0] == ta):
                raise _not_ported("a composite two-column join key "
                                  f"({a} = {b}; the sorted chain index)")
            self.cross.append(ast.Binary("=", ast.Column(a), ast.Column(b)))

        # join keys must decode to i64 planes
        for child, (_p, pcol, ccol) in self.tree.items():
            for tbl, col in ((child, ccol), (self.owner[pcol], pcol)):
                t = self.tables[tbl].field(col).type
                if not (pa.types.is_integer(t) or pa.types.is_date32(t)
                        or pa.types.is_timestamp(t)):
                    raise _Bail(f"join key type {t}")

        self.children: Dict[str, List[str]] = {n: [] for n in names}
        for child, (par, _p, _c) in self.tree.items():
            self.children[par].append(child)

        # columns each dimension must export (group keys, aggregate
        # inputs and cross residuals evaluate at fact level)
        self.needed_by: Dict[str, set] = {n: set() for n in names}
        for ge in self.rew_keys:
            cols = set()
            collect_columns(ge, cols)
            if not cols:
                raise _Bail("constant group key")
            for c in cols:
                self._need(c)
        for s in self.slots:
            if s.input is not None:
                cols = set()
                collect_columns(self.rew_inputs[s.name], cols)
                for c in cols:
                    self._need(c)
        for e in self.cross:
            cols = set()
            collect_columns(e, cols)
            for c in cols:
                self._need(c)

    def _edge_feasible(self, child: str, ccol: str) -> bool:
        """Necessary condition for key uniqueness: the key's value domain
        at least as wide as the unfiltered dimension and narrow enough
        for a direct-address table."""
        try:
            _, blocks = self._scan(child)
            if not blocks:
                return True
            pr = self.prep_of(child, ccol)
        except _Bail:
            return False
        b = payload_bounds(pr)
        if b is None:
            return False
        span = b[1] - b[0]
        if span + 2 > MAX_DIM_SPAN:
            return False
        return span + 1 >= self.tables[child].num_rows

    def _need(self, c: str):
        t = self.owner.get(c)
        if t is None:
            raise _Bail(f"unknown column {c}")
        self.needed_by[t].add(c)

    # -- per-table scan state ------------------------------------------------

    def _scan(self, tbl: str):
        if tbl not in self.plans:
            plan = plan_scan_filters(_and_all(self.per_table[tbl]))
            self.plans[tbl] = plan
            self.blocks[tbl] = _select_blocks(self.tables[tbl], plan)
        return self.plans[tbl], self.blocks[tbl]

    def prep_of(self, tbl: str, col: str):
        key = (tbl, col)
        pr = self.preps.get(key)
        if pr is None:
            _, blocks = self._scan(tbl)
            pr = self.preps[key] = _table_prep(self.tables[tbl], col, None,
                                               blocks)
        return pr

    def kind_of(self, col: str) -> str:
        tbl = self.owner.get(col)
        if tbl is None:
            raise _Bail(f"unknown column {col}")
        _, blocks = self._scan(tbl)
        if not blocks:
            return _schema_kind(self.tables[tbl].field(col).type)
        k = self.prep_of(tbl, col).kind
        return "planes" if k == "linear" else k

    def vocab_of(self, col: str):
        tbl = self.owner.get(col)
        if tbl is None or self.kind_of(col) != "dict":
            return None
        _, blocks = self._scan(tbl)
        if not blocks:
            return []
        pr = self.prep_of(tbl, col)
        _build_vocab(pr)
        return pr.vocab_list

    def dictres(self, cname, op, lit):
        try:
            vocab = self.vocab_of(cname)
        except _Bail:
            return None
        if vocab is None:
            return None
        if op == "=":
            return tuple(i for i, v in enumerate(vocab) if v == lit)
        if op == "like":
            pat = _like_regex(str(lit))
            return tuple(i for i, v in enumerate(vocab)
                         if v is not None and pat.match(str(v)))
        return None

    class _KindsView:
        """Column kinds and arrow types for the IR compiler."""

        def __init__(self, planner):
            self.p = planner

        def get(self, c, default=None):
            try:
                return self.p.kind_of(c)
            except _Bail:
                return default

        def arrow_type(self, c):
            tbl = self.p.owner.get(c)
            return None if tbl is None else self.p.tables[tbl].field(c).type


class _MiniPlanner:
    """One table's planner surface (prep_of / kind_of / dictres and a
    kinds view) for `_register_col`, `_compile_bool` and `_compile_expr`:
    the fused bare SELECT plans through it."""

    def __init__(self, table, blocks):
        self.table = table
        self.blocks_ = blocks
        self.preps: Dict[str, object] = {}

    def prep_of(self, _tbl, col: str):
        pr = self.preps.get(col)
        if pr is None:
            pr = self.preps[col] = _table_prep(self.table, col, None,
                                               self.blocks_)
        return pr

    def kind_of(self, col: str) -> str:
        if col not in self.table.column_names:
            raise _Bail(f"unknown column {col}")
        if not self.blocks_:
            return _schema_kind(self.table.field(col).type)
        k = self.prep_of(None, col).kind
        return "planes" if k == "linear" else k

    def dictres(self, cname, op, lit):
        try:
            if self.kind_of(cname) != "dict":
                return None
        except _Bail:
            return None
        pr = self.prep_of(None, cname)
        _build_vocab(pr)
        vocab = pr.vocab_list
        if op == "=":
            return tuple(i for i, v in enumerate(vocab) if v == lit)
        if op == "like":
            pat = _like_regex(str(lit))
            return tuple(i for i, v in enumerate(vocab)
                         if v is not None and pat.match(str(v)))
        return None

    class _KV:
        """Column kinds and arrow types for the IR compiler."""

        def __init__(self, mp):
            self.p = mp

        def get(self, c, default=None):
            try:
                return self.p.kind_of(c)
            except _Bail:
                return default

        def arrow_type(self, c):
            if c in self.p.table.column_names:
                return self.p.table.field(c).type
            return None


def _prep_has_nulls(table, prep, blocks) -> bool:
    """True iff a live row of the scanned blocks is NULL (the clear tail
    bits of a short last block do not count)."""
    if prep.valid_stack is None:
        return False
    for pp, (rg, b) in zip(prep.payloads, blocks):
        v = getattr(pp, "validity_np", None)
        if v is None:
            continue
        ones = int(np.unpackbits(v.view(np.uint8), bitorder="little").sum())
        if ones != table.batch_length(rg, b):
            return True
    return False


def _register_col(p: _Plan, planner: _StarPlanner, tbl: str, c: str,
                  registered: set, gids: bool = False) -> None:
    """Register one owned column in a plan once; a later request for its
    vocabulary ids adds them to the registration."""
    pr = planner.prep_of(tbl, c)
    if c not in registered:
        register_col(p, c, pr, gids)
        registered.add(c)
    elif gids and pr.kind == "dict" and "gids" not in p.colmap[c]:
        _build_vocab(pr)
        p.colmap[c]["gids"] = _add(p, _gid_stack(pr))


def _pred_groups(p: _Plan, planner: _StarPlanner, tbl: str, plan_scan,
                 registered: set, resid_out: List, resid_cols: set):
    """Lower a table's pushdown groups into the plan.  A group touching
    a linear-coded column has no packed interval form (values are not
    monotone in the residual offsets): it becomes residual IR."""
    kinds_view = _StarPlanner._KindsView(planner)
    for g in plan_scan.pushdown:
        if any(planner.prep_of(tbl, c).kind == "linear"
               for c, _pred in g.alternatives):
            ir, cols = _compile_bool(g.source, kinds_view, planner.dictres)
            resid_out.append(ir)
            resid_cols |= cols
            continue
        alts = []
        for c, pred in g.alternatives:
            _register_col(p, planner, tbl, c, registered)
            alts.append(pred_alt(p, c, pred, planner.prep_of(tbl, c)))
        p.pred_groups.append(tuple(alts))


def _payload_type(planner: _StarPlanner, col: str) -> str:
    k = planner.kind_of(col)
    if k == "float":
        return "f64"
    if k == "dict":
        return "gid"
    return "i64"


def _add_payloads(p: _Plan, pid: int, probe: _Probe) -> None:
    """A child's payload columns as "pay" columns read through probe pid."""
    for name, (vals, nulls, ptype) in sorted(probe.payload.items()):
        p.colmap[name] = {"kind": "pay", "probe": pid, "ptype": ptype,
                          "vals": _add(p, vals), "nulls": _add(p, nulls)}


def _build_dim(planner: _StarPlanner, tbl: str) -> _Probe:
    """Build (or reuse) one dimension's probe, children first."""
    table = planner.tables[tbl]
    dev = table.cache.device
    plan_scan, blocks = planner._scan(tbl)
    key_col = planner.tree[tbl][2]

    child_probes: List[Tuple[str, _Probe]] = [
        (ch, _build_dim(planner, ch)) for ch in planner.children[tbl]]

    # payloads: own exports and the children's cascaded ones.  The own
    # join key always exports: probe-index grouping recovers the key as
    # vals[j] at pack time
    own = set(planner.needed_by[tbl]) | {key_col}
    pays = [(c, _payload_type(planner, c)) for c in sorted(own)]
    for _ch, pb in child_probes:
        pays += [(name, ptype) for name, (_v, _n, ptype)
                 in sorted(pb.payload.items())]

    if not blocks:
        # empty dimension: nothing matches (an INNER join annihilates)
        probe = _Probe()
        probe.idx = torch.full((2,), -1, dtype=torch.int32, device=dev)
        probe.lo, probe.hi = 0, -1  # an impossible range prunes the parent
        probe.verified = True
        for name, ptype in pays:
            dt = torch.float64 if ptype == "f64" else torch.int64
            probe.payload[name] = (torch.zeros(1, dtype=dt, device=dev),
                                   torch.zeros(1, dtype=torch.bool,
                                               device=dev), ptype)
        for _ch, pb in child_probes:
            probe.vocabs.update(pb.vocabs)
        for c in sorted(planner.needed_by[tbl]):
            if planner.kind_of(c) == "dict":
                probe.vocabs[c] = planner.vocab_of(c) or []
        probe.cache_key = ("empty", tbl, tuple(pays))
        planner.all_probes.append(probe)
        planner.probe_by_dim[tbl] = probe
        return probe

    # key domain from the key column's block references and widths
    kpr = planner.prep_of(tbl, key_col)
    kb = payload_bounds(kpr)
    if kb is None:
        raise _Bail(f"join key kind {kpr.kind}")
    lo, hi = kb
    span = hi - lo
    if span + 2 > MAX_DIM_SPAN:
        raise _Bail(f"dim key domain {span} too wide")
    tblsize = _next_pow2(int(span) + 2)

    kinds_view = _StarPlanner._KindsView(planner)
    p = _Plan()
    registered: set = set()
    resid_cols: set = set()
    for e in plan_scan.residual:
        ir, cols = _compile_bool(e, kinds_view, planner.dictres)
        p.resids.append(ir)
        resid_cols |= cols
    _pred_groups(p, planner, tbl, plan_scan, registered, p.resids,
                 resid_cols)
    for c in sorted(resid_cols):
        _register_col(p, planner, tbl, c, registered,
                      planner.kind_of(c) == "dict")
    _register_col(p, planner, tbl, key_col, registered)

    vocabs: Dict[str, list] = {}
    pay_bounds: Dict[str, tuple] = {}
    for pid, (ch, pb) in enumerate(child_probes):
        cpcol = planner.tree[ch][1]
        _register_col(p, planner, tbl, cpcol, registered)
        p.probes.append((pid, cpcol, _add(p, pb.idx), _add(p, torch.tensor(
            pb.lo, dtype=torch.int64, device=dev))))
        _add_payloads(p, pid, pb)
        vocabs.update(pb.vocabs)
        pay_bounds.update(pb.pay_bounds)
    for c in sorted(planner.needed_by[tbl]):
        k = planner.kind_of(c)
        _register_col(p, planner, tbl, c, registered, k == "dict")
        if k == "dict":
            vocabs[c] = planner.vocab_of(c) or []
        else:
            b = payload_bounds(planner.prep_of(tbl, c))
            if b is not None:
                pay_bounds[c] = b
    p.rv_ix = _add(p, _rowvalid(table, blocks))
    klo_ix = _add(p, torch.tensor(lo, dtype=torch.int64, device=dev))

    # predicate literals, residuals, the blocks and the key payloads'
    # identity pin a cached build
    cache_key = (tbl, key_col, tblsize, tuple(pays),
                 tuple(render(g.source) for g in plan_scan.pushdown),
                 tuple(render(e) for e in plan_scan.residual), blocks,
                 tuple(_gen_of(pp) for pp in kpr.payloads),
                 tuple(pb.cache_key for _ch, pb in child_probes))
    cache = getattr(table, "_star_probe_cache", None)
    if cache is None:
        cache = table._star_probe_cache = {}
    hit = cache.get(cache_key)
    if hit is not None:
        planner.all_probes.append(hit)
        planner.probe_by_dim[tbl] = hit
        return hit

    outs = _dim_build(p, key_col, tblsize, pays, klo_ix)
    probe = _Probe()
    probe.idx, probe.dup = outs[0], outs[1]
    probe.lo, probe.hi = int(lo), int(hi)
    probe.nrows = len(blocks) * BLOCK_ROWS
    probe.vocabs = vocabs
    probe.pay_bounds = pay_bounds
    probe.cache_key = cache_key
    for k, (name, ptype) in enumerate(pays):
        probe.payload[name] = (outs[2 + 2 * k], outs[3 + 2 * k], ptype)
    probe.nbytes = sum(a.numel() * a.element_size() for a in outs)
    budget = table.cache.budget
    if budget.try_reserve_memory(probe.nbytes):
        if len(cache) >= _PROBE_CACHE_CAP:
            cache.pop(next(iter(cache))).evict(budget)
        cache[cache_key] = probe
        probe.cached = True
    else:
        probe.nbytes = 0  # not cached, not charged: no plan may keep it
    planner.all_probes.append(probe)
    planner.probe_by_dim[tbl] = probe
    return probe


def _detect_fd(planner: _StarPlanner, p: _Plan) -> None:
    """Functional-dependency group-key reduction: when one group key
    determines every other (the others are payloads of the dimension
    hanging off it -- q3's GROUP BY l_orderkey, o_orderdate,
    o_shippriority; q10's GROUP BY c_custkey, c_name, ...), the reduction
    runs on that one key and the derived keys re-attach by gathers over
    the packed output rows.  The dependency is structural: key-unique
    dimensions (verified on the device) make their attributes functions
    of the join key.  A fact-adjacent dimension reduces on the probe
    index j (probe-index mode: the table shrinks from the key span to
    the dimension's rows); a deeper one on the key's value."""
    key_cols = p.keys
    for rep_pos, rep in enumerate(key_cols):
        if not isinstance(rep, str):
            continue  # expression keys cannot represent
        cand = None
        if planner.owner.get(rep) == planner.fact:
            # the fact-side probe key of a fact-adjacent dimension
            for child in planner.children[planner.fact]:
                if planner.tree[child][1] == rep:
                    cand = child
                    break
        else:
            # a dimension's own key column riding up as a payload
            for dname, (_par, _pcol, ccol) in planner.tree.items():
                if ccol == rep:
                    cand = dname
                    break
        if cand is None or cand not in planner.probe_by_dim:
            continue
        pb = planner.probe_by_dim[cand]
        others = [(i, c) for i, c in enumerate(key_cols) if i != rep_pos]
        if not all(c in pb.payload for _i, c in others):
            continue
        ccol = planner.tree[cand][2]
        if planner.tree[cand][0] == planner.fact and ccol in pb.payload:
            pid = next((pid2 for pid2, pcol2, _ix, _lo in p.probes
                        if pcol2 == planner.tree[cand][1]), None)
            if pid is not None:
                entries = []
                for i, c in [(rep_pos, ccol)] + others:
                    vals, nulls, ptype = pb.payload[c]
                    entries.append((i, -1, -1, _add(p, vals), _add(p, nulls),
                                    "f64" if ptype == "f64" else "i64"))
                p.fd = (rep_pos, len(key_cols), tuple(entries))
                p.phys_keys = [("probe", pid)]
                p.key_bounds[("probe", pid)] = (0, pb.nrows - 1)
                return
        if len(key_cols) < 2:
            continue  # value mode only pays with derived keys
        idx_ix = _add(p, pb.idx)
        lo_ix = _add(p, torch.tensor(pb.lo, dtype=torch.int64,
                                     device=pb.idx.device))
        entries = []
        for i, c in others:
            vals, nulls, ptype = pb.payload[c]
            entries.append((i, idx_ix, lo_ix, _add(p, vals), _add(p, nulls),
                            "f64" if ptype == "f64" else "i64"))
        p.fd = (rep_pos, len(key_cols), tuple(entries))
        p.phys_keys = [rep]
        return


def _plan_fact(planner: _StarPlanner, dims: Dict[str, _Probe]):
    """The fact side's plan (columns, predicates, probes, residuals, keys,
    slots) -> (plan, "grouped" | "scalar", empty)."""
    from liquid_tpu_torch.sql.device_agg import KeyCodec

    fact = planner.fact
    table = planner.tables[fact]
    dev = table.cache.device

    # dynamic key ranges: each fact-adjacent dimension's key domain
    # becomes range conjuncts on the fact scan, pruning fact blocks
    # before any IO; an empty dimension's impossible range empties it
    for child, probe in dims.items():
        pcol = planner.tree[child][1]
        if planner.owner[pcol] != fact \
                or not pa.types.is_integer(table.field(pcol).type):
            continue
        planner.per_table[fact].append(
            ast.Binary(">=", ast.Column(pcol), ast.Literal(probe.lo)))
        planner.per_table[fact].append(
            ast.Binary("<=", ast.Column(pcol), ast.Literal(probe.hi)))

    plan_scan, blocks = planner._scan(fact)
    empty = not blocks
    kinds_view = _StarPlanner._KindsView(planner)

    # slot inputs, fact residuals and cross residuals first: they name the
    # columns the program reads
    slot_irs: Dict[str, Tuple[tuple, set]] = {}
    for s in planner.slots:
        if s.input is None:
            continue
        e = planner.rew_inputs[s.name]
        if s.kind == "count" and isinstance(e, ast.Column) \
                and planner.kind_of(e.name) == "dict":
            slot_irs[s.name] = (("col", e.name, "i64"), {e.name})
        else:
            slot_irs[s.name] = _compile_expr(e, kinds_view, planner.dictres)
        if s.kind in ("min", "max") and isinstance(e, ast.Column):
            t = planner.tables[planner.owner[e.name]].field(e.name).type
            if pa.types.is_uint64(t):
                raise _Bail("min/max over uint64")

    def bounds_of(c):
        if planner.owner.get(c) == fact:
            try:
                return payload_bounds(planner.prep_of(fact, c))
            except _Bail:
                return None
        for pb2 in dims.values():
            if c in pb2.pay_bounds:
                return pb2.pay_bounds[c]
        return None

    # avg(int) accumulates in i64 only when bounds prove no overflow
    n_upper = len(blocks) * BLOCK_ROWS
    for s in planner.slots:
        if s.kind != "avg" or s.name not in slot_irs:
            continue
        ir, cols_ = slot_irs[s.name]
        if _ir_dtype(ir) != "i64":
            continue
        b = bounds_of(ir[1]) if ir[0] == "col" and not empty else None
        if b is None or max(abs(b[0]), abs(b[1])) * max(n_upper, 1) \
                >= (1 << 62):
            slot_irs[s.name] = (_as_f64(ir), cols_)

    p = _Plan()
    resid_cols: set = set()
    for e in list(plan_scan.residual) + planner.cross:
        ir, cols = _compile_bool(e, kinds_view, planner.dictres)
        p.resids.append(ir)
        resid_cols |= cols

    key_expr_cols: set = set()
    key_types: Dict[int, pa.DataType] = {}
    for ki, ge in enumerate(planner.rew_keys):
        if isinstance(ge, ast.Column):
            p.keys.append(ge.name)
        else:
            ir, cols = _compile_expr(ge, kinds_view, planner.dictres)
            dt = _ir_dtype(ir)
            p.keys.append(("expr", ir, dt))
            key_expr_cols |= cols
            key_types[ki] = _expr_key_type(ge, dt)
    p.key_out = list(planner.key_names)
    fields = _Fields(planner.tables.values())

    if empty:
        # zero fact blocks: a typed empty result, no probes needed
        for ki, c in enumerate(p.keys):
            if isinstance(c, tuple):
                p.key_decoders.append(("codec", KeyCodec(key_types[ki])))
            else:
                _empty_key_decoder(planner, p, c)
        _plan_slots(p, planner.slots, slot_irs, planner.rew_inputs, fields)
        return p, ("grouped" if planner.key_names else "scalar"), True

    registered: set = set()
    _pred_groups(p, planner, fact, plan_scan, registered, p.resids,
                 resid_cols)

    def reg(c: str, gids: bool = False):
        if planner.owner[c] == fact:  # dimension columns ride as payloads
            _register_col(p, planner, fact, c, registered, gids)

    # probes of the fact-adjacent dimensions and their payload columns
    adjacent = sorted(ch for ch in dims if planner.tree[ch][0] == fact)
    for pid, child in enumerate(adjacent):
        probe = dims[child]
        pcol = planner.tree[child][1]
        reg(pcol)
        p.probes.append((pid, pcol, _add(p, probe.idx), _add(p, torch.tensor(
            probe.lo, dtype=torch.int64, device=dev))))
        _add_payloads(p, pid, probe)

    # the remaining fact columns the program reads
    needed: set = set(resid_cols) | key_expr_cols
    for s in planner.slots:
        if s.name in slot_irs:
            needed |= slot_irs[s.name][1]
    needed |= {c for c in p.keys if isinstance(c, str)}
    for c in sorted(needed):
        if planner.owner[c] == fact:
            reg(c, planner.kind_of(c) == "dict" and (
                c in resid_cols or c in p.keys or any(
                    c in slot_irs[s.name][1] and slot_irs[s.name][0][0]
                    != "col" for s in planner.slots if s.name in slot_irs)))

    _detect_fd(planner, p)

    for ki, c in enumerate(p.keys):
        if isinstance(c, tuple):
            p.key_decoders.append(("codec", KeyCodec(key_types[ki])))
            continue
        tbl = planner.owner[c]
        ft = planner.tables[tbl].field(c).type
        if tbl == fact:
            if planner.kind_of(c) == "dict":
                pr = planner.prep_of(fact, c)
                _build_vocab(pr)
                p.key_decoders.append(("vocab", pr.vocab_list,
                                       _value_type(ft)))
                reg(c, gids=True)
            else:
                p.key_decoders.append(("codec", KeyCodec(ft)))
                b = payload_bounds(planner.prep_of(fact, c))
                if b is not None:
                    p.key_bounds[c] = b
        else:
            probe = dims[_fact_adjacent(planner, tbl)]
            if probe.payload[c][2] == "gid":
                p.key_decoders.append(("vocab", probe.vocabs[c],
                                       _value_type(ft)))
            else:
                p.key_decoders.append(("codec", KeyCodec(ft)))
                if c in probe.pay_bounds:
                    p.key_bounds[c] = probe.pay_bounds[c]

    scaled_cache: Dict[str, object] = {}

    def scaledres(c):
        if c not in scaled_cache:
            scaled_cache[c] = None
            if planner.owner.get(c) == fact \
                    and planner.kind_of(c) == "float":
                scaled_cache[c] = _scaled_col_info(
                    p, c, planner.prep_of(fact, c))
        return scaled_cache[c]

    _plan_slots(p, planner.slots, slot_irs, planner.rew_inputs, fields,
                bounds_of, scaledres, n_upper)
    p.rv_ix = _add(p, _rowvalid(table, blocks))
    return p, ("grouped" if planner.key_names else "scalar"), False


def _fact_adjacent(planner: _StarPlanner, tbl: str) -> str:
    """The fact-adjacent ancestor of a dimension (its probe carries the
    dimension's cascaded payloads)."""
    while planner.tree[tbl][0] != planner.fact:
        tbl = planner.tree[tbl][0]
    return tbl


def _empty_key_decoder(planner: _StarPlanner, p: _Plan, c: str):
    from liquid_tpu_torch.sql.device_agg import KeyCodec
    t = planner.tables[planner.owner[c]].field(c).type
    if planner.kind_of(c) == "dict":
        p.key_decoders.append(("vocab", [], _value_type(t)))
    else:
        p.key_decoders.append(("codec", KeyCodec(t)))


# -- public entry -------------------------------------------------------------

def _star_cache_key(executor, q, group, key_names, slots, rew_keys,
                    rew_inputs):
    """Textual identity of a star query and the session's cache epoch."""
    class _Scan:  # the star inputs in _plan_cache_key's shape
        pushdown = ()
        residual = ()
    base = _plan_cache_key(_Scan, {}, group, key_names, slots, rew_keys,
                           rew_inputs, q)
    frm = []
    f = q.from_
    while isinstance(f, ast.Join):
        frm.append((f.kind, render(f.on) if f.on is not None else None))
        frm.append(getattr(f.right, "name", None))
        f = f.left
    frm.append(getattr(f, "name", None))
    epoch, tabs = 0, []
    for name, t in sorted(executor.catalog.items()):
        epoch = max(epoch, t.cache.epoch)
        tabs.append((name, id(t)))
    return (base, tuple(frm),
            render(q.where) if q.where is not None else None,
            tuple(tabs), epoch)


def try_fused_star(executor, q, group, key_names, slots, rew_keys,
                   rew_inputs, where) -> pa.Table:
    """Run an aggregate over a star/snowflake join on the device -> the
    partial result (key columns + slot columns).  An unsupported shape,
    or a dimension that repeats a join key (an N:M join), raises
    NotImplementedError naming the reason: the classic join path is not
    ported yet."""
    cache = getattr(executor, "_star_plan_cache", None)
    if cache is None:
        cache = executor._star_plan_cache = {}
    ck = _star_cache_key(executor, q, group, key_names, slots, rew_keys,
                         rew_inputs)
    hit = cache.get(ck)
    if hit is None:
        planner = _StarPlanner(executor, q, key_names, slots, rew_keys,
                               rew_inputs, where)
        try:
            planner.detect()
            for s in slots:
                if s.kind not in _AGG_KINDS:
                    raise _Bail(f"aggregate kind {s.kind}")
            # the dimension tree, bottom-up
            dims = {child: _build_dim(planner, child)
                    for child in planner.tree
                    if planner.tree[child][0] == planner.fact}
            p, mode, empty = _plan_fact(planner, dims)
        except _Bail as e:
            hit = (str(e),)
        else:
            # one combined uniqueness fetch for every unverified dimension
            # (any depth: a snowflake's deep dimensions must be unique too)
            unverified = [pb for pb in planner.all_probes
                          if not pb.verified and pb.dup is not None]
            if unverified:
                flags = torch.stack([pb.dup for pb in unverified]).cpu()
                if bool(flags.any()):
                    raise NotImplementedError(
                        "N:M join: a dimension repeats a join key after its "
                        "filters; the classic join path is not ported yet")
                for pb in unverified:
                    pb.verified = True
            hit = (p, mode, empty, planner.tables[planner.fact])
        # a plan pins its dimensions' tensors: it is cached only while
        # every built one (an empty dimension has no dup flag) is charged
        # to the budget, and leaves the cache when one of them is evicted
        built = [pb for pb in planner.all_probes if pb.dup is not None]
        if len(hit) == 1 or all(pb.cached for pb in built):
            if len(cache) >= _PLAN_CACHE_CAP:
                cache.pop(next(iter(cache)))
            cache[ck] = hit
            for pb in built:  # keys of plans the cap evicted go too
                pb.plans = {k: c for k, c in pb.plans.items() if k in c}
                pb.plans[ck] = cache
    if len(hit) == 1:  # a (cached) bailout
        raise NotImplementedError(
            f"fused star path cannot run this query ({hit[0]}); the classic "
            f"join path is not ported yet")
    p, mode, empty, fact_table = hit
    STATS["star_queries"] += 1
    topk = None
    if mode == "grouped" and not empty:
        topk = plan_topk(q, slots, p)
        p.having = plan_having(q, slots, p)
    result = execute_plan(p, mode, empty, slots, fact_table, topk)
    if result is None:
        raise NotImplementedError(
            "the grouped hash ladder did not converge for this key "
            "cardinality; the classic path is not ported yet")
    return result
