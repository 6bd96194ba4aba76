"""Fused device star/snowflake join + aggregation (port of
`liquid_tpu/sql/fused_star.py`).

A fact table joined to a tree of N:1 dimensions on integer or date keys
runs on the device without a host Arrow round trip:

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
build counts duplicates on the device; with a repeated key the query
goes to the classic join path, which keeps the row multiplicity), NULL
keys never match, and only INNER (and cross) joins are planned.  Every
shape not planned here returns None and the classic path takes it.

count(DISTINCT col) over a star runs as the host fold
(`fused_agg.distinct_two_level`) over one star aggregate grouped by the
keys and the DISTINCT columns.  `_MiniPlanner` gives the fused bare
SELECT (`fused_agg.try_fused_select`) and the existence builds this
module's planner surface over one table.

Also planned here:
- aliased relations and self-joins (`_AliasedTable`: TPC-H q7 / q8's
  nation n1 / n2, q21's lineitem l1), reading their base table's cached
  blocks, preps and row-valid stacks;
- composite two-column keys (the sorted chain index: q9's partsupp on
  (ps_partkey, ps_suppkey)), at most `MAX_COMPOSITE_DUP` rows per first
  key;
- existence probes (`build_exist_probe`): a correlated EXISTS / NOT
  EXISTS / [NOT] IN conjunct reduces its inner relation to a per-key
  count (and min / max of one disambiguator column, q21) over the key's
  dense domain, probed from the fact's rows (q21), or from the one table
  of a single-table aggregate (q4, q22; `exec._plan_exist_probes`).
"""
from __future__ import annotations

import weakref
from typing import Dict, List, Optional, Tuple

import numpy as np
import pyarrow as pa
import torch

from liquid_tpu_torch.arrays.base import BLOCK_ROWS
from liquid_tpu_torch.ops import mask as mops
from liquid_tpu_torch.ops.hashagg import TRASH, _dropped
from liquid_tpu_torch.sql import ast
from liquid_tpu_torch.sql.fused_agg import (
    _AGG_KINDS, _PAYLOAD_GEN, STATS, _add, _as_f64, _Bail, _bool_nonnull,
    _build_vocab, _gen_of, PlanCache,
    _compile_bool, _compile_expr, _Decoders, _expr_key_type, _gid_stack,
    _ir_dtype, _kind_or, _like_regex, _Plan, _plan_cache_key, _plan_slots, _rowvalid,
    _scaled_col_info, _schema_kind, _select_blocks, _selection_packed,
    _const, _table_prep, _value_type, add_exist_probes, bind_consts, bind_ir,
    execute_plan, payload_bounds, place_consts, plan_having, plan_topk,
    pred_alt, probe_dims, register_col,
)
from liquid_tpu_torch.sql.physical import collect_columns, render
from liquid_tpu_torch.sql.planner import (
    and_all, plan_scan_filters, split_conjuncts, subqueries)
from liquid_tpu_torch.utils.tracing import TRACER, to_host

#: index tables larger than this are refused (2^27 int32 entries, 512 MB)
MAX_DIM_SPAN = 1 << 27

#: a composite-key probe tries this many dimension rows per first key;
#: a deeper chain belongs on the classic join path
MAX_COMPOSITE_DUP = 8

#: star plans kept per executor, least recently used out first.  The
#: builds a plan pins are charged to the cache budget; the rest of its
#: arrays (the fact's row validity and column preps, gid stacks, small
#: uploads of bounds) are not, so plans of a past epoch are dropped on
#: the next miss and this count bounds the current ones.  It lies above
#: the star shapes of the largest suite the repo runs: TPC-DS's 99
#: queries look up 144 keys in a warm pass at SF 0.005, 73 of them
#: bailouts
_PLAN_CACHE_CAP = 256

# -- dimension build ----------------------------------------------------------

def _dim_build(p: _Plan, key_name: str, tblsize: int, pays, lo_ix: int,
               key2=None) -> List[torch.Tensor]:
    """One dimension's device build: filter -> residuals -> child-probe
    semijoins -> the unique-key direct-address index and the payload
    decode.  -> [idx int32[tblsize], dup bool, then vals and nulls per
    payload (pname, ptype)].  With `key2` = (column, lo array index), a
    composite key: the sorted chain index [idx, dup, ord, cnt, vals2,
    maxdup, vals and nulls...] (`fused_agg.probe_dims`), dup a repeated
    (key, key2) pair."""
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
    n = rel.shape[0]
    dev = rel.device
    pos = torch.arange(n, dtype=torch.int32, device=dev)
    if key2 is not None:
        k2 = env.decode(key2[0], "i64")
        valid = valid & ~env.nulls(key2[0])
        # (key, key2) in one i64: the planner proved key2 - lo2 < 2^31
        skey = torch.where(valid, (rel << 31) | (k2 - arrays[key2[1]]),
                           torch.full_like(rel, 1 << 62))
        ordv = torch.argsort(skey, stable=True)
        ss, vsort = skey[ordv], valid[ordv]
        dup = ((ss[1:] == ss[:-1]) & vsort[1:]).any()
        k1s = ss >> 31
        first = vsort.clone()
        first[1:] &= k1s[1:] != k1s[:-1]
        # each first key's first sorted position; the other rows land in
        # the trash band past the table
        idx = torch.full((tblsize + TRASH,), -1, dtype=torch.int32,
                         device=dev).scatter_(
            0, _dropped(k1s, first, tblsize), pos)[:tblsize]
        cnt = torch.zeros(tblsize + TRASH, dtype=torch.int32,
                          device=dev).index_add_(
            0, _dropped(k1s, vsort, tblsize), torch.ones_like(pos))[:tblsize]
        vals2 = torch.where(vsort, k2[ordv], torch.full_like(k2, -(1 << 62)))
        outs = [idx, dup, ordv.to(torch.int32), cnt, vals2, cnt.max()]
    else:
        # torch has no dropping scatter: filtered rows land in a spare
        # entry past the table, sliced off after
        slot = torch.where(valid, rel, torch.full_like(rel, tblsize))
        idx = torch.full((tblsize + 1,), -1, dtype=torch.int32,
                         device=dev).scatter_(0, slot, pos)[:tblsize]
        # exact in any order; a repeated key makes the scatter above pick
        # one row, and the flag stops the query
        cnt = torch.zeros(tblsize + 1, dtype=torch.int32, device=dev)
        cnt.index_add_(0, slot, torch.ones_like(pos))
        outs = [idx, (cnt[:tblsize] > 1).any()]
    for pname, ptype in pays:
        outs.append(env.decode(pname, "f64" if ptype == "f64" else "i64"))
        outs.append(env.nulls(pname))
    return outs


# -- planning -----------------------------------------------------------------

class _Build:
    """A device build held by a table's cache and charged to the cache's
    budget as a derived reservation (`LiquidCache.reserve_derived`): the
    cache evicts it, least recently used first, before any column, and
    the cached plans that pin its tensors are dropped with it."""

    __slots__ = ("nbytes", "cached", "plans", "home")

    def __init__(self):
        self.nbytes = 0
        self.cached = False      # held by a table's cache, charged
        self.plans = {}          # plan key -> weakref to its plan cache
        self.home = None         # (column cache, build cache, key), cached

    def admit(self, lc, cache: dict, key) -> None:
        """Cache the build in its table's `cache` under `key` when column
        cache `lc` can charge its bytes; otherwise it is served uncached
        and uncharged, so no plan may keep it."""
        if lc.reserve_derived(self, self.nbytes, self._evicted):
            cache[key] = self
            self.cached = True
            self.home = (lc, cache, key)
        else:
            self.nbytes = 0

    def touch(self) -> None:
        """Mark the build most recently used."""
        if self.home is not None:
            self.home[0].touch_derived(self)

    def release(self) -> None:
        """Release the build's charge (its table's caches are cleared)
        and drop the cached plans that pin it."""
        if self.home is not None:
            self.home[0].release_derived(self)
        self._drop()

    def _evicted(self) -> None:
        STATS["star_build_evictions"] += 1
        self.home[1].pop(self.home[2], None)
        self._drop()

    def _drop(self) -> None:
        """Drop the cached plans whose arrays pin the build's tensors, so
        the budget bounds what stays alive."""
        for ck, ref in self.plans.items():
            plans = ref()
            if plans is not None and plans.pop(ck, None) is not None:
                STATS["star_plans_dropped"] += 1
        self.plans.clear()
        self.cached = False
        self.home = None

    def pin(self, ck, cache) -> None:
        """Record that cached plan `ck` of `cache` pins this build (keys
        of plans the cache has dropped go)."""
        self.plans = {k: r for k, r in self.plans.items()
                      if (c := r()) is not None and k in c}
        self.plans[ck] = weakref.ref(cache)


def _drop_stale(cache: PlanCache, ck) -> None:
    """Drop the star plans made under another catalog or cache epoch than
    key `ck` names: no later lookup makes their keys, and their arrays
    hold device tensors the budget does not charge."""
    for k in [k for k in cache if k[-2:] != ck[-2:]]:
        del cache[k]


class _Probe(_Build):
    """Runtime handle of one built dimension (device tensors)."""

    __slots__ = ("idx", "lo", "hi", "dup", "verified", "payload", "vocabs",
                 "pay_bounds", "cache_key", "nrows", "chain")

    def __init__(self):
        super().__init__()
        self.dup = None          # device bool scalar until verified
        self.verified = False
        self.payload = {}        # name -> (vals, nulls, ptype)
        self.vocabs = {}         # name -> vocabulary (gid payloads)
        self.pay_bounds = {}     # name -> (lo, hi) value bounds
        self.nrows = 1           # dimension scan rows: j in [0, nrows)
        self.chain = None        # composite key: (ord, cnt, vals2, maxdup)


class _Fields:
    """table.field(col) across every relation (for _plan_slots)."""

    def __init__(self, tables):
        self._tables = list(tables)

    def field(self, c: str) -> pa.Field:
        for t in self._tables:
            if c in t.column_names:
                return t.field(c)
        raise KeyError(c)


def _next_pow2(n: int) -> int:
    m = 1
    while m < n:
        m <<= 1
    return m


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
                leaves.append(rel)
            else:
                raise _Bail("derived-table relation")

        walk(self.q.from_)
        if len(leaves) < 2:
            raise _Bail("single relation")
        self.tables = {}
        for leaf in leaves:
            # an aliased relation (a self-join's side) is its own relation
            key = (leaf.alias or leaf.name) if leaf.prefix else leaf.name
            if key in self.tables:
                raise _Bail(f"duplicate relation {key}")
            base = self.ex.catalog[leaf.name]
            self.tables[key] = (_aliased_table(self.ex, base, leaf.prefix)
                                if leaf.prefix else base)
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
        #: correlated subquery conjuncts: existence probes on the fact
        self.sub_conjs: List[ast.Expr] = []
        for e in split_conjuncts(self.where) + ons:
            if subqueries(e):
                self.sub_conjs.append(e)
                continue
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
        # the second column of a composite key (q9's partsupp on
        # (ps_partkey, ps_suppkey)): the child builds a sorted chain index.
        # Other leftovers (cycles) stay fact-level residuals over gathered
        # payloads
        self.tree2: Dict[str, Tuple[str, str]] = {}
        for i, (a, b, ta, tb) in enumerate(edges):
            if i in used:
                continue
            child = None
            if ta in self.tree and self.tree[ta][0] == tb:
                child, pcol2, ccol2 = ta, b, a
            elif tb in self.tree and self.tree[tb][0] == ta:
                child, pcol2, ccol2 = tb, a, b
            if child is not None and child not in self.tree2:
                self.tree2[child] = (pcol2, ccol2)
                continue
            self.cross.append(ast.Binary("=", ast.Column(a), ast.Column(b)))

        # join keys must decode to i64 planes
        pairs = [(ch, pcol, ccol) for ch, (_p, pcol, ccol)
                 in self.tree.items()]
        pairs += [(ch, pcol, ccol) for ch, (pcol, ccol)
                  in self.tree2.items()]
        for child, pcol, ccol in pairs:
            for tbl, col in ((child, ccol), (self.owner[pcol], pcol)):
                t = self.tables[tbl].field(col).type
                if not (pa.types.is_integer(t) or pa.types.is_date32(t)
                        or pa.types.is_timestamp(t)):
                    raise _Bail(f"join key type {t}")

        # subquery conjuncts -> existence probes on the fact (q21: two
        # correlated lineitem lookups); one no probe takes stops the plan
        self.eprobe_specs: List[dict] = []
        fact_table = self.tables[self.fact]
        for e in self.sub_conjs:
            spec = self.ex._exist_spec(e, fact_table)
            if spec is None:
                raise _Bail(f"a correlated subquery {render(e)[:60]!r} that "
                            f"no existence probe takes (a correlated lookup)")
            probe = build_exist_probe(
                spec["table"], spec["key"], spec["local"], spec["mm_inner"],
                require_nonnull_key=spec["mode"] == "anti_nn")
            if probe is None:
                raise _Bail(f"an existence probe on {spec['key']} that does "
                            f"not build")
            self.eprobe_specs.append(
                {"mode": spec["mode"], "col": spec["col"],
                 "mmcol": spec["mmcol"], "probe": probe, "key": repr(e)})

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
            plan = plan_scan_filters(and_all(self.per_table[tbl]))
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
            return _kind_or(self.p.kind_of, c, default)

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
            return _kind_or(self.p.kind_of, c, default)

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


# -- aliased relations ----------------------------------------------------------

class _AliasedTable:
    """A parquet table under an alias prefix (self-joins; TPC-H nation n1 /
    n2, lineitem l1): its column names carry the prefix, everything else
    is the base table's with the prefix stripped.  Blocks, preps and
    row-valid stacks are the base's (`fused_agg._table_prep` and
    `_rowvalid` read through `base`), and so is the dimension-build
    cache.  One object per (table, prefix) lives on the executor."""

    def __init__(self, base, prefix: str):
        self.base = base
        self.prefix = prefix
        self.column_names = [prefix + c for c in base.column_names]

    def base_name(self, c: str) -> str:
        return c[len(self.prefix):] if c.startswith(self.prefix) else c

    def field(self, c: str) -> pa.Field:
        return self.base.field(self.base_name(c))

    def prune_row_groups(self, preds):
        return self.base.prune_row_groups(
            [(self.base_name(c), pr) for c, pr in preds])

    def batch_may_match(self, rg, c, b, pred) -> bool:
        return self.base.batch_may_match(rg, self.base_name(c), b, pred)

    def num_batches(self, rg):
        return self.base.num_batches(rg)

    def batch_length(self, rg, b):
        return self.base.batch_length(rg, b)

    def ensure_cached(self, rg, c, hint=None):
        return self.base.ensure_cached(rg, self.base_name(c), hint)

    @property
    def zone_prunes(self):
        return self.base.zone_prunes

    @zone_prunes.setter
    def zone_prunes(self, v):
        self.base.zone_prunes = v

    @property
    def _star_probe_cache(self):
        return self.base.__dict__.setdefault("_star_probe_cache", {})

    @property
    def num_rows(self):
        return self.base.num_rows

    @property
    def num_row_groups(self):
        return self.base.num_row_groups

    @property
    def cache(self):
        return self.base.cache


def _aliased_table(ex, base, prefix: str) -> _AliasedTable:
    cache = ex.__dict__.setdefault("_alias_tables", {})
    t = cache.get((id(base), prefix))
    if t is None or t.base is not base:
        t = cache[(id(base), prefix)] = _AliasedTable(base, prefix)
    return t


# -- existence probes -----------------------------------------------------------
#
# A correlated EXISTS with one equality correlation is a semijoin: the
# inner relation reduces to a per-key count (and the min / max of one
# disambiguator column, q21's `l2.l_suppkey <> l1.l_suppkey`) over the
# key's dense domain, built on the device once and probed from the outer
# rows with gathers (`fused_agg.exist_probes`).  Existence does not care
# about duplicates, so fact-to-fact correlations (orders to lineitem) fuse.

class _ExistProbe(_Build):
    """One inner relation's existence table: cnt int32[span + 1] over keys
    lo .. lo + span, and min / max int64[span + 1] of the disambiguator
    (None without one).  `gen` is unique per build (plan-cache keys)."""

    __slots__ = ("cnt", "lo", "span", "minv", "maxv", "gen")

    def __init__(self, cnt, lo: int, span: int, minv=None, maxv=None):
        super().__init__()
        self.cnt, self.lo, self.span = cnt, lo, span
        self.minv, self.maxv = minv, maxv
        self.gen = _PAYLOAD_GEN()


def _exist_build(p: _Plan, key_name: str, span: int, mm_name, lo_ix: int
                 ) -> List[torch.Tensor]:
    """selection -> key decode -> per-key count (and min / max of
    `mm_name`) over the dense key domain -> [cnt(, minv, maxv)].  Rows
    that do not count (filtered, a NULL key, a NULL disambiguator: it
    never witnesses `<>`) land in the trash band past the domain."""
    arrays = p.arrays
    sel = _selection_packed(p.colmap, p.pred_groups, arrays,
                            arrays[p.rv_ix])
    selb = mops.unpack_bits(sel).reshape(-1)
    env = _Decoders(p.colmap, arrays, selb.shape[0], selb.device)
    for ir in p.resids:
        selb = selb & _bool_nonnull(ir, env)
    rel = env.decode(key_name, "i64") - arrays[lo_ix]
    valid = selb & ~env.nulls(key_name) & (rel >= 0) & (rel <= span)
    if mm_name:
        valid = valid & ~env.nulls(mm_name)
    m = span + 1
    slot = _dropped(rel, valid, m)
    dev = rel.device
    cnt = torch.zeros(m + TRASH, dtype=torch.int32, device=dev).index_add_(
        0, slot, torch.ones(slot.shape[0], dtype=torch.int32, device=dev))
    outs = [cnt[:m]]
    if mm_name:
        v = env.decode(mm_name, "i64")
        big = (1 << 63) - 1
        for fill, op in ((big, "amin"), (-big - 1, "amax")):
            outs.append(torch.full((m + TRASH,), fill, dtype=torch.int64,
                                   device=dev).scatter_reduce_(
                0, slot, v, op, include_self=True)[:m])
    return outs


def build_exist_probe(table, key_col: str, local_where, mm_col=None,
                      require_nonnull_key: bool = False):
    """The existence table of `EXISTS (SELECT .. FROM table WHERE key_col
    = <outer> AND local_where)` -> _ExistProbe, or None when the shape
    does not build (an unbounded or non-integer key, a predicate with no
    device form, a non-resident block; NOT IN over a key with a NULL,
    which makes the predicate never true: the reference does not probe
    it either).  Cached on the table per (key, disambiguator, predicates,
    blocks, payload identity) and charged to the budget."""
    plan_scan = plan_scan_filters(local_where)
    try:
        blocks = _select_blocks(table, plan_scan)
        if not blocks:  # nothing exists
            probe = _ExistProbe(torch.zeros(1, dtype=torch.int32,
                                            device=table.cache.device), 0, 0)
            probe.cached = True  # holds nothing worth a charge
            return probe
        mp = _MiniPlanner(table, blocks)
        kpr = mp.prep_of(None, key_col)
        kb = payload_bounds(kpr)
        if kb is None:
            return None
        if require_nonnull_key and _prep_has_nulls(table, kpr, blocks):
            return None
        lo, hi = kb
        span = int(hi - lo)
        if span + 2 > MAX_DIM_SPAN:
            return None
        if mm_col is not None and mp.kind_of(mm_col) != "planes":
            return None  # a non-integer disambiguator
        ck = (key_col, mm_col,
              tuple(repr(g.source) for g in plan_scan.pushdown),
              tuple(repr(e) for e in plan_scan.residual), blocks,
              tuple(_gen_of(pp) for pp in kpr.payloads))
        cache = table.__dict__.setdefault("_exist_probe_cache", {})
        hit = cache.get(ck)
        if hit is not None:
            hit.touch()
            return hit
        p = _Plan()
        registered: set = set()
        kinds_view = _MiniPlanner._KV(mp)
        resid_cols: set = set()

        def resid(e):
            ir, cols = _compile_bool(e, kinds_view, mp.dictres)
            p.resids.append(ir)
            resid_cols.update(cols)

        for g in plan_scan.pushdown:
            if any(mp.prep_of(None, c).kind == "linear"
                   for c, _pr in g.alternatives):
                resid(g.source)  # no packed interval over linear codes
                continue
            alts = []
            for c, pred in g.alternatives:
                _register_col(p, mp, None, c, registered)
                alts.append(pred_alt(p, c, pred, mp.prep_of(None, c)))
            p.pred_groups.append(tuple(alts))
        for e in plan_scan.residual:
            resid(e)
        for c in sorted(resid_cols | {key_col} | (
                {mm_col} if mm_col is not None else set())):
            _register_col(p, mp, None, c, registered,
                          c in resid_cols and mp.kind_of(c) == "dict")
        p.rv_ix = _add(p, _rowvalid(table, blocks))
        lo_ix = _const(p, lo, "i64")
    except _Bail:
        return None
    with TRACER.span("fused.dim_build"):
        p.resids = [bind_ir(p, ir) for ir in p.resids]
        place_consts(p, table.cache.device)
        outs = _exist_build(p, key_col, span, mm_col, lo_ix)
        probe = _ExistProbe(outs[0], int(lo), span, *outs[1:])
        probe.nbytes = sum(a.numel() * a.element_size() for a in outs)
        probe.admit(table.cache, cache, ck)
    return probe


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


def _add_probe(p: _Plan, planner: _StarPlanner, pid: int, child: str,
               pb: _Probe, reg) -> None:
    """Probe `pid` of a child dimension in a parent's plan, in the
    composite form for a chain index, with the child's payload columns;
    reg(column) registers a parent column the probe reads."""
    pcol = planner.tree[child][1]
    reg(pcol)
    entry = (pid, pcol, _add(p, pb.idx), _const(p, pb.lo, "i64"))
    if pb.chain is not None:
        pcol2 = planner.tree2[child][0]
        reg(pcol2)
        ordv, cnt, vals2, maxdup = pb.chain
        entry += (pcol2, _add(p, ordv), _add(p, cnt), _add(p, vals2),
                  maxdup)
    p.probes.append(entry)
    _add_payloads(p, pid, pb)


def _build_dim(planner: _StarPlanner, tbl: str) -> _Probe:
    """Build (or reuse) one dimension's probe, children first."""
    table = planner.tables[tbl]
    dev = table.cache.device
    plan_scan, blocks = planner._scan(tbl)
    key_col = planner.tree[tbl][2]
    key2_col = planner.tree2.get(tbl, (None, None))[1]
    if key2_col is not None and blocks:
        # direct addressing on the wider key: the chain unrolls at most
        # MAX_COMPOSITE_DUP rows per first key, so the narrow key rides
        # second (partsupp: 200k part keys x 4 suppliers, not 10k x 80)
        b1 = payload_bounds(planner.prep_of(tbl, key_col))
        b2 = payload_bounds(planner.prep_of(tbl, key2_col))
        if b1 is None or b2 is None:
            raise _Bail("composite key bounds unknown")
        if b2[1] - b2[0] > b1[1] - b1[0]:
            par, pcol1, _c = planner.tree[tbl]
            pcol2, _c2 = planner.tree2[tbl]
            planner.tree[tbl] = (par, pcol2, key2_col)
            planner.tree2[tbl] = (pcol1, key_col)
            key_col, key2_col, b2 = key2_col, key_col, b1
        if b2[1] - b2[0] + 1 >= (1 << 31):
            raise _Bail("composite second key domain too wide")

    child_probes: List[Tuple[str, _Probe]] = [
        (ch, _build_dim(planner, ch)) for ch in planner.children[tbl]]

    # payloads: own exports and the children's cascaded ones.  The own
    # join key always exports: probe-index grouping recovers the key as
    # vals[j] at pack time
    own = set(planner.needed_by[tbl]) | {key_col} | (
        {key2_col} if key2_col is not None else set())
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
    if key2_col is not None:
        _register_col(p, planner, tbl, key2_col, registered)

    vocabs: Dict[str, list] = {}
    pay_bounds: Dict[str, tuple] = {}
    for pid, (ch, pb) in enumerate(child_probes):
        _add_probe(p, planner, pid, ch, pb,
                   lambda c: _register_col(p, planner, tbl, c, registered))
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

    # predicates and residuals whole (`repr`: a display name shows an IN
    # list or a CASE by its kind only), the blocks and the key payloads'
    # identity pin a cached build
    cache_key = (tbl, key_col, tblsize, tuple(pays),
                 tuple(repr(g.source) for g in plan_scan.pushdown),
                 tuple(repr(e) for e in plan_scan.residual), blocks,
                 tuple(_gen_of(pp) for pp in kpr.payloads),
                 tuple(pb.cache_key for _ch, pb in child_probes), key2_col)
    cache = getattr(table, "_star_probe_cache", None)
    if cache is None:
        cache = table._star_probe_cache = {}
    hit = cache.get(cache_key)
    if hit is not None:
        hit.touch()
        planner.all_probes.append(hit)
        planner.probe_by_dim[tbl] = hit
        return hit

    with TRACER.span("fused.dim_build"):
        klo_ix = _const(p, lo, "i64")
        key2 = None
        if key2_col is not None:
            key2 = (key2_col, _const(p, b2[0], "i64"))
        p.resids = [bind_ir(p, ir) for ir in p.resids]
        place_consts(p, dev)
        outs = _dim_build(p, key_col, tblsize, pays, klo_ix, key2)
        probe = _Probe()
        probe.idx, probe.dup = outs[0], outs[1]
        probe.lo, probe.hi = int(lo), int(hi)
        probe.nrows = len(blocks) * BLOCK_ROWS
        probe.vocabs = vocabs
        probe.pay_bounds = pay_bounds
        probe.cache_key = cache_key
        k = 2
        if key2 is not None:
            maxdup = int(to_host(outs[5]))
            if maxdup > MAX_COMPOSITE_DUP:
                raise _Bail(f"composite chain depth {maxdup} on {tbl} (more "
                            f"than {MAX_COMPOSITE_DUP} rows per {key_col})")
            probe.chain = (outs[2], outs[3], outs[4], maxdup)
            k = 6
        for name, ptype in pays:
            probe.payload[name] = (outs[k], outs[k + 1], ptype)
            k += 2
        probe.nbytes = sum(a.numel() * a.element_size() for a in outs)
        probe.admit(table.cache, cache, cache_key)
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
        if pb.chain is not None:
            continue  # one key of a composite pair determines no row
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
        lo_ix = _const(p, pb.lo, "i64")
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
        _add_probe(p, planner, pid, child, dims[child], reg)

    # the remaining fact columns the program reads
    needed: set = set(resid_cols) | key_expr_cols
    for sp in planner.eprobe_specs:
        for c in (sp["col"], sp["mmcol"]):
            if c is None:
                continue
            if planner.owner.get(c) != fact or planner.kind_of(c) != "planes":
                raise _Bail(f"existence-probe column {c}")
            needed.add(c)
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
    add_exist_probes(p, planner.eprobe_specs)
    bind_consts(p, dev)
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
        frm.append((f.kind, repr(f.on)))
        frm.append((getattr(f.right, "name", None),
                    getattr(f.right, "prefix", None)))
        f = f.left
    frm.append((getattr(f, "name", None), getattr(f, "prefix", None)))
    epoch, tabs = 0, []
    for name, t in sorted(executor.catalog.items()):
        epoch = max(epoch, t.cache.epoch)
        tabs.append((name, id(t)))
    return (base, tuple(frm), repr(q.where), tuple(tabs), epoch)


def _plan_star(executor, q, key_names, slots, rew_keys, rew_inputs, where):
    """Plan a star query: detect the tree, build its dimensions, plan the
    fact, and fetch every unverified dimension's duplicate flag at once ->
    (the cache entry, the planner): (p, mode, empty, fact table), or
    (reason,) for a shape the route does not take, or None where a
    dimension repeats a join key."""
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
        return (str(e),), planner
    # one combined uniqueness fetch for every unverified dimension (any
    # depth: a snowflake's deep dimensions must be unique too)
    unverified = [pb for pb in planner.all_probes
                  if not pb.verified and pb.dup is not None]
    if unverified:
        flags = to_host(torch.stack([pb.dup for pb in unverified]))
        if bool(flags.any()):
            return None, planner
        for pb in unverified:
            pb.verified = True
    return (p, mode, empty, planner.tables[planner.fact]), planner


def try_fused_star(executor, q, group, key_names, slots, rew_keys,
                   rew_inputs, where) -> Optional[pa.Table]:
    """Run an aggregate over a star/snowflake join on the device -> the
    partial result (key columns + slot columns).  None for an unsupported
    shape (`STATS["star_bailouts"]`, the reason in
    `STATS["star_last_bail"]`) and for a dimension that repeats a join key
    (an N:M join, `STATS["star_dup_bails"]`): the classic join path takes
    the query."""
    cache = getattr(executor, "_star_plan_cache", None)
    if cache is None:
        cache = executor._star_plan_cache = PlanCache()
    with TRACER.span("fused.lookup"):
        ck = _star_cache_key(executor, q, group, key_names, slots, rew_keys,
                             rew_inputs)
        ent = cache.get(ck)
        if ent is not None:
            # most recently used last, its builds with it: a hot plan
            # skips their lookups, which would otherwise leave them cold
            cache.move_to_end(ck)
            STATS["star_plan_hits"] += 1
            hit, built = ent
            for pb in built:
                pb.touch()
        else:
            _drop_stale(cache, ck)
            with TRACER.span("fused.plan"):
                hit, planner = _plan_star(executor, q, key_names, slots,
                                          rew_keys, rew_inputs, where)
            if hit is None:
                # N:M: the classic join keeps the exact multiplicity
                STATS["star_dup_bails"] += 1
                STATS["star_bailouts"] += 1
                return None
            # a plan pins its dimensions' tensors: it is cached only while
            # every built one (an empty dimension has no dup flag) is
            # charged to the budget, and leaves the cache when one of them
            # is evicted
            built = [pb for pb in planner.all_probes if pb.dup is not None]
            built += [sp["probe"]
                      for sp in getattr(planner, "eprobe_specs", ())]
            if len(hit) == 1 or all(pb.cached for pb in built):
                if len(cache) >= _PLAN_CACHE_CAP:
                    cache.popitem(last=False)
                # a cached bailout holds no build's tensors
                cache[ck] = (hit, tuple(built) if len(hit) > 1 else ())
                for pb in built:
                    pb.pin(ck, cache)
    if len(hit) == 1:  # a (cached) bailout
        STATS["star_bailouts"] += 1
        STATS["star_last_bail"] = hit[0]
        return None
    p, mode, empty, fact_table = hit
    STATS["star_queries"] += 1
    topk = None
    if mode == "grouped" and not empty:
        topk = plan_topk(q, slots, p)
        p.having = plan_having(q, slots, p)
    result = execute_plan(p, mode, empty, slots, fact_table, topk)
    if result is None:
        STATS["star_bailouts"] += 1
    return result
