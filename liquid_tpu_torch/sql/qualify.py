"""Name qualification / scope resolution pass.

Resolves every column reference in a query tree to a unique flat name so
that downstream planning works on plain `Column(name)` nodes:

- Aliased base tables (``lineitem l1``) get a ``l1__`` column prefix so
  self-joins produce distinct names (the reference relies on DataFusion's
  qualified-name resolution; our physical layer is name-flat).
- Qualified references ``l1.l_suppkey`` -> ``Column("l1__l_suppkey")``;
  qualifiers of non-prefixed relations are stripped.
- Unqualified references that belong to exactly one prefixed relation
  get that prefix.
- Subqueries are resolved with the enclosing scopes visible (nearest
  first), which is what later lets the executor classify inner vs outer
  (correlated) references.

Ref: the reference delegates all of this to DataFusion's logical planner
(e.g. `datafusion-local/src/lib.rs:57-197` builds a stock
SessionContext); we implement the subset its benchmark suites exercise.

Host copy of `liquid_tpu/sql/qualify.py`: the port imports nothing of the
reference package.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

from liquid_tpu_torch.sql import ast


class Scope:
    """One FROM-clause scope: qualifier -> (prefix, columns)."""

    def __init__(self):
        self.by_qualifier: Dict[str, Tuple[Optional[str], List[str]]] = {}
        self.unqual: Dict[str, Optional[str]] = {}  # bare col -> prefix|None
        self.ambiguous: set = set()

    def add(self, qualifier: str, prefix: Optional[str], cols: List[str]):
        self.by_qualifier[qualifier] = (prefix, cols)
        for c in cols:
            if c in self.unqual or c in self.ambiguous:
                self.ambiguous.add(c)
                self.unqual.pop(c, None)
            else:
                self.unqual[c] = prefix

    def resolve_qualified(self, table: str, name: str) -> Optional[str]:
        ent = self.by_qualifier.get(table)
        if ent is None:
            return None
        prefix, cols = ent
        if name not in cols:
            return None  # qualifier matches but column doesn't: outer? error later
        return (prefix + name) if prefix else name

    def resolve_unqualified(self, name: str) -> Optional[str]:
        if name in self.ambiguous:
            return name  # ambiguous ref: leave as written (error later)
        if name not in self.unqual:
            return None
        p = self.unqual[name]
        return (p + name) if p else name


def map_expr(e: ast.Expr, fn: Callable) -> ast.Expr:
    """Rebuild `e` bottom-up, applying `fn` at every node (fn returns a
    replacement or None to recurse normally)."""
    out = fn(e)
    if out is not None:
        return out
    if not dataclasses.is_dataclass(e):
        return e
    changes = {}
    for f in dataclasses.fields(e):
        v = getattr(e, f.name)
        if isinstance(v, ast.Expr):
            changes[f.name] = map_expr(v, fn)
        elif isinstance(v, tuple):
            nv = tuple(
                map_expr(x, fn) if isinstance(x, ast.Expr)
                else tuple(map_expr(y, fn) if isinstance(y, ast.Expr) else y
                           for y in x) if isinstance(x, tuple)
                else x
                for x in v)
            changes[f.name] = nv
        elif isinstance(v, list):
            changes[f.name] = [map_expr(x, fn) if isinstance(x, ast.Expr) else x
                               for x in v]
    return dataclasses.replace(e, **changes) if changes else e


def _leaves(rel, out):
    if isinstance(rel, ast.Join):
        _leaves(rel.left, out)
        _leaves(rel.right, out)
    elif rel is not None:
        out.append(rel)


class Qualifier:
    def __init__(self, rel_columns: Callable):
        """rel_columns(name) -> list of base column names for a catalog
        table or view, or None if unknown."""
        self.rel_columns = rel_columns

    def _output_columns(self, q) -> List[str]:
        """Static output-column names of an already-qualified query,
        expanding `select *` through its FROM leaves (the executor does
        the same expansion at runtime, `exec._project`)."""
        if isinstance(q, ast.SetOp):
            q = q.members[0]
        cols: List[str] = []
        for it in q.items:
            if isinstance(it.expr, ast.Star):
                leaves: List = []
                _leaves(q.from_, leaves)
                for leaf in leaves:
                    pfx = leaf.prefix or ""
                    if isinstance(leaf, ast.TableRef):
                        cols.extend(pfx + c
                                    for c in self.rel_columns(leaf.name) or [])
                    elif isinstance(leaf, ast.SubqueryRel):
                        cols.extend(pfx + c
                                    for c in self._output_columns(leaf.query))
            else:
                cols.append(it.alias or _render_name(it.expr))
        return cols

    def qualify(self, q,
                outer: Tuple[Scope, ...] = ()):
        if isinstance(q, ast.SetOp):
            # each member resolves in its own scope; the chain itself
            # introduces no names beyond the first member's items
            q.members = [self.qualify(m, outer) for m in q.members]
            return q
        scope = Scope()
        leaves: List = []
        _leaves(q.from_, leaves)
        # columns owned by more than one relation force a prefix even on
        # unaliased tables (e.g. two CTEs exposing the same column names,
        # TPC-DS q97's full outer join) AND on derived tables (two
        # subquery aliases exposing the same names, TPC-DS q44)
        new_leaf: Dict[int, object] = {}
        resolved: List[Tuple[object, Optional[object], List[str]]] = []
        col_owners: Dict[str, int] = {}
        for leaf in leaves:
            if isinstance(leaf, ast.TableRef):
                cols = list(self.rel_columns(leaf.name) or [])
                resolved.append((leaf, None, cols))
            elif isinstance(leaf, ast.SubqueryRel):
                # derived tables cannot correlate outward: fresh scope
                sub = self.qualify(leaf.query)
                cols = self._output_columns(sub)
                resolved.append((leaf, sub, cols))
            else:
                raise NotImplementedError(type(leaf).__name__)
            for c in cols:
                col_owners[c] = col_owners.get(c, 0) + 1
        for leaf, sub, cols in resolved:
            collide = any(col_owners.get(c, 0) > 1 for c in cols)
            if isinstance(leaf, ast.TableRef):
                prefix = None
                if leaf.alias and leaf.alias != leaf.name:
                    prefix = leaf.alias + "__"
                elif collide:
                    prefix = (leaf.alias or leaf.name) + "__"
                scope.add(leaf.alias or leaf.name, prefix, cols)
                new_leaf[id(leaf)] = dataclasses.replace(leaf, prefix=prefix)
            else:
                prefix = (leaf.alias + "__") if collide else None
                scope.add(leaf.alias, prefix, cols)
                new_leaf[id(leaf)] = ast.SubqueryRel(sub, leaf.alias, prefix)

        scopes = (scope,) + outer

        def fix(e):
            if isinstance(e, ast.Column):
                if e.table is not None:
                    for s in scopes:
                        r = s.resolve_qualified(e.table, e.name)
                        if r is not None:
                            return ast.Column(r)
                    return ast.Column(e.name)  # unknown qualifier: best effort
                for s in scopes:
                    r = s.resolve_unqualified(e.name)
                    if r is not None:
                        return ast.Column(r)
                return e  # select-item alias or genuinely unknown
            if isinstance(e, ast.Subquery):
                return ast.Subquery(self.qualify(e.query, scopes))
            if isinstance(e, ast.Exists):
                return ast.Exists(self.qualify(e.query, scopes), e.negated)
            if isinstance(e, ast.InSubquery):
                return ast.InSubquery(map_expr(e.operand, fix),
                                      self.qualify(e.query, scopes), e.negated)
            return None

        def fix_rel(rel):
            if isinstance(rel, ast.Join):
                return ast.Join(fix_rel(rel.left), fix_rel(rel.right),
                                rel.kind,
                                map_expr(rel.on, fix) if rel.on is not None
                                else None)
            return new_leaf.get(id(rel), rel)

        out = ast.Select()
        out.items = [ast.SelectItem(map_expr(it.expr, fix), it.alias)
                     for it in q.items]
        # SQL names the result column of an unaliased qualified ref by
        # the BARE column name (`t.c` -> "c"); qualification rewrote the
        # expr to the prefixed name, so restore the visible name via an
        # alias -- unless that would collide with another item's name.
        # DELIBERATE DEVIATION: `select a.id, b.id` yields "id" and
        # "b__id" (DataFusion emits two columns both named "id"; the
        # name-flat projection pipeline cannot hold duplicates, and an
        # invented suffix would be no more standard than the prefix)
        names = [it.alias or (it.expr.name if isinstance(it.expr, ast.Column)
                              else _render_name(it.expr))
                 for it in out.items]
        for i, (it, orig) in enumerate(zip(out.items, q.items)):
            if (it.alias is None and isinstance(orig.expr, ast.Column)
                    and orig.expr.table is not None
                    and isinstance(it.expr, ast.Column)
                    and it.expr.name != orig.expr.name
                    and orig.expr.name not in names):
                it.alias = orig.expr.name
                names[i] = orig.expr.name
        out.from_ = fix_rel(q.from_) if q.from_ is not None else None
        out.where = map_expr(q.where, fix) if q.where is not None else None
        out.group_by = [map_expr(g, fix) for g in q.group_by]
        out.having = map_expr(q.having, fix) if q.having is not None else None
        out.order_by = [ast.OrderItem(map_expr(o.expr, fix), o.desc,
                                      o.nulls_first) for o in q.order_by]
        out.limit, out.offset, out.distinct = q.limit, q.offset, q.distinct
        return out


def _render_name(e: ast.Expr) -> str:
    from liquid_tpu_torch.sql.physical import render
    return render(e)
