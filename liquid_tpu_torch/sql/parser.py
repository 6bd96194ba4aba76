"""SQL tokenizer + Pratt parser for the liquid-tpu dialect.

Hand-written (no external SQL dependency): covers the reference's
benchmark surface -- ClickBench q0-q42, TPC-H, and the core TPC-DS
shapes.  Produces `liquid_tpu_torch.sql.ast` nodes.

Host copy of `liquid_tpu/sql/parser.py`: the port imports nothing of the
reference package.
"""
from __future__ import annotations

import datetime
import re
from typing import List, Optional

from liquid_tpu_torch.sql import ast

_TOKEN_RE = re.compile(r"""
    (?P<ws>\s+)
  | (?P<comment>--[^\n]*)
  | (?P<num>\d+\.\d*(?:[eE][+-]?\d+)?|\.\d+(?:[eE][+-]?\d+)?|\d+(?:[eE][+-]?\d+)?)
  | (?P<qid>"(?:[^"]|"")*")
  | (?P<str>'(?:[^']|'')*')
  | (?P<op>::|<=|>=|<>|!=|\|\||->>|->|[(),.*+\-/%<>=;\[\]])
  | (?P<id>[A-Za-z_][A-Za-z0-9_]*)
""", re.VERBOSE)

KEYWORDS = {
    "select", "from", "where", "group", "by", "having", "order", "limit",
    "offset", "as", "and", "or", "not", "like", "ilike", "in", "between",
    "is", "null", "true", "false", "distinct", "case", "when", "then",
    "else", "end", "cast", "extract", "interval", "date", "timestamp",
    "join", "inner", "left", "right", "full", "outer", "cross", "on",
    "union", "intersect", "except", "all", "exists", "asc", "desc",
    "nulls", "first", "last",
    "substring", "for", "with",
}


class Token:
    __slots__ = ("kind", "value")

    def __init__(self, kind, value):
        self.kind = kind    # num | str | id | kw | op
        self.value = value

    def __repr__(self):
        return f"{self.kind}:{self.value}"


def _unescape(s: str) -> str:
    """Backslash escapes inside string literals (sqlparser-rs semantics:
    \\\\ -> \\, \\n, \\t, \\r; unknown sequences keep the backslash)."""
    if "\\" not in s:
        return s
    out = []
    i = 0
    while i < len(s):
        c = s[i]
        if c == "\\" and i + 1 < len(s):
            n = s[i + 1]
            if n == "\\":
                out.append("\\"); i += 2; continue
            if n == "n":
                out.append("\n"); i += 2; continue
            if n == "t":
                out.append("\t"); i += 2; continue
            if n == "r":
                out.append("\r"); i += 2; continue
            if n == "'":
                out.append("'"); i += 2; continue
        out.append(c)
        i += 1
    return "".join(out)


def tokenize(sql: str) -> List[Token]:
    out: List[Token] = []
    pos = 0
    while pos < len(sql):
        m = _TOKEN_RE.match(sql, pos)
        if not m:
            raise SyntaxError(f"cannot tokenize at {sql[pos:pos+30]!r}")
        pos = m.end()
        kind = m.lastgroup
        text = m.group()
        if kind in ("ws", "comment"):
            continue
        if kind == "num":
            if "." in text or "e" in text.lower():
                out.append(Token("num", float(text)))
            else:
                out.append(Token("num", int(text)))
        elif kind == "qid":
            out.append(Token("id", text[1:-1].replace('""', '"')))
        elif kind == "str":
            out.append(Token("str", _unescape(text[1:-1].replace("''", "'"))))
        elif kind == "id":
            low = text.lower()
            if low in KEYWORDS:
                out.append(Token("kw", low))
            else:
                out.append(Token("id", text))
        else:
            out.append(Token("op", text))
    return out


class Parser:
    def __init__(self, sql: str):
        self.toks = tokenize(sql)
        self.i = 0

    # -- token helpers -----------------------------------------------------

    def peek(self, k: int = 0) -> Optional[Token]:
        j = self.i + k
        return self.toks[j] if j < len(self.toks) else None

    def next(self) -> Token:
        t = self.peek()
        if t is None:
            raise SyntaxError("unexpected end of input")
        self.i += 1
        return t

    def accept_kw(self, *kws) -> Optional[str]:
        t = self.peek()
        if t and t.kind == "kw" and t.value in kws:
            self.i += 1
            return t.value
        return None

    def expect_kw(self, kw: str) -> None:
        if not self.accept_kw(kw):
            raise SyntaxError(f"expected {kw.upper()}, got {self.peek()}")

    def accept_op(self, *ops) -> Optional[str]:
        t = self.peek()
        if t and t.kind == "op" and t.value in ops:
            self.i += 1
            return t.value
        return None

    def expect_op(self, op: str) -> None:
        if not self.accept_op(op):
            raise SyntaxError(f"expected {op!r}, got {self.peek()}")

    # -- entry -------------------------------------------------------------

    def parse(self) -> ast.Select:
        ctes = []
        if self.accept_kw("with"):
            # WITH name [(cols)] AS ( select ) [, ...]  (TPC-DS q95/q97...)
            while True:
                name = self.next().value
                cols = None
                if self.accept_op("("):
                    cols = [self.next().value]
                    while self.accept_op(","):
                        cols.append(self.next().value)
                    self.expect_op(")")
                self.expect_kw("as")
                self.expect_op("(")
                sub = self._maybe_setop_chain(self.parse_select())
                self.expect_op(")")
                if cols:
                    items = (sub.members[0].items
                             if isinstance(sub, ast.SetOp) else sub.items)
                    for item, cname in zip(items, cols):
                        item.alias = cname
                ctes.append((name, sub))
                if not self.accept_op(","):
                    break
        q = self.parse_select()
        q.ctes = ctes
        res = self._maybe_setop_chain(q)
        self.accept_op(";")
        if self.peek() is not None:
            raise SyntaxError(f"trailing tokens at {self.peek()}")
        return res

    def _maybe_setop_chain(self, q: ast.Select):
        """Wrap `q` in a SetOp if a UNION/INTERSECT/EXCEPT chain follows.
        Trailing ORDER BY / LIMIT / OFFSET bind to the whole chain: the
        last member's clauses are hoisted."""
        t = self.peek()
        if not (t and t.kind == "kw"
                and t.value in ("union", "intersect", "except")):
            return q
        members = [q]
        all_flags = []
        ops = []
        while True:
            op = self.accept_kw("union", "intersect", "except")
            if op is None:
                break
            ops.append(op)
            all_flags.append(bool(self.accept_kw("all")))
            members.append(self.parse_select())
        last = members[-1]
        u = ast.SetOp(members, all_flags, last.order_by, last.limit,
                      last.offset, ops)
        last.order_by, last.limit, last.offset = [], None, None
        return u

    def parse_select(self) -> ast.Select:
        self.expect_kw("select")
        q = ast.Select()
        q.distinct = bool(self.accept_kw("distinct"))
        q.items.append(self.parse_select_item())
        while self.accept_op(","):
            t = self.peek()
            if t and t.kind == "kw" and t.value == "from":
                break  # tolerate trailing comma (DataFusion does)
            q.items.append(self.parse_select_item())
        if self.accept_kw("from"):
            q.from_ = self.parse_from()
        if self.accept_kw("where"):
            q.where = self.parse_expr()
        if self.accept_kw("group"):
            self.expect_kw("by")
            q.group_by.append(self.parse_group_item())
            while self.accept_op(","):
                q.group_by.append(self.parse_group_item())
        if self.accept_kw("having"):
            q.having = self.parse_expr()
        if self.accept_kw("order"):
            self.expect_kw("by")
            q.order_by.append(self.parse_order_item())
            while self.accept_op(","):
                q.order_by.append(self.parse_order_item())
        if self.accept_kw("limit"):
            q.limit = int(self.next().value)
        if self.accept_kw("offset"):
            q.offset = int(self.next().value)
        return q

    def parse_select_item(self) -> ast.SelectItem:
        t = self.peek()
        if t and t.kind == "op" and t.value == "*":
            self.i += 1
            return ast.SelectItem(ast.Star())
        e = self.parse_expr()
        alias = None
        if self.accept_kw("as"):
            alias = self.next().value
        elif self.peek() and self.peek().kind == "id":
            alias = self.next().value
        return ast.SelectItem(e, alias)

    def parse_group_item(self) -> ast.Expr:
        """A GROUP BY element: expr, ROLLUP(...), CUBE(...), or
        GROUPING SETS((...), ...)."""
        t = self.peek()
        if t and t.kind == "id" and t.value.lower() in ("rollup", "cube"):
            nxt = self.peek(1)
            if nxt and nxt.kind == "op" and nxt.value == "(":
                kind = self.next().value.lower()
                self.expect_op("(")
                exprs = [self.parse_expr()]
                while self.accept_op(","):
                    exprs.append(self.parse_expr())
                self.expect_op(")")
                return ast.GroupingSpec(kind, tuple(exprs))
        if t and t.kind == "id" and t.value.lower() == "grouping":
            nxt = self.peek(1)
            if nxt and nxt.kind == "id" and nxt.value.lower() == "sets":
                self.i += 2
                self.expect_op("(")
                sets = []
                while True:
                    if self.accept_op("("):
                        one = []
                        if not self.accept_op(")"):
                            one.append(self.parse_expr())
                            while self.accept_op(","):
                                one.append(self.parse_expr())
                            self.expect_op(")")
                        sets.append(tuple(one))
                    else:
                        sets.append((self.parse_expr(),))
                    if not self.accept_op(","):
                        break
                self.expect_op(")")
                return ast.GroupingSpec("sets", (), tuple(sets))
        return self.parse_expr()

    def parse_order_item(self) -> ast.OrderItem:
        e = self.parse_expr()
        desc = False
        if self.accept_kw("desc"):
            desc = True
        else:
            self.accept_kw("asc")
        nulls_first = None
        if self.accept_kw("nulls"):
            nulls_first = bool(self.accept_kw("first"))
            if nulls_first is False:
                self.expect_kw("last")
        return ast.OrderItem(e, desc, nulls_first)

    # -- FROM / joins ------------------------------------------------------

    def parse_from(self):
        rel = self.parse_table_factor()
        while True:
            if self.accept_op(","):
                right = self.parse_table_factor()
                rel = ast.Join(rel, right, "cross", None)
                continue
            kind = None
            if self.accept_kw("cross"):
                self.expect_kw("join")
                rel = ast.Join(rel, self.parse_table_factor(), "cross", None)
                continue
            if self.accept_kw("inner"):
                kind = "inner"
                self.expect_kw("join")
            elif self.accept_kw("left"):
                self.accept_kw("outer")
                kind = "left"
                self.expect_kw("join")
            elif self.accept_kw("right"):
                self.accept_kw("outer")
                kind = "right"
                self.expect_kw("join")
            elif self.accept_kw("full"):
                self.accept_kw("outer")
                kind = "full"
                self.expect_kw("join")
            elif self.accept_kw("join"):
                kind = "inner"
            else:
                return rel
            right = self.parse_table_factor()
            on = None
            if self.accept_kw("on"):
                on = self.parse_expr()
            rel = ast.Join(rel, right, kind, on)

    def parse_table_factor(self):
        if self.accept_op("("):
            t = self.peek()
            if t and t.kind == "kw" and t.value == "select":
                sub = self._maybe_setop_chain(self.parse_select())
                self.expect_op(")")
                self.accept_kw("as")
                alias = self.next().value
                if self.accept_op("("):
                    cols = [self.next().value]
                    while self.accept_op(","):
                        cols.append(self.next().value)
                    self.expect_op(")")
                    items = (sub.members[0].items
                             if isinstance(sub, ast.SetOp) else sub.items)
                    for item, cname in zip(items, cols):
                        item.alias = cname
                return ast.SubqueryRel(sub, alias)
            rel = self.parse_from()
            self.expect_op(")")
            return rel
        name = self.next().value
        alias = None
        if self.accept_kw("as"):
            alias = self.next().value
        else:
            t = self.peek()
            if t and t.kind == "id":
                alias = self.next().value
        return ast.TableRef(name, alias)

    # -- expressions (Pratt) ----------------------------------------------

    def parse_expr(self) -> ast.Expr:
        return self.parse_or()

    def parse_or(self) -> ast.Expr:
        left = self.parse_and()
        while self.accept_kw("or"):
            left = ast.Binary("or", left, self.parse_and())
        return left

    def parse_and(self) -> ast.Expr:
        left = self.parse_not()
        while self.accept_kw("and"):
            left = ast.Binary("and", left, self.parse_not())
        return left

    def parse_not(self) -> ast.Expr:
        if self.accept_kw("not"):
            return ast.Unary("not", self.parse_not())
        return self.parse_comparison()

    def parse_comparison(self) -> ast.Expr:
        left = self.parse_additive()
        # IS [NOT] NULL
        if self.accept_kw("is"):
            negated = bool(self.accept_kw("not"))
            self.expect_kw("null")
            return ast.IsNull(left, negated)
        negated = False
        if self.peek() and self.peek().kind == "kw" and self.peek().value == "not":
            nxt = self.peek(1)
            if nxt and nxt.kind == "kw" and nxt.value in ("like", "ilike", "in", "between"):
                self.i += 1
                negated = True
        if self.accept_kw("like"):
            e = ast.Binary("like", left, self.parse_additive())
            return ast.Unary("not", e) if negated else e
        if self.accept_kw("ilike"):
            e = ast.Binary("ilike", left, self.parse_additive())
            return ast.Unary("not", e) if negated else e
        if self.accept_kw("in"):
            self.expect_op("(")
            t = self.peek()
            if t and t.kind == "kw" and t.value == "select":
                sub = self.parse_select()
                self.expect_op(")")
                return ast.InSubquery(left, sub, negated)
            items = [self.parse_expr()]
            while self.accept_op(","):
                items.append(self.parse_expr())
            self.expect_op(")")
            return ast.InList(left, tuple(items), negated)
        if self.accept_kw("between"):
            lo = self.parse_additive()
            self.expect_kw("and")
            hi = self.parse_additive()
            return ast.Between(left, lo, hi, negated)
        op = self.accept_op("=", "<>", "!=", "<", "<=", ">", ">=")
        if op:
            if op == "!=":
                op = "<>"
            return ast.Binary(op, left, self.parse_additive())
        return left

    def parse_additive(self) -> ast.Expr:
        left = self.parse_multiplicative()
        while True:
            op = self.accept_op("+", "-", "||")
            if not op:
                return left
            left = ast.Binary(op, left, self.parse_multiplicative())

    def parse_multiplicative(self) -> ast.Expr:
        left = self.parse_unary()
        while True:
            op = self.accept_op("*", "/", "%")
            if not op:
                return left
            left = ast.Binary(op, left, self.parse_unary())

    def parse_unary(self) -> ast.Expr:
        if self.accept_op("-"):
            return ast.Unary("neg", self.parse_unary())
        self.accept_op("+")
        return self.parse_postfix()

    def parse_postfix(self) -> ast.Expr:
        e = self.parse_primary()
        while self.accept_op("::"):
            t = self.next()
            e = ast.Cast(e, str(t.value).lower())
            if self.accept_op("("):
                while not self.accept_op(")"):
                    self.i += 1
        return e

    def parse_primary(self) -> ast.Expr:
        t = self.peek()
        if t is None:
            raise SyntaxError("unexpected end of expression")
        if t.kind == "num":
            self.i += 1
            return ast.Literal(t.value)
        if t.kind == "str":
            self.i += 1
            return ast.Literal(t.value)
        if t.kind == "op" and t.value == "(":
            self.i += 1
            inner = self.peek()
            if inner and inner.kind == "kw" and inner.value == "select":
                sub = self.parse_select()
                self.expect_op(")")
                return ast.Subquery(sub)
            e = self.parse_expr()
            self.expect_op(")")
            return e
        if t.kind == "kw":
            kw = t.value
            if kw in ("true", "false"):
                self.i += 1
                return ast.Literal(kw == "true")
            if kw == "null":
                self.i += 1
                return ast.Literal(None)
            if kw == "date":
                # DATE 'yyyy-mm-dd'
                nxt = self.peek(1)
                if nxt and nxt.kind == "str":
                    self.i += 2
                    return ast.Literal(datetime.date.fromisoformat(nxt.value))
            if kw == "timestamp":
                nxt = self.peek(1)
                if nxt and nxt.kind == "str":
                    self.i += 2
                    return ast.Literal(
                        datetime.datetime.fromisoformat(nxt.value))
            if kw == "interval":
                self.i += 1
                t2 = self.next()
                if t2.kind == "str":
                    # INTERVAL '90' DAY  or  INTERVAL '3 month'
                    parts = t2.value.split()
                    if len(parts) == 2:
                        return ast.Interval(int(parts[0]), parts[1].rstrip("s").lower())
                    val = int(parts[0])
                    unit_t = self.next()
                    return ast.Interval(val, str(unit_t.value).rstrip("s").lower())
                val = int(t2.value)
                unit_t = self.next()
                return ast.Interval(val, str(unit_t.value).rstrip("s").lower())
            if kw == "case":
                return self.parse_case()
            if kw == "cast":
                self.i += 1
                self.expect_op("(")
                e = self.parse_expr()
                self.expect_kw("as")
                type_name = self.next().value
                # swallow optional precision like DECIMAL(12,2)
                if self.accept_op("("):
                    while not self.accept_op(")"):
                        self.i += 1
                self.expect_op(")")
                return ast.Cast(e, str(type_name).lower())
            if kw == "extract":
                self.i += 1
                self.expect_op("(")
                field = self.next().value
                self.expect_kw("from")
                e = self.parse_expr()
                self.expect_op(")")
                return ast.Extract(str(field).lower(), e)
            if kw == "substring":
                self.i += 1
                self.expect_op("(")
                e = self.parse_expr()
                if self.accept_kw("from"):
                    start = self.parse_expr()
                    length = None
                    if self.accept_kw("for"):
                        length = self.parse_expr()
                else:
                    self.expect_op(",")
                    start = self.parse_expr()
                    length = None
                    if self.accept_op(","):
                        length = self.parse_expr()
                self.expect_op(")")
                args = (e, start) + ((length,) if length is not None else ())
                return ast.Func("substring", args)
            if kw == "exists":
                self.i += 1
                self.expect_op("(")
                sub = self.parse_select()
                self.expect_op(")")
                return ast.Exists(sub)
            if kw in ("left", "right"):  # also scalar functions left(s, n)
                nxt = self.peek(1)
                if nxt and nxt.kind == "op" and nxt.value == "(":
                    self.i += 1
                    return self.parse_call(kw)
            raise SyntaxError(f"unexpected keyword {kw!r} in expression")
        # identifier: column, qualified column, or function call
        self.i += 1
        name = t.value
        nxt = self.peek()
        if nxt and nxt.kind == "op" and nxt.value == "(":
            return self.parse_call(name)
        if nxt and nxt.kind == "op" and nxt.value == ".":
            self.i += 1
            t2 = self.next()
            if t2.kind == "op" and t2.value == "*":
                return ast.Star(table=name)
            return ast.Column(t2.value, table=name)
        return ast.Column(name)

    def _accept_id(self, *names) -> Optional[str]:
        t = self.peek()
        if t and t.kind == "id" and t.value.lower() in names:
            self.i += 1
            return t.value.lower()
        return None

    def parse_call(self, name: str) -> ast.Expr:
        self.expect_op("(")
        distinct = bool(self.accept_kw("distinct"))
        t = self.peek()
        if t and t.kind == "op" and t.value == "*":
            self.i += 1
            self.expect_op(")")
            return self._maybe_over(ast.Func(name.lower(), (), star=True))
        if t and t.kind == "op" and t.value == ")":
            self.i += 1
            return self._maybe_over(ast.Func(name.lower(), ()))
        args = [self.parse_expr()]
        # SQL-standard SUBSTRING(x FROM start [FOR length])
        if self.accept_kw("from"):
            args.append(self.parse_expr())
            t = self.peek()
            if t and t.kind == "id" and t.value.lower() == "for":
                self.i += 1
                args.append(self.parse_expr())
            elif t and t.kind == "kw" and t.value == "for":
                self.i += 1
                args.append(self.parse_expr())
        while self.accept_op(","):
            args.append(self.parse_expr())
        self.expect_op(")")
        return self._maybe_over(
            ast.Func(name.lower(), tuple(args), distinct=distinct))

    def _maybe_over(self, func: ast.Func) -> ast.Expr:
        """`OVER (PARTITION BY ... ORDER BY ... [ROWS|RANGE frame])`."""
        if not self._accept_id("over"):
            return func
        self.expect_op("(")
        partition: List[ast.Expr] = []
        if self._accept_id("partition"):
            self.expect_kw("by")
            partition.append(self.parse_expr())
            while self.accept_op(","):
                partition.append(self.parse_expr())
        oexprs: List[ast.Expr] = []
        odesc: List[bool] = []
        onf: List[Optional[bool]] = []
        if self.accept_kw("order"):
            self.expect_kw("by")
            while True:
                o = self.parse_order_item()
                oexprs.append(o.expr)
                odesc.append(o.desc)
                onf.append(o.nulls_first)
                if not self.accept_op(","):
                    break
        frame = None
        unit = self._accept_id("rows", "range")
        if unit:
            if self.accept_kw("between"):
                start = self._parse_frame_bound()
                self.expect_kw("and")
                end = self._parse_frame_bound()
            else:
                start = self._parse_frame_bound()
                end = "current_row"
            frame = (unit, start, end)
        self.expect_op(")")
        return ast.WindowFunc(func, tuple(partition), tuple(oexprs),
                              tuple(odesc), tuple(onf), frame)

    def _parse_frame_bound(self) -> str:
        if self._accept_id("unbounded"):
            which = self._accept_id("preceding", "following")
            if not which:
                raise SyntaxError("expected PRECEDING/FOLLOWING")
            return f"unbounded_{which}"
        if self._accept_id("current"):
            if not self._accept_id("row"):
                raise SyntaxError("expected ROW")
            return "current_row"
        t = self.next()
        if t.kind != "num" or not isinstance(t.value, int):
            raise SyntaxError(f"expected frame offset, got {t}")
        which = self._accept_id("preceding", "following")
        if not which:
            raise SyntaxError("expected PRECEDING/FOLLOWING")
        return f"{t.value}_{which}"

    def parse_case(self) -> ast.Expr:
        self.expect_kw("case")
        operand = None
        if not (self.peek() and self.peek().kind == "kw"
                and self.peek().value == "when"):
            operand = self.parse_expr()
        whens = []
        while self.accept_kw("when"):
            cond = self.parse_expr()
            self.expect_kw("then")
            val = self.parse_expr()
            whens.append((cond, val))
        else_ = None
        if self.accept_kw("else"):
            else_ = self.parse_expr()
        self.expect_kw("end")
        return ast.Case(tuple(whens), else_, operand)


def parse_sql(sql: str) -> ast.Select:
    return Parser(sql).parse()


def parse_statement(sql: str):
    """-> ("select", Select) | ("create_view", name, cols, Select)
       | ("drop_view", name).  (TPC-H q15 uses views.)"""
    toks = sql.strip().split(None, 2)
    head = toks[0].lower() if toks else ""
    if head == "create":
        m = re.match(r"(?is)^\s*create\s+view\s+(\w+)\s*(\(([^)]*)\))?\s*as\s+(.*)$",
                     sql.strip())
        if not m:
            raise SyntaxError("unsupported CREATE statement")
        name = m.group(1)
        cols = [c.strip() for c in m.group(3).split(",")] if m.group(3) else None
        sub = parse_sql(m.group(4))
        if cols:
            items = (sub.members[0].items if isinstance(sub, ast.SetOp)
                     else sub.items)
            for item, cname in zip(items, cols):
                item.alias = cname
        return ("create_view", name, sub)
    if head == "drop":
        m = re.match(r"(?is)^\s*drop\s+view\s+(?:if\s+exists\s+)?(\w+)\s*$", sql.strip())
        if not m:
            raise SyntaxError("unsupported DROP statement")
        return ("drop_view", m.group(1))
    return ("select", parse_sql(sql))
