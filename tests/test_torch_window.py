"""Window functions: the port's `sql/window.py` (numpy and pyarrow) against
the reference's `liquid_tpu/sql/window.py` (pandas), both on the CPU.

1. `compute_window` of each package on the same `pa.Table`, for every
   function of `WINDOW_FUNCS` and every frame kind of `_frame_kind`
   (defaults, ROWS and RANGE with unbounded, current and offset bounds),
   with NULL partition keys, order keys and values, ties, int64 values a
   float would merge, strings, dates, DESC with NULLS FIRST / LAST and an
   empty input.  Every case is held to a row-by-row SQL oracle written
   here; the cases where the reference is right are held to it too
   (`REF_WRONG` names the others and why).
2. The SQL shapes of `tests/test_window.py` through both sessions (the
   port's with `device="cpu"`), under the tie rule of
   `test_torch_route_fence.assert_same_answer`.

Floats compare to rtol 1e-9, everything else exactly."""
import pytest

torch = pytest.importorskip("torch")

import datetime  # noqa: E402

import numpy as np  # noqa: E402
import pyarrow as pa  # noqa: E402
import pyarrow.parquet as pq  # noqa: E402

from liquid_tpu.sql import window as jwin  # noqa: E402
from liquid_tpu.sql.parser import parse_sql as jparse  # noqa: E402
from liquid_tpu.sql.session import LiquidCacheLocalBuilder as JBuilder  # noqa: E402
from liquid_tpu_torch.bench.oracle import _close_row  # noqa: E402
from liquid_tpu_torch.sql import exec as texec  # noqa: E402
from liquid_tpu_torch.sql import window as twin  # noqa: E402
from liquid_tpu_torch.sql.parser import parse_sql as tparse  # noqa: E402
from liquid_tpu_torch.sql.session import LiquidCacheLocalBuilder  # noqa: E402
from tests.test_torch_route_fence import assert_same_answer  # noqa: E402


def _table(n: int = 300) -> pa.Table:
    rng = np.random.default_rng(5)

    def nulls(rate):
        return rng.random(n) < rate
    o = rng.integers(0, 20, n)
    # int64 values a float64 key would merge (2^62 and 2^62 + 1), and the
    # extremes
    o[:8] = [2**62, 2**62 + 1, 2**63 - 1, -2**63, 2**62, 2**62 + 1, 0, 0]
    x = rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64)
    x[:4] = [2**63 - 1, -2**63, 2**62 + 1, 2**62]
    words = np.array(["", "ant", "bee", "cat", "dog", "eel", "b", "ca"])
    return pa.table({
        "p": pa.array(rng.integers(0, 5, n), mask=nulls(0.1)),
        "ps": pa.array(np.array(["x", "y", "z"])[rng.integers(0, 3, n)],
                       mask=nulls(0.1)),
        "o": pa.array(o, mask=nulls(0.1)),
        "os": pa.array(words[rng.integers(0, 8, n)], mask=nulls(0.1)),
        "oo": pa.array(rng.integers(0, 40, n)),
        "od": pa.array([datetime.date(2001, 1, 1)
                        + datetime.timedelta(days=int(d))
                        for d in rng.integers(0, 60, n)]),
        "v": pa.array(rng.integers(-50, 50, n), mask=nulls(0.15)),
        "f": pa.array(np.round(rng.normal(0, 100, n), 3), mask=nulls(0.15)),
        "s": pa.array(words[rng.integers(0, 8, n)], mask=nulls(0.15)),
        "x": pa.array(x),
    })


P_O = "PARTITION BY p ORDER BY o"
P_OO = "PARTITION BY p ORDER BY oo"

#: (id, window expression) -- every function and frame kind
CASES = [
    ("row_number", f"row_number() OVER ({P_O})"),
    ("row_number_bare", "row_number() OVER ()"),
    ("rank_desc", "rank() OVER (PARTITION BY ps ORDER BY o DESC)"),
    ("rank_desc_nulls_last", "rank() OVER (ORDER BY o DESC NULLS LAST, os)"),
    ("dense_rank_nulls_first",
     "dense_rank() OVER (PARTITION BY p, ps ORDER BY os NULLS FIRST)"),
    ("dense_rank_int64", "dense_rank() OVER (ORDER BY o)"),
    ("ntile4", f"ntile(4) OVER ({P_O})"),
    ("ntile3_extremes", "ntile(3) OVER (ORDER BY x)"),
    ("lag", f"lag(v) OVER ({P_O})"),
    ("lead2_string", "lead(s, 2) OVER (PARTITION BY ps ORDER BY oo DESC)"),
    ("lag_default", f"lag(v, 1, -1) OVER ({P_OO})"),
    ("lag_extremes", "lag(x, 3) OVER (ORDER BY oo)"),
    ("first_value", f"first_value(f) OVER ({P_O})"),
    ("first_value_rows", f"first_value(s) OVER ({P_O} ROWS BETWEEN 2 "
                         "PRECEDING AND CURRENT ROW)"),
    ("last_value_default", f"last_value(v) OVER ({P_O})"),
    ("last_value_whole", f"last_value(s) OVER ({P_O} ROWS BETWEEN "
                         "UNBOUNDED PRECEDING AND UNBOUNDED FOLLOWING)"),
    ("last_value_rows", f"last_value(v) OVER ({P_OO} ROWS BETWEEN CURRENT "
                        "ROW AND 2 FOLLOWING)"),
    ("last_value_range", f"last_value(f) OVER ({P_OO} RANGE BETWEEN 2 "
                         "PRECEDING AND 3 FOLLOWING)"),
    ("sum_partition", "sum(v) OVER (PARTITION BY p)"),
    ("count_partition", "count(v) OVER (PARTITION BY ps)"),
    ("count_star_partition", "count(*) OVER (PARTITION BY p)"),
    ("avg_partition", "avg(f) OVER (PARTITION BY p)"),
    ("min_string_partition", "min(s) OVER (PARTITION BY p)"),
    ("max_string_partition", "max(s) OVER (PARTITION BY ps)"),
    ("max_extremes_partition", "max(x) OVER (PARTITION BY p)"),
    ("sum_default_range", f"sum(v) OVER ({P_O})"),
    ("sum_rows_running", f"sum(f) OVER ({P_O} ROWS BETWEEN UNBOUNDED "
                         "PRECEDING AND CURRENT ROW)"),
    ("avg_rows_2_preceding", f"avg(v) OVER ({P_OO} ROWS BETWEEN 2 "
                             "PRECEDING AND CURRENT ROW)"),
    ("sum_rows_centered", f"sum(v) OVER ({P_OO} ROWS BETWEEN 1 PRECEDING "
                          "AND 1 FOLLOWING)"),
    ("count_rows_before", f"count(v) OVER ({P_OO} ROWS BETWEEN 3 "
                          "PRECEDING AND 1 PRECEDING)"),
    ("sum_rows_to_end", f"sum(v) OVER ({P_OO} ROWS BETWEEN CURRENT ROW "
                        "AND UNBOUNDED FOLLOWING)"),
    ("sum_rows_following_to_end", f"sum(v) OVER ({P_OO} ROWS BETWEEN 2 "
                                  "FOLLOWING AND UNBOUNDED FOLLOWING)"),
    ("sum_rows_start_to_preceding", f"sum(v) OVER ({P_OO} ROWS BETWEEN "
                                    "UNBOUNDED PRECEDING AND 2 PRECEDING)"),
    ("min_rows_running", f"min(v) OVER ({P_OO} ROWS BETWEEN UNBOUNDED "
                         "PRECEDING AND CURRENT ROW)"),
    ("max_string_rows_running", f"max(s) OVER ({P_OO} ROWS BETWEEN "
                                "UNBOUNDED PRECEDING AND CURRENT ROW)"),
    ("min_extremes_rows", f"min(x) OVER ({P_OO} ROWS BETWEEN 2 PRECEDING "
                          "AND 3 FOLLOWING)"),
    ("max_string_rows", f"max(s) OVER ({P_OO} ROWS BETWEEN 1 PRECEDING "
                        "AND 2 FOLLOWING)"),
    ("min_string_range", f"min(s) OVER ({P_OO} RANGE BETWEEN 3 PRECEDING "
                         "AND 3 FOLLOWING)"),
    ("sum_range_offsets", f"sum(v) OVER ({P_OO} RANGE BETWEEN 5 PRECEDING "
                          "AND 10 FOLLOWING)"),
    ("count_star_range", f"count(*) OVER ({P_OO} RANGE BETWEEN 5 PRECEDING "
                         "AND 10 FOLLOWING)"),
    ("min_range_desc", "min(oo) OVER (PARTITION BY p ORDER BY oo DESC "
                       "RANGE BETWEEN 3 PRECEDING AND 3 FOLLOWING)"),
    ("avg_range_running", f"avg(v) OVER ({P_OO} RANGE BETWEEN UNBOUNDED "
                          "PRECEDING AND CURRENT ROW)"),
    ("sum_range_to_end", f"sum(v) OVER ({P_OO} RANGE BETWEEN CURRENT ROW "
                         "AND UNBOUNDED FOLLOWING)"),
    ("max_range_start_to_following", "max(f) OVER (ORDER BY oo RANGE "
                                     "BETWEEN UNBOUNDED PRECEDING AND 2 "
                                     "FOLLOWING)"),
    ("sum_range_date_days", "sum(v) OVER (PARTITION BY p ORDER BY od RANGE "
                            "BETWEEN 7 PRECEDING AND CURRENT ROW)"),
]

#: cases where the reference is not SQL's answer, with why; they are held
#: to the row-by-row oracle only
REF_WRONG = {
    **dict.fromkeys(
        ("rank_desc", "rank_desc_nulls_last", "dense_rank_int64"),
        "an int64 key with NULLs reaches its pandas codes as float64, which "
        "ties 2^62 and 2^62 + 1"),
    "first_value_rows": "its first_value reads the partition's first row, "
                        "whatever the frame",
    "last_value_range": "its last_value over RANGE reads the peer group's "
                        "end, whatever the offsets",
    "sum_rows_following_to_end": "its k FOLLOWING..UNBOUNDED frame reads "
                                 "the next partition past the end",
    "sum_rows_start_to_preceding": "its UNBOUNDED..k PRECEDING frame reads "
                                   "the previous partition",
    "min_rows_running": "its running min is NULL on a NULL row",
    "max_string_rows_running": "its running max is NULL on a NULL row",
    "sum_range_to_end": "its RANGE CURRENT ROW..UNBOUNDED frame starts at "
                        "the row, not at its first peer",
    "max_range_start_to_following": "its RANGE UNBOUNDED..k FOLLOWING frame "
                                    "counts rows, not values",
    "sum_range_date_days": "it cannot put a date on a numeric axis",
}


def _names(wf, const=twin._const):
    """(argument, partition and order column names) as the executor
    passes them: constant arguments stay in the AST."""
    return ([a.name for a in wf.func.args if const(a) is None],
            [p.name for p in wf.partition_by],
            [o.name for o in wf.order_exprs])


def _wf(parse, expr: str):
    return parse(f"SELECT {expr} FROM t").items[0].expr


def _sorted_partition(cols, idx, wf):
    """The partition's rows in window order: a stable sort key by key,
    the last first (Python's sort keeps ties in input order, reversed or
    not)."""
    idx = list(idx)
    for o, desc, nf in reversed(list(zip(wf.order_exprs, wf.order_desc,
                                         wf.order_nulls_first))):
        first = desc if nf is None else nf
        vals = cols[o.name]
        null_flag = (2 if first else 0) if desc else (0 if first else 2)
        idx.sort(key=lambda i: (null_flag, 0) if vals[i] is None
                 else (1, vals[i]), reverse=desc)
    return idx


def _axis(v):
    return v.toordinal() if isinstance(v, datetime.date) else v


def _oracle(t: pa.Table, wf) -> list:
    """SQL's answer, row by row."""
    cols = {n: t.column(n).to_pylist() for n in t.column_names}
    n = t.num_rows
    name = wf.func.name
    consts = [twin._const(a) for a in wf.func.args]
    argn, partn, ordn = _names(wf)
    arg = cols[argn[0]] if argn else None
    parts: dict = {}
    for i in range(n):
        parts.setdefault(tuple(cols[p][i] for p in partn), []).append(i)
    unit, lo, hi = twin._frame_kind(wf)
    out = [None] * n
    for rows in parts.values():
        rows = _sorted_partition(cols, rows, wf)
        m = len(rows)
        okey = [tuple(cols[o][i] for o in ordn) for i in rows]
        for k, i in enumerate(rows):
            peer_lo = okey.index(okey[k])
            peer_hi = m - 1 - okey[::-1].index(okey[k])
            if name == "row_number":
                out[i] = k + 1
            elif name == "rank":
                out[i] = peer_lo + 1
            elif name == "dense_rank":
                out[i] = len(set(okey[:k + 1]))
            elif name == "ntile":
                b = consts[0]
                q, r = divmod(m, b)
                out[i] = (k // (q + 1) + 1 if k < r * (q + 1)
                          else r + (k - r * (q + 1)) // q + 1)
            elif name in ("lag", "lead"):
                off = consts[1] if len(consts) > 1 else 1
                src = k - off if name == "lag" else k + off
                out[i] = (cols[argn[0]][rows[src]] if 0 <= src < m
                          else (consts[2] if len(consts) > 2 else None))
            else:
                if unit == "rows":
                    a = 0 if lo == "unbounded" else k + lo
                    z = m - 1 if hi == "unbounded" else k + hi
                    frame = list(range(max(a, 0), min(z, m - 1) + 1))
                elif all(b in ("unbounded", 0) for b in (lo, hi)):
                    a = 0 if lo == "unbounded" else peer_lo
                    z = m - 1 if hi == "unbounded" else peer_hi
                    frame = list(range(a, z + 1))
                else:
                    sign = -1 if wf.order_desc[0] else 1
                    ax = [sign * _axis(cols[ordn[0]][j]) for j in rows]
                    frame = [j for j in range(m)
                             if (lo == "unbounded" or ax[j] >= ax[k] + lo)
                             and (hi == "unbounded" or ax[j] <= ax[k] + hi)]
                vals = [arg[rows[j]] for j in frame] if arg else []
                nn = [v for v in vals if v is not None]
                if name == "first_value":
                    out[i] = vals[0] if vals else None
                elif name == "last_value":
                    out[i] = vals[-1] if vals else None
                elif name == "count":
                    out[i] = len(frame) if arg is None else len(nn)
                elif name == "sum":
                    out[i] = sum(nn) if nn else None
                elif name == "avg":
                    out[i] = sum(nn) / len(nn) if nn else None
                elif name == "min":
                    out[i] = min(nn) if nn else None
                else:
                    out[i] = max(nn) if nn else None
    return out


def _same(got: list, want: list) -> bool:
    return len(got) == len(want) and all(
        _close_row((a,), (b,)) for a, b in zip(got, want))


@pytest.fixture(scope="module")
def table():
    return _table()


@pytest.mark.parametrize("case,expr", CASES, ids=[c[0] for c in CASES])
def test_compute_window(table, case, expr):
    wf = _wf(tparse, expr)
    got = twin.compute_window(table, wf, *_names(wf))
    want = _oracle(table, wf)
    assert _same(got.to_pylist(), want), case
    if case in REF_WRONG:
        return
    jwf = _wf(jparse, expr)
    ref = jwin.compute_window(table, jwf, *_names(jwf, jwin._const))
    assert got.type == ref.type, (got.type, ref.type)
    assert _same(got.to_pylist(), ref.to_pylist())


def test_the_reference_wrong_cases_differ(table):
    """Each REF_WRONG case does differ from the reference on this table
    (or the reference fails on it), so the list names no case the
    reference gets right."""
    for case, expr in CASES:
        if case not in REF_WRONG:
            continue
        wf = _wf(tparse, expr)
        got = twin.compute_window(table, wf, *_names(wf)).to_pylist()
        jwf = _wf(jparse, expr)
        try:
            ref = jwin.compute_window(
                table, jwf, *_names(jwf, jwin._const)).to_pylist()
        except Exception:
            continue
        assert not _same(got, ref), case


@pytest.mark.parametrize("case,expr", CASES[::4], ids=[c[0] for c in
                                                       CASES[::4]])
def test_compute_window_empty(table, case, expr):
    empty = table.slice(0, 0)
    wf = _wf(tparse, expr)
    got = twin.compute_window(empty, wf, *_names(wf))
    jwf = _wf(jparse, expr)
    ref = jwin.compute_window(empty, jwf, *_names(jwf, jwin._const))
    assert len(got) == 0 and got.type == ref.type


def test_dense_codes_keep_int64_and_nan_apart():
    """Codes are exact: 2^62 and 2^62 + 1 differ, a NULL is its own code
    and a float NaN is a value above every number, not a NULL."""
    c, isnull, k = twin._dense_codes(pa.array([2**62 + 1, None, 2**62,
                                               2**62 + 1]))
    assert c.tolist() == [1, 2, 0, 1] and isnull.tolist() == [
        False, True, False, False] and k == 2
    c, isnull, k = twin._dense_codes(pa.array([float("nan"), 1.0, None]))
    assert c.tolist() == [1, 0, 2] and not isnull[0] and k == 2


def test_lag_keeps_nan_a_value():
    """A NaN the window reads stays a NaN (the reference returns NULL)."""
    t = pa.table({"v": pa.array([1.0, float("nan"), 3.0]),
                  "o": pa.array([1, 2, 3])})
    wf = _wf(tparse, "lag(v) OVER (ORDER BY o)")
    got = twin.compute_window(t, wf, ["v"], [], ["o"]).to_pylist()
    assert got[0] is None and got[1] == 1.0 and got[2] != got[2]


# -- the SQL shapes of tests/test_window.py through both sessions -----------

def _sql_table() -> pa.Table:
    rng = np.random.RandomState(7)
    n = 5000
    v = rng.randint(-1000, 1000, n).astype("int64")
    f = np.round(rng.randn(n) * 100, 3)
    idx = np.arange(n)
    return pa.table({
        "g": rng.randint(0, 23, n),
        "h": rng.choice(["a", "b", "c", "d"], n),
        "v": pa.array(v, mask=idx % 17 == 0),
        "f": pa.array(f, mask=idx % 23 == 0),
        "s": [f"s{z:04d}" for z in rng.randint(0, 400, n)],
        "u": idx,
    })


WIN_SQL = {
    "rank_family": """SELECT g, v,
        row_number() OVER (PARTITION BY g ORDER BY v, s) AS rn,
        rank() OVER (PARTITION BY g ORDER BY v) AS rk,
        dense_rank() OVER (PARTITION BY g ORDER BY v) AS dr
        FROM t ORDER BY g, rn""",
    "partition_sum_no_order": """SELECT g, v,
        sum(v) OVER (PARTITION BY g) AS tot, count(v) OVER (PARTITION BY g)
        AS c, count(*) OVER (PARTITION BY g) AS cs,
        avg(f) OVER (PARTITION BY g) AS m FROM t ORDER BY g, s, v""",
    "running_sum_rows": """SELECT h, s, v, sum(v) OVER (PARTITION BY h
        ORDER BY s, v, u ROWS BETWEEN UNBOUNDED PRECEDING AND CURRENT ROW)
        AS rs FROM t ORDER BY h, s, v, u""",
    "running_sum_range_peers": """SELECT g, v, sum(v) OVER (PARTITION BY g
        ORDER BY v) AS rs FROM t WHERE v IS NOT NULL ORDER BY g, v""",
    "moving_avg_rows": """SELECT h, s, v, avg(v) OVER (PARTITION BY h
        ORDER BY s, v, u ROWS BETWEEN 2 PRECEDING AND CURRENT ROW) AS ma
        FROM t WHERE v IS NOT NULL ORDER BY h, s, v, u""",
    "centered_rows": """SELECT h, s, v, sum(v) OVER (PARTITION BY h
        ORDER BY s, v, u ROWS BETWEEN 1 PRECEDING AND 1 FOLLOWING) AS w3
        FROM t WHERE v IS NOT NULL ORDER BY h, s, v, u""",
    "lag_lead_first_last": """SELECT h, s, v,
        lag(v) OVER (PARTITION BY h ORDER BY s, v, u) AS pv,
        lead(v, 2) OVER (PARTITION BY h ORDER BY s, v, u) AS nv,
        lag(v, 1, -1) OVER (PARTITION BY h ORDER BY s, v, u) AS pvd,
        first_value(v) OVER (PARTITION BY h ORDER BY s, v, u) AS fv,
        last_value(v) OVER (PARTITION BY h ORDER BY s, v, u
            ROWS BETWEEN UNBOUNDED PRECEDING AND UNBOUNDED FOLLOWING) AS lv
        FROM t WHERE v IS NOT NULL ORDER BY h, s, v, u""",
    "ntile": """SELECT h, ntile(4) OVER (PARTITION BY h ORDER BY v, s) AS q
        FROM t ORDER BY h, q""",
    "over_group_by": """SELECT g, h, sum(v) AS sv,
        sum(sum(v)) OVER (PARTITION BY h) AS hv,
        sum(v) * 100.0 / sum(sum(v)) OVER (PARTITION BY h) AS ratio
        FROM t GROUP BY g, h ORDER BY g, h""",
    "rank_over_aggregate": """SELECT g, h, rank() OVER (PARTITION BY g
        ORDER BY sum(v) DESC) AS rk FROM t GROUP BY g, h ORDER BY g, rk""",
    "derived_table_topn": """SELECT g, v FROM (
        SELECT g, v, row_number() OVER (PARTITION BY g ORDER BY v DESC)
        AS rn FROM t WHERE v IS NOT NULL) ranked
        WHERE rn <= 2 ORDER BY g, v DESC""",
    "desc_nulls_first": """SELECT g, v, row_number() OVER (PARTITION BY g
        ORDER BY v DESC) AS rn FROM t ORDER BY g, rn""",
    "no_partition": """SELECT v, row_number() OVER (ORDER BY v, s) AS rn,
        sum(v) OVER () AS tot FROM t WHERE v IS NOT NULL ORDER BY rn
        LIMIT 10""",
    "empty_input": """SELECT g, row_number() OVER (PARTITION BY g ORDER BY v)
        AS rn FROM t WHERE v > 100000""",
    "min_max_string": """SELECT h, min(s) OVER (PARTITION BY h) AS lo,
        max(s) OVER (PARTITION BY h) AS hi FROM t ORDER BY h LIMIT 50""",
    "rows_minmax_following": """SELECT u,
        min(v) OVER (PARTITION BY g ORDER BY u
            ROWS BETWEEN 2 PRECEDING AND 3 FOLLOWING) AS mn,
        max(v) OVER (PARTITION BY g ORDER BY u
            ROWS BETWEEN 2 PRECEDING AND 3 FOLLOWING) AS mx
        FROM t ORDER BY u""",
    "range_offsets": """SELECT u,
        sum(u) OVER (PARTITION BY g ORDER BY u
            RANGE BETWEEN 5 PRECEDING AND 10 FOLLOWING) AS sm,
        count(*) OVER (PARTITION BY g ORDER BY u
            RANGE BETWEEN 5 PRECEDING AND 10 FOLLOWING) AS ct,
        min(u) OVER (PARTITION BY g ORDER BY u DESC
            RANGE BETWEEN 3 PRECEDING AND 3 FOLLOWING) AS mnd
        FROM t ORDER BY u""",
}


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_window")
    path = str(d / "t.parquet")
    pq.write_table(_sql_table(), path)
    jctx, _ = JBuilder().with_max_memory_bytes(1 << 28).build()
    tctx, _ = (LiquidCacheLocalBuilder(device="cpu")
               .with_max_memory_bytes(1 << 28).build())
    jctx.register_parquet("t", path)
    tctx.register_parquet("t", path)
    return jctx, tctx


@pytest.mark.parametrize("name", list(WIN_SQL))
def test_window_sql(sessions, name):
    jctx, tctx = sessions
    sql = " ".join(WIN_SQL[name].split())
    w0 = texec.STATS["windows"]
    ours = tctx.sql(sql).to_arrow()
    assert texec.STATS["windows"] == w0 + 1
    if name != "empty_input":
        assert ours.num_rows > 0
    assert_same_answer(ours, jctx, sql)
