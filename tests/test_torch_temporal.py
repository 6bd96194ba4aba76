"""The port's temporal and CASE expression IR (`sql/fused_agg.py`:
`_compile_expr`, `_time_image_ir`, `_civil_ir`, `_extract_ir`, the "fdiv",
"mod" and "where" nodes) against the JAX package's, both on the CPU.

Each expression is parsed by each package's own parser and compiled by
each package's `_compile_expr` over the same column kinds and arrow types:
the IR trees must be equal.  Both interpreters (`eval_ir_nulls`) then run
it over the same numpy-seeded int64 columns -- negative epoch seconds and
days before 1970, NULLs -- and must agree exactly on the null mask and on
every non-NULL value (integers exact; f64 rtol 1e-12).  The civil fields
are also held against Python's own calendar."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import datetime  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pyarrow as pa  # noqa: E402

from liquid_tpu.sql import fused_agg as jfa  # noqa: E402
from liquid_tpu.sql.parser import parse_statement as jparse  # noqa: E402
from liquid_tpu_torch.sql import fused_agg as tfa  # noqa: E402
from liquid_tpu_torch.sql.parser import parse_statement as tparse  # noqa: E402

N = 4000
VOCAB = ["a", "b", "c", None]

#: column -> (fused kind, arrow type)
COLUMNS = {
    "d": ("planes", pa.date32()),
    "ts": ("planes", pa.int64()),
    "tss": ("planes", pa.timestamp("s")),
    "tsms": ("planes", pa.timestamp("ms")),
    "tsus": ("planes", pa.timestamp("us")),
    "tsns": ("planes", pa.timestamp("ns")),
    "x": ("planes", pa.int64()),
    "f": ("float", pa.float64()),
    "s": ("dict", pa.string()),
}


class _Kinds(dict):
    def arrow_type(self, c):
        return COLUMNS[c][1] if c in COLUMNS else None


KINDS = _Kinds({c: k for c, (k, _t) in COLUMNS.items()})


def _dictres(c, op, lit):
    if op == "=" and c == "s":
        return tuple(i for i, v in enumerate(VOCAB) if v == lit)
    return None


def _data():
    rng = np.random.default_rng(2024)
    secs = rng.integers(-(40 << 30), 40 << 30, N)  # about 1884..2055
    secs[:8] = [0, -1, -59, -60, -61, -86400, -86401, 951782400]
    days = rng.integers(-200_000, 200_000, N)  # years about 1422..2517
    days[:6] = [0, -1, -719468, -719469, 11016, 59]
    cols = {"d": days, "ts": secs, "tss": secs,
            "tsms": secs * 1000 + rng.integers(-999, 1000, N),
            "tsus": secs * 1_000_000 + rng.integers(0, 10 ** 6, N),
            "tsns": secs * 10 ** 9 - rng.integers(0, 10 ** 9, N),
            "x": rng.integers(-50, 50, N),
            "f": rng.normal(0.0, 100.0, N),
            "s": rng.integers(0, len(VOCAB), N)}
    nulls = {c: rng.random(N) < 0.1 for c in cols}
    nulls["s"] = nulls["s"] | (cols["s"] == len(VOCAB) - 1)
    return cols, nulls


FIELDS = ["year", "month", "day", "quarter", "dow", "hour", "minute",
          "second"]

EXPRS = (
    [f"extract({f} FROM to_timestamp_seconds(ts))" for f in FIELDS]
    + [f"extract({f} FROM d)" for f in ("year", "month", "day", "quarter",
                                         "dow")]
    + [f"extract({f} FROM {c})" for f in ("minute", "day", "year")
       for c in ("tss", "tsms", "tsus", "tsns")]
    + [f"date_trunc('{u}', to_timestamp_seconds(ts))"
       for u in ("second", "minute", "hour", "day")]
    + ["date_trunc('minute', tsms)",
       "CASE WHEN x > 0 THEN x ELSE 0 - x END",
       "CASE WHEN s = 'a' THEN x WHEN s = 'b' OR x < -40 THEN 7 ELSE 0 END",
       "CASE WHEN x > 10 AND NOT (s = 'c') THEN f ELSE x END",
       "CASE WHEN extract(minute FROM to_timestamp_seconds(ts)) < 30 "
       "THEN d ELSE d + 1 END"])


def _compile(parse, fa, expr):
    e = parse(f"SELECT {expr} FROM t")[1].items[0].expr
    return fa._compile_expr(e, KINDS, _dictres)


class _Env:
    def __init__(self, cols, nulls):
        self.cols, self._nulls, self.device = cols, nulls, torch.device("cpu")

    def decode(self, name, dt):
        v = self.cols[name]
        return v.to(torch.float64) if dt == "f64" else v

    def nulls(self, name):
        return self._nulls[name]


@pytest.mark.parametrize("expr", EXPRS)
def test_expression_matches_reference(expr):
    cols, nulls = _data()
    t_ir, t_cols = _compile(tparse, tfa, expr)
    j_ir, j_cols = _compile(jparse, jfa, expr)
    assert t_ir == j_ir and t_cols == j_cols
    jv, jn = jfa.eval_ir_nulls(
        j_ir, lambda c, dt: (jnp.asarray(cols[c], jnp.float64) if dt == "f64"
                             else jnp.asarray(cols[c])),
        lambda c: jnp.asarray(nulls[c]))
    env = _Env({c: torch.from_numpy(np.ascontiguousarray(v))
                for c, v in cols.items()},
               {c: torch.from_numpy(v) for c, v in nulls.items()})
    tv, tn = tfa.eval_ir_nulls(t_ir, env)
    jv = np.broadcast_to(np.asarray(jv), (N,))
    jn = np.broadcast_to(np.asarray(jn), (N,))
    tv = tv.expand(N).numpy()
    tn = tn.expand(N).numpy()
    np.testing.assert_array_equal(tn, jn)
    assert tv.dtype == jv.dtype
    live = ~jn
    if tv.dtype == np.float64:
        np.testing.assert_allclose(tv[live], jv[live], rtol=1e-12)
    else:
        np.testing.assert_array_equal(tv[live], jv[live])
    assert live.sum() > N // 2


def _eval_port(expr, cols):
    ir, _ = _compile(tparse, tfa, expr)
    n = len(next(iter(cols.values())))
    env = _Env({c: torch.from_numpy(np.asarray(v)) for c, v in cols.items()},
               {c: torch.zeros(n, dtype=torch.bool) for c in cols})
    return tfa.eval_ir_nulls(ir, env)[0].expand(n).numpy()


def test_civil_fields_match_the_calendar():
    """Floor division and floor modulo, never truncation: seconds and
    days before the epoch land in the right minute, day and year."""
    secs = np.array([-1, -59, -60, -3601, -86401, 0, 86399, 951782400,
                     -2208988800, 4102444799], np.int64)
    days = np.array([-1, -365, -719162, 0, 59, 11016, 2932896], np.int64)
    epoch = datetime.datetime(1970, 1, 1)
    want = [epoch + datetime.timedelta(seconds=int(s)) for s in secs]
    for f in ("year", "month", "day", "hour", "minute", "second"):
        got = _eval_port(f"extract({f} FROM to_timestamp_seconds(ts))",
                         {"ts": secs})
        assert got.tolist() == [getattr(w, f) for w in want], f
    dow = _eval_port("extract(dow FROM to_timestamp_seconds(ts))",
                     {"ts": secs})
    assert dow.tolist() == [(w.isoweekday() % 7) for w in want]
    dates = [datetime.date(1970, 1, 1) + datetime.timedelta(days=int(d))
             for d in days]
    for f in ("year", "month", "day"):
        got = _eval_port(f"extract({f} FROM d)", {"d": days})
        assert got.tolist() == [getattr(w, f) for w in dates], f
    q = _eval_port("extract(quarter FROM d)", {"d": days})
    assert q.tolist() == [(w.month - 1) // 3 + 1 for w in dates]
    trunc = _eval_port("date_trunc('hour', to_timestamp_seconds(ts))",
                       {"ts": secs})
    assert trunc.tolist() == [int(s) // 3600 * 3600 for s in secs]


@pytest.mark.parametrize("expr,why", [
    ("extract(minute FROM d)", "extract minute from days"),
    ("date_trunc('week', to_timestamp_seconds(ts))", "date_trunc week"),
    ("extract(epoch FROM d)", "extract epoch"),
    ("CASE x WHEN 1 THEN 2 ELSE 3 END", "CASE <operand>"),
    ("CASE WHEN x > 1 THEN 2 END", "CASE without ELSE"),
    ("to_timestamp_seconds(f)", "to_timestamp_seconds over non-int"),
])
def test_unsupported_temporal_and_case_shapes_bail(expr, why):
    with pytest.raises(tfa._Bail, match=why):
        _compile(tparse, tfa, expr)
    with pytest.raises(jfa._Bail):
        _compile(jparse, jfa, expr)


def test_case_needs_a_dictionary_resolver():
    e = tparse("SELECT CASE WHEN x > 0 THEN 1 ELSE 0 END FROM t")[1] \
        .items[0].expr
    with pytest.raises(tfa._Bail, match="expression Case"):
        tfa._compile_expr(e, KINDS)


def test_temporal_key_types_match_reference():
    for expr, want in (("extract(minute FROM to_timestamp_seconds(ts))",
                        pa.int32()),
                       ("to_timestamp_seconds(ts)", pa.timestamp("s")),
                       ("date_trunc('minute', to_timestamp_seconds(ts))",
                        pa.timestamp("s")),
                       ("x + 1", pa.int64()), ("f * 2", pa.float64())):
        te = tparse(f"SELECT {expr} FROM t")[1].items[0].expr
        je = jparse(f"SELECT {expr} FROM t")[1].items[0].expr
        dt = tfa._ir_dtype(_compile(tparse, tfa, expr)[0])
        assert tfa._expr_key_type(te, dt) == jfa._expr_key_type(je, dt) \
            == want
