"""NULLs in the fused routes' boolean logic, and the packed fetch's dtypes.

The fused routes evaluate a residual condition in SQL's three-valued
logic (`fused_agg._bool3`): a comparison with a NULL input, or with a
NULL literal, is UNKNOWN; `x IN (..., NULL)` is TRUE on a match and
UNKNOWN otherwise; AND, OR and NOT follow Kleene's tables, and a WHERE
keeps the TRUE rows.  The reference folds NULL to FALSE at each node,
so these shapes are held to pyarrow's Kleene kernels (`pc.and_kleene`,
`pc.or_kleene`, `pc.invert`) and to the port's own classic path, not to
the reference.  The table: 40,000 rows, numpy seed 3, `a`, `s` and `f`
each 20 % NULL.

`packfetch._as_i64_image` keeps each column's dtype in its tag: every
dtype it accepts round-trips, and any other raises."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
import pyarrow as pa  # noqa: E402
import pyarrow.compute as pc  # noqa: E402
import pyarrow.parquet as pq  # noqa: E402

from liquid_tpu_torch.ops import packfetch  # noqa: E402
from liquid_tpu_torch.sql import exec as texec  # noqa: E402
from liquid_tpu_torch.sql import fused_agg as tfa  # noqa: E402
from liquid_tpu_torch.sql.session import LiquidCacheLocalBuilder  # noqa: E402

N = 40_000


def _table() -> pa.Table:
    rng = np.random.default_rng(3)
    a = pa.array(rng.integers(0, 10, N), mask=rng.random(N) < 0.2)
    words = np.array(["", "alpha", "beta", "gamma", "delta"])
    s = pa.array(words[rng.integers(0, 5, N)], mask=rng.random(N) < 0.2)
    f = pa.array(rng.random(N), mask=rng.random(N) < 0.2)
    return pa.table({"a": a, "s": s, "f": f,
                     "g": pa.array(np.arange(N) % 7)})


_NULL_S = pa.scalar(None, pa.string())
_NULL_I = pa.scalar(None, pa.int64())


def _in(col, items, null):
    """`col IN (items..., NULL)` in Kleene logic."""
    m = pc.is_in(col, value_set=pa.array(items))
    m = pc.if_else(pc.is_null(col), pa.scalar(None, pa.bool_()), m)
    return pc.or_kleene(m, pc.equal(col, null))


#: (case, WHERE, its pyarrow mask over the table)
SHAPES = [
    ("not_and", "NOT (a > 5 AND f < 0.5)",
     lambda t: pc.invert(pc.and_kleene(pc.greater(t["a"], 5),
                                       pc.less(t["f"], 0.5)))),
    ("not_or", "NOT (a > 5 OR f < 0.5)",
     lambda t: pc.invert(pc.or_kleene(pc.greater(t["a"], 5),
                                      pc.less(t["f"], 0.5)))),
    ("not_and_string", "NOT (s = 'alpha' AND a < 3)",
     lambda t: pc.invert(pc.and_kleene(pc.equal(t["s"], "alpha"),
                                       pc.less(t["a"], 3)))),
    ("not_or_not", "NOT (NOT (a > 5) OR s <> 'beta')",
     lambda t: pc.invert(pc.or_kleene(pc.invert(pc.greater(t["a"], 5)),
                                      pc.not_equal(t["s"], "beta")))),
    ("string_not_in_null", "s NOT IN ('', NULL)",
     lambda t: pc.invert(_in(t["s"], [""], _NULL_S))),
    ("not_string_in_null", "NOT (s IN ('', NULL))",
     lambda t: pc.invert(_in(t["s"], [""], _NULL_S))),
    ("string_in_null", "s IN ('', NULL)",
     lambda t: _in(t["s"], [""], _NULL_S)),
    ("string_ne_null", "s <> NULL", lambda t: pc.not_equal(t["s"], _NULL_S)),
    ("string_eq_null", "s = NULL", lambda t: pc.equal(t["s"], _NULL_S)),
    ("int_not_in_null", "a NOT IN (1, NULL)",
     lambda t: pc.invert(_in(t["a"], [1], _NULL_I))),
    ("not_int_in_null", "NOT (a IN (1, NULL))",
     lambda t: pc.invert(_in(t["a"], [1], _NULL_I))),
    ("int_in_null", "a IN (1, NULL)", lambda t: _in(t["a"], [1], _NULL_I)),
]


@pytest.fixture(scope="module")
def ctx(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("torch_kleene") / "t.parquet")
    t = _table()
    pq.write_table(t, path, row_group_size=1 << 14)
    c, _ = LiquidCacheLocalBuilder(device="cpu").build()
    c.register_parquet("t", path)
    return c, t


def _count(mask) -> int:
    return pc.sum(pc.fill_null(mask, False).cast(pa.int64())).as_py() or 0


def test_the_measured_case_is_pyarrows():
    t = _table()
    assert _count(SHAPES[0][2](t)) == 27_512
    for i in (4, 5, 7, 8, 9, 10):
        assert _count(SHAPES[i][2](t)) == 0, SHAPES[i][0]


@pytest.mark.parametrize("case,where,mask", SHAPES,
                         ids=[c[0] for c in SHAPES])
def test_scalar_grouped_select_and_classic(ctx, case, where, mask):
    c, t = ctx
    want = _count(mask(t))
    keep = pc.fill_null(mask(t), False)
    s0 = dict(tfa.STATS)
    got = c.sql(f"SELECT count(*) FROM t WHERE {where}").to_arrow()
    assert got.column(0).to_pylist() == [want]
    assert tfa.STATS["fused_scalar"] == s0["fused_scalar"] + 1
    grouped = c.sql(f"SELECT g, count(*) AS c FROM t WHERE {where} "
                    "GROUP BY g ORDER BY g").to_arrow()
    assert tfa.STATS["fused_grouped"] == s0["fused_grouped"] + 1
    byg = t.filter(keep).group_by("g").aggregate([("g", "count")])
    assert dict(zip(grouped["g"].to_pylist(), grouped["c"].to_pylist())) \
        == dict(zip(byg["g"].to_pylist(), byg["g_count"].to_pylist()))
    rows = c.sql(f"SELECT a, s, f FROM t WHERE {where} LIMIT 5").to_arrow()
    assert tfa.STATS["fused_selects"] == s0["fused_selects"] + 1
    assert rows.num_rows == min(5, want)
    assert _count(mask(rows)) == rows.num_rows
    c0 = texec.STATS["classic_selects"]
    classic = c.sql(f"SELECT * FROM t WHERE {where}").to_arrow()
    assert texec.STATS["classic_selects"] == c0 + 1
    assert classic.num_rows == want
    assert classic.sort_by([("g", "ascending")]).column("g").to_pylist() \
        == t.filter(keep).sort_by([("g", "ascending")]).column("g") \
        .to_pylist()


def test_case_condition_in_three_valued_logic(ctx):
    c, t = ctx
    got = c.sql("SELECT sum(CASE WHEN NOT (a > 5 AND f < 0.5) THEN 1 ELSE 0 "
                "END) AS n, sum(CASE WHEN s NOT IN ('', NULL) THEN 1 ELSE 0 "
                "END) AS m FROM t").to_arrow()
    assert got.to_pylist() == [{"n": 27_512, "m": 0}]


# -- the packed fetch's integer images ---------------------------------------

def _values(dtype):
    if dtype == torch.bool:
        return torch.tensor([True, False, True])
    if dtype.is_floating_point:
        info = torch.finfo(dtype)
        vals = [0.0, -0.0, 1.5, -2.25, info.max, info.min, info.tiny,
                float("inf"), float("-inf"), float("nan")]
        if dtype == torch.float32:
            vals.append(info.tiny / 4)  # a subnormal keeps its bits
        return torch.tensor(vals, dtype=dtype)
    info = torch.iinfo(dtype)
    return torch.tensor([info.min, info.min + 1, -1 if info.min else 0, 0,
                         1, info.max - 1, info.max], dtype=dtype)


@pytest.mark.parametrize("dtype", [d for d, _ in
                                   packfetch._IMAGE_DTYPES.values()],
                         ids=list(packfetch._IMAGE_DTYPES))
def test_image_round_trips(dtype):
    x = _values(dtype)
    img, tag = packfetch._as_i64_image(x)
    assert img.dtype == torch.int64
    back = packfetch._from_i64_image(img.numpy(), tag)
    want = x.numpy()
    assert back.dtype == want.dtype
    if dtype == torch.float32:
        assert back.view(np.int32).tolist() == want.view(np.int32).tolist()
    else:
        np.testing.assert_array_equal(back, want)


def test_fetch_columns_keeps_each_dtype(monkeypatch):
    monkeypatch.setattr(packfetch, "MIN_PACK_BYTES", 0)
    g = 64
    cols = [torch.arange(g, dtype=torch.int32) - 7,
            torch.linspace(-3, 3, g, dtype=torch.float32),
            torch.arange(g, dtype=torch.int64) * 3,
            torch.linspace(0, 1, g, dtype=torch.float64)]
    out = packfetch.fetch_columns(cols, g)
    for c, o in zip(cols, out):
        assert o.dtype == c.numpy().dtype
        np.testing.assert_array_equal(o, c.numpy())


def test_a_dtype_with_no_image_raises():
    with pytest.raises(TypeError, match="float16"):
        packfetch._as_i64_image(torch.zeros(4, dtype=torch.float16))
