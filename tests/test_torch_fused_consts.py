"""A planned fused program's constants live on the card (`fused_agg.
bind_consts`): its IR literals, IN lists and the direct path's key bounds
go up once when the plan is made, so a cached plan is enqueued with no
upload (each upload from pageable memory synchronizes the stream).

- The 16 queries of the benchmark's `tpch_sf1.fused` cell at SF 0.01,
  after one cold and one warm pass: a third pass makes no upload while a
  program is enqueued (`STATS["issue_uploads"]`), none at all for a query
  that finds its plan cached, answers bit for bit as the warm pass did and
  equal to the reference's.
- Each constant kind through a "const" / "inconst" node and through the
  "lit" / IN-list path: the same dtype and the same bits (an int64 literal
  stays an int64 tensor; a float one times an int column stays float64),
  and no upload while the bound IR runs.
- The direct path's key bounds from the plan and uploaded per run: the
  same answer.
- The mesh (`parallel/session.py`) still evaluates "lit" nodes over its
  own columns, answering as the single-device session does."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402
import pyarrow as pa  # noqa: E402
import pyarrow.parquet as pq  # noqa: E402

from cachebench import spec  # noqa: E402
from liquid_tpu.bench import tpch_data as jtpch  # noqa: E402
from liquid_tpu.sql.session import LiquidCacheLocalBuilder as JBuilder  # noqa: E402
from liquid_tpu_torch.bench import oracle  # noqa: E402
from liquid_tpu_torch.bench import tpch_data as ttpch  # noqa: E402
from liquid_tpu_torch.parallel import make_mesh  # noqa: E402
from liquid_tpu_torch.parallel import session as psession  # noqa: E402
from liquid_tpu_torch.sql import fused_agg as tfa  # noqa: E402
from liquid_tpu_torch.sql.session import LiquidCacheLocalBuilder  # noqa: E402
from liquid_tpu_torch.utils.tracing import COPIES  # noqa: E402
from tests.test_torch_route_fence import assert_same_answer  # noqa: E402

SF = 0.01
CELL = "tpch_sf1.fused"
QUERIES = spec.workload(CELL)["queries"]


def _sql(q: str) -> str:
    return spec.query_sql(spec.cell(CELL)["config"], q)


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    d = tmp_path_factory.mktemp("fused_consts")
    jctx, _ = JBuilder().with_max_memory_bytes(1 << 30).build()
    tctx, _ = (LiquidCacheLocalBuilder(device="cpu")
               .with_max_memory_bytes(1 << 30).build())
    for side, gen, ctx in (("j", jtpch, jctx), ("t", ttpch, tctx)):
        for name, t in gen.generate(SF).items():
            path = str(d / f"{side}_{name}.parquet")
            pq.write_table(t, path, row_group_size=1 << 16)
            ctx.register_parquet(name, path)
    return jctx, tctx


@pytest.fixture(scope="module")
def passes(sessions):
    """The cell's queries: a cold pass (caches the columns), a warm pass
    (plans under the settled cache epoch), then a measured pass ->
    (warm answers, measured answers, per query (uploads, issue uploads,
    fused selects) of the measured pass)."""
    _, tctx = sessions
    for q in QUERIES:
        tctx.sql(_sql(q)).to_arrow()
    warm = {q: tctx.sql(_sql(q)).to_arrow() for q in QUERIES}
    got, counts = {}, {}
    for q in QUERIES:
        u0, i0 = COPIES["uploads"], tfa.STATS["issue_uploads"]
        s0 = tfa.STATS["fused_selects"]
        got[q] = tctx.sql(_sql(q)).to_arrow()
        counts[q] = (COPIES["uploads"] - u0,
                     tfa.STATS["issue_uploads"] - i0,
                     tfa.STATS["fused_selects"] - s0)
    return warm, got, counts


def test_a_warm_pass_enqueues_no_upload(passes):
    _, _, counts = passes
    assert sum(i for _u, i, _s in counts.values()) == 0, counts
    # a cached plan uploads nothing; a fused select (planned on every
    # run: q16's NOT IN subquery) places its constants in one upload
    for q, (u, _i, s) in counts.items():
        assert u <= s, (q, counts[q])


def test_the_cell_runs_its_programs(passes):
    """The measured pass runs planned programs: fused and star queries."""
    _, _, counts = passes
    assert tfa.STATS["fused_queries"] > 0 and tfa.STATS["star_queries"] > 0
    assert tfa.STATS["plan_consts"] > 0
    assert set(counts) == set(QUERIES) and len(QUERIES) == 16


@pytest.mark.parametrize("q", QUERIES)
def test_warm_answers_are_bit_identical_and_the_references(sessions, passes,
                                                           q):
    jctx, _ = sessions
    warm, got, _ = passes
    assert got[q].equals(warm[q])
    assert_same_answer(got[q], jctx, _sql(q))


# -- each constant kind: "const" against "lit" --------------------------------

N = 64
_RNG = np.random.default_rng(22)
_X = torch.from_numpy(_RNG.integers(-1000, 1000, N).astype(np.int64))
_F = torch.from_numpy(np.round(_RNG.uniform(-5, 5, N), 2))
_S = torch.from_numpy(_RNG.integers(0, 6, N).astype(np.int64))
_NULLS = {"x": torch.from_numpy(_RNG.random(N) < 0.2),
          "f": torch.from_numpy(_RNG.random(N) < 0.1)}

X, F, S = ("col", "x", "i64"), ("col", "f", "f64"), ("col", "s", "i64")


def _bin(op, dt, l, r):
    return ("bin", op, dt, l, r)


def _lit(v):
    return ("lit", v, "f64" if isinstance(v, float) else "i64")


CASES = {
    "int_literal": _bin("+", "i64", X, _lit(7)),
    "lone_int_literal": _lit(123456789012),
    "lone_float_literal": _lit(0.1),
    "float_literal_times_int_column": _bin("*", "f64", X, _lit(0.1)),
    "float_literal_times_cast_column": _bin("*", "f64", ("cast", "f64", X),
                                            _lit(0.05)),
    "negative_literal": _bin("-", "i64", _lit(-3), X),
    "negated_literal": ("neg", "i64", _lit(5)),
    "fdiv": _bin("fdiv", "i64", X, _lit(7)),
    "fdiv_negative_divisor": _bin("fdiv", "i64", X, _lit(-7)),
    "mod": _bin("mod", "i64", X, _lit(7)),
    "mod_negative_divisor": _bin("mod", "i64", X, _lit(-7)),
    "true_division": _bin("/", "f64", ("cast", "f64", X), _lit(3.0)),
    "float_comparison": ("cmp", "<", F, _lit(0.5)),
    "case": ("where", "i64", ("cmp", ">", X, _lit(0)), _lit(1), _lit(-1)),
    "civil_year": tfa._extract_ir("year", X, "days"),
    "date_trunc_minute": _bin("*", "i64", tfa._fdiv(X, 60), tfa._ilit(60)),
    "inints": ("inints", "x", (1, -5, 9, 0), "i64"),
    "inints_float": ("inints", "f", (0.5, 2.0, -1.25), "f64"),
    "incodes": ("incodes", "s", (0, 2, 5)),
    "incodes_empty": ("incodes", "s", ()),
    "in_with_null": ("bnot", ("bor", ("inints", "x", (3,), "i64"),
                              ("unknown",))),
}


class _Env(psession.IREnv):
    """The mesh's column access, with a plan's arrays."""

    def __init__(self, arrays=()):
        super().__init__({"x": _X, "f": _F, "s": _S}, _NULLS,
                         torch.device("cpu"), N)
        self.arrays = list(arrays)


def _eval(ir, env):
    if ir[0] in tfa._BOOL_TAGS:
        return tfa._bool3(ir, env)
    return tfa.eval_ir_nulls(ir, env)


def _tags(ir) -> set:
    out = {ir[0]}
    for part in ir[1:]:
        if isinstance(part, tuple) and part and isinstance(part[0], str):
            out |= _tags(part)
    return out


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float64:
        return torch.equal(a.view(torch.int64), b.view(torch.int64))
    return torch.equal(a, b)


@pytest.mark.parametrize("name", sorted(CASES))
def test_a_const_node_is_the_literal_bit_for_bit(name):
    ir = CASES[name]
    want = _eval(ir, _Env())
    p = tfa._Plan()
    bound = tfa.bind_ir(p, ir)
    assert not _tags(bound) & {"lit", "inints"}
    if name != "incodes_empty":
        assert p.pending["i64"] or p.pending["f64"]
    tfa.place_consts(p, "cpu")
    assert not p.pending["i64"] and not p.pending["f64"]
    u0 = COPIES["uploads"]
    got = _eval(bound, _Env(p.arrays))
    assert COPIES["uploads"] == u0  # nothing copied while it runs
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert _same_bits(g, w), (name, g, w)
    # the constants' shared no-NULL flag is never written
    assert not bool(tfa._no_nulls(torch.device("cpu")))


def test_a_literal_keeps_its_dtype():
    """int64 times a float64 0-dim tensor is float64; times a Python
    float it would be float32, so a literal never becomes a scalar."""
    p = tfa._Plan()
    bound = tfa.bind_ir(p, CASES["float_literal_times_int_column"])
    tfa.place_consts(p, "cpu")
    v, _ = tfa.eval_ir_nulls(bound, _Env(p.arrays))
    assert v.dtype == torch.float64
    assert (_X * 0.1).dtype == torch.float32  # what a scalar would give
    c = [a for a in p.arrays if a is not None and a.dim() == 0]
    assert c and all(a.dtype in (torch.int64, torch.float64) for a in c)


def test_constants_pack_into_one_tensor_per_dtype():
    p = tfa._Plan()
    tfa.bind_ir(p, ("band", CASES["inints"], ("cmp", "<", F, _lit(0.5))))
    tfa.bind_ir(p, CASES["civil_year"])
    u0 = COPIES["uploads"]
    n0 = tfa.STATS["plan_consts"]
    tfa.place_consts(p, "cpu")
    assert COPIES["uploads"] == u0 + 2  # int64 and float64
    assert tfa.STATS["plan_consts"] > n0 + 10
    bases = {a.untyped_storage().data_ptr() for a in p.arrays}
    assert len(bases) == 2


def test_an_int64_literal_out_of_range_keeps_its_lit_node():
    p = tfa._Plan()
    ir = _bin("+", "i64", X, _lit(1 << 63))
    assert tfa.bind_ir(p, ir) == ir
    assert not p.pending["i64"]


def test_direct_path_bounds_from_the_plan_answer_as_uploaded(sessions,
                                                             monkeypatch):
    """Grouped runs on the direct path read their key bounds from the
    plan; with the bounds uploaded per run instead, the same answer."""
    _, tctx = sessions
    seen = []
    real = tfa.execute_plan

    def spy(p, mode, empty, slots, table, topk=None):
        seen.append((p, mode, empty, slots, table, topk))
        return real(p, mode, empty, slots, table, topk)
    monkeypatch.setattr(tfa, "execute_plan", spy)
    sql = ("SELECT l_returnflag, l_linestatus, l_shipmode, sum(l_quantity)"
           " AS q, count(*) AS c FROM lineitem WHERE l_quantity > 3 "
           "GROUP BY l_returnflag, l_linestatus, l_shipmode")
    for _ in range(3):
        tctx.sql(sql).to_arrow()
    p, mode, empty, slots, table, topk = seen[-1]
    assert mode == "grouped" and not empty and p.los_ix is not None
    assert p.arrays[p.los_ix].dim() == 1
    u0, i0 = COPIES["uploads"], tfa.STATS["issue_uploads"]
    from_plan = real(p, mode, empty, slots, table, topk)
    assert COPIES["uploads"] == u0 and tfa.STATS["issue_uploads"] == i0
    los_ix, p.los_ix = p.los_ix, None
    try:
        uploaded = real(p, mode, empty, slots, table, topk)
    finally:
        p.los_ix = los_ix
    assert COPIES["uploads"] == u0 + 1
    assert from_plan.num_rows > 1 and from_plan.equals(uploaded)


# -- the mesh keeps the "lit" path ----------------------------------------------

MESH_SQL = [
    "SELECT region, sum(qty * 2) AS s, count(*) AS c FROM events "
    "WHERE qty IN (1, 5, 9, 40) OR price > 50.5 GROUP BY region "
    "ORDER BY region",
    "SELECT sum(price * 0.5) AS s, min(qty - 3) AS m FROM events "
    "WHERE region <> 7 AND qty - 3 > 10",
]


@pytest.fixture(scope="module")
def events():
    rng = np.random.default_rng(22)
    n = 10_007
    return pa.table({
        "region": pa.array(rng.integers(0, 30, n).astype(np.int64)),
        "qty": pa.array(rng.integers(1, 100, n).astype(np.int64)),
        "price": pa.array(np.round(rng.random(n) * 100, 2)),
    })


@pytest.mark.parametrize("sql", MESH_SQL)
def test_the_mesh_evaluates_lit_nodes(events, sql, tmp_path, monkeypatch):
    tags: set = set()
    for fn in ("eval_ir", "eval_bool"):
        real = getattr(psession, fn)

        def spy(ir, env, _real=real):
            tags.update(_tags(ir))
            return _real(ir, env)
        monkeypatch.setattr(psession, fn, spy)
    mesh = psession.DistributedSession(make_mesh(devices=["cpu"] * 4))
    mesh.register_table("events", events)
    got = mesh.sql(sql)
    path = str(tmp_path / "events.parquet")
    pq.write_table(events, path)
    ctx, _ = (LiquidCacheLocalBuilder(device="cpu")
              .with_max_memory_bytes(1 << 28).build())
    ctx.register_parquet("events", path)
    want = ctx.sql(sql).to_arrow()
    assert "lit" in tags and not tags & {"const", "inconst"}
    assert got.column_names == want.column_names
    assert oracle.same_table(got, want.columns)
