"""Port coverage fence, TPC-H: the 22 queries of
`liquid_tpu.bench.tpch_queries` at SF 0.01, each package on the tables of
its own generator (same seed), both on the CPU.

`ANSWERED` pins, as a set that may only grow, the queries the port
answers equal to the reference (the tie rule and tolerances of
`test_torch_route_fence.py`): all 22 since the classic path (q2, q13,
q15, q17 and q20 run it, `exec.STATS`).  The pyarrow oracles of those
five (`bench/oracle.py`, phase 6e of `chip_smoke.py`) are held against
the reference's answers here too."""
import pytest

torch = pytest.importorskip("torch")

import pyarrow.parquet as pq  # noqa: E402

from liquid_tpu.bench import tpch_data as jtpch  # noqa: E402
from liquid_tpu.bench.tpch_queries import QUERIES  # noqa: E402
from liquid_tpu.sql.session import LiquidCacheLocalBuilder as JBuilder  # noqa: E402
from liquid_tpu_torch.bench import tpch_data as ttpch  # noqa: E402
from liquid_tpu_torch.sql.session import LiquidCacheLocalBuilder  # noqa: E402
from liquid_tpu_torch.bench import oracle  # noqa: E402
from liquid_tpu_torch.sql import exec as texec  # noqa: E402
from tests.test_torch_route_fence import assert_same_answer  # noqa: E402

SF = 0.01

#: TPC-H queries the port answers equal to the reference -- grow-only
ANSWERED = set(range(1, 23))

#: what each query the port does not answer yet raises for
RAISES: dict = {}

#: the queries the classic path answers (a bare SELECT over a join: q2,
#: q20; a derived table with a left join inside: q13; a join with an
#: aggregate view: q15; a correlated scalar lookup: q17)
CLASSIC = (2, 13, 15, 17, 20)


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_fence_tpch")
    jctx, _ = JBuilder().with_max_memory_bytes(1 << 30).build()
    tctx, _ = (LiquidCacheLocalBuilder(device="cpu")
               .with_max_memory_bytes(1 << 30).build())
    paths = {}
    for side, gen, ctx in (("j", jtpch, jctx), ("t", ttpch, tctx)):
        for name, t in gen.generate(SF).items():
            path = str(d / f"{side}_{name}.parquet")
            pq.write_table(t, path, row_group_size=1 << 16)
            ctx.register_parquet(name, path)
            if side == "t":
                paths[name] = path
    return jctx, tctx, paths


def _run(ctx, sql):
    """A query's answer; a statement list (q15's view) runs whole and
    answers with its SELECT."""
    out = None
    for stmt in (sql if isinstance(sql, list) else [sql]):
        got = ctx.sql(stmt).to_arrow()
        if stmt.strip().lower().startswith("select"):
            out = got
    return out


def test_fence_sets_cover_every_query():
    assert ANSWERED.isdisjoint(RAISES)
    assert ANSWERED | set(RAISES) == set(range(1, 23))
    assert len(ANSWERED) >= 22


@pytest.mark.parametrize("qid", range(1, 23),
                         ids=[f"q{i}" for i in range(1, 23)])
def test_tpch_query(sessions, qid):
    jctx, tctx, _ = sessions
    sql = QUERIES[qid]
    if qid not in ANSWERED:
        with pytest.raises(NotImplementedError, match=RAISES[qid]):
            _run(tctx, sql)
        return
    c0 = dict(texec.STATS)
    ours = _run(tctx, sql)
    assert ours.num_rows > 0
    if qid in CLASSIC:
        assert texec.STATS != c0, "the classic path did not run"
    if isinstance(sql, list):
        ref = _run(jctx, sql)
        assert ours.column_names == ref.column_names
        assert oracle.same_table(ours, ref.columns)
    else:
        assert_same_answer(ours, jctx, sql)


@pytest.mark.parametrize("qid", CLASSIC, ids=[f"q{i}" for i in CLASSIC])
def test_classic_oracle_matches_the_reference(sessions, qid):
    """The pyarrow oracle phase 6e holds the port to, on the port's
    tables, against the reference's answer on its own."""
    jctx, _, paths = sessions
    want = oracle.answers(paths, [f"tpch_q{qid}"])[f"tpch_q{qid}"]
    ref = _run(jctx, QUERIES[qid])
    assert ref.num_rows == len(want[0]) > 0
    assert oracle.same_table(ref, want)
