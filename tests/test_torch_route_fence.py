"""Port coverage fence, ClickBench: every `benchmark/clickbench/queries`
query on the vendored `nano_hits.parquet`, through the port and the JAX
package, both on the CPU.

`ANSWERED` pins, as a set that may only grow, the queries the port
answers equal to the reference: all 43 since the classic path (q19,
q23 and q39 run it, `CLASSIC`).  The reference's own fused
set (`tests/test_route_fence.py::EXPECT_CB_FUSED`) must answer through
the port's fused route (aggregate or bare SELECT).

Answers compare under the tie rule of a LIMIT cut (`oracle.same_table`):
the order-key values of the result rows agree row for row, the rows whose
order key differs from the cut's compare as multisets, and the rows tied
at the cut must be rows of the reference's whole answer with that key
(SQL leaves the pick open).  Integers and strings compare exactly, floats
to 9 significant digits (the packages add in different orders)."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import pathlib  # noqa: E402
import re  # noqa: E402

import pyarrow as pa  # noqa: E402

from liquid_tpu.sql.session import LiquidCacheLocalBuilder as JBuilder  # noqa: E402
from liquid_tpu_torch.bench.hits import NANO_HITS  # noqa: E402
from liquid_tpu_torch.bench import oracle  # noqa: E402
from liquid_tpu_torch.bench.oracle import same_table  # noqa: E402
from liquid_tpu_torch.sql import exec as texec  # noqa: E402
from liquid_tpu_torch.sql import fused_agg as tfa  # noqa: E402
from liquid_tpu_torch.sql.parser import parse_statement  # noqa: E402
from liquid_tpu_torch.sql.session import LiquidCacheLocalBuilder  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]

#: the reference's pinned fused set (tests/test_route_fence.py)
EXPECT_CB_FUSED = [1, 2, 3, 4, 7, 8, 9, 12, 13, 14, 15, 16, 17, 18,
                   21, 22, 24, 26, 27, 28, 30, 34, 35, 40, 42]

#: ClickBench queries the port answers equal to the reference -- grow-only
ANSWERED = set(range(43))

#: what each query the port does not answer yet raises for
RAISES: dict = {}

#: the queries the fused routes pass to the classic path, with the reason
#: they give.  q19: once UserID is cached, the port's zone maps leave one
#: block, whose 64 bit-planes have no interval form (on a fresh session
#: the port keeps three blocks, one of them linear-coded, and its fused
#: select answers; the reference keeps three in both states).  q23:
#: SELECT *.  q39: a string-valued CASE.
CLASSIC = {19: "predicate eq on UserID", 23: "SELECT *", 39: "literal ''"}


def _sql(i: int) -> str:
    return (REPO / f"benchmark/clickbench/queries/q{i}.sql").read_text() \
        .strip().rstrip(";")


@pytest.fixture(scope="module")
def sessions():
    jctx, _ = JBuilder().with_max_memory_bytes(1 << 30).build()
    tctx, _ = (LiquidCacheLocalBuilder(device="cpu")
               .with_max_memory_bytes(1 << 30).build())
    jctx.register_parquet("hits", NANO_HITS)
    tctx.register_parquet("hits", NANO_HITS)
    return jctx, tctx


def _order_columns(sql: str):
    """Result column positions of the ORDER BY keys, or None when one is
    not a result column (then no tie allowance applies)."""
    q = parse_statement(sql)[1]
    cols = []
    for o in q.order_by:
        e = o.expr
        pos = None
        if hasattr(e, "value") and isinstance(e.value, int) \
                and not isinstance(e.value, bool):
            pos = e.value - 1
        for i, it in enumerate(q.items):
            if pos is None and (it.expr == e or (
                    it.alias and getattr(e, "name", None) == it.alias)):
                pos = i
        if pos is None:
            return None, q
        cols.append(pos)
    return cols, q


_LIMIT = re.compile(r"\s+LIMIT\s+\d+(\s+OFFSET\s+\d+)?\s*$", re.I)


def assert_same_answer(ours: pa.Table, jctx, sql: str):
    """The port's answer against the reference's under the tie rule
    (`oracle.same_table`).  A LIMIT cut on result columns is held against
    the reference's whole answer (its query without LIMIT and OFFSET), so
    the rows tied at the cut must be reference rows with that key; any
    other answer compares row for row on its order keys and as a multiset
    of rows."""
    cols, q = _order_columns(sql)
    if q.limit is not None and cols is not None:
        whole = _LIMIT.sub("", sql)
        assert parse_statement(whole)[1].limit is None, whole
        ref = jctx.sql(whole).to_arrow()
        cut = (tuple(cols), q.offset or 0, q.limit)
    else:
        ref = jctx.sql(sql).to_arrow()
        cut = (tuple(cols or ()), 0, ref.num_rows)
    assert ours.column_names == ref.column_names
    assert [f.type for f in ours.schema] == [f.type for f in ref.schema]
    assert same_table(ours, ref.columns, cut)


def test_fence_sets_cover_every_query():
    assert ANSWERED.isdisjoint(RAISES)
    assert ANSWERED | set(RAISES) == set(range(43))
    assert set(EXPECT_CB_FUSED) <= ANSWERED
    assert len(ANSWERED) >= 39


@pytest.mark.parametrize("i", range(43), ids=[f"q{i}" for i in range(43)])
def test_clickbench_query(sessions, i):
    jctx, tctx = sessions
    sql = _sql(i)
    if i == 19:  # the hand-off needs UserID's zone maps: cache it first
        tctx.sql('SELECT MAX("UserID") FROM hits').to_arrow()
    if i not in ANSWERED:
        with pytest.raises(NotImplementedError, match=RAISES[i]):
            tctx.sql(sql).to_arrow()
        return
    before = (tfa.STATS["fused_queries"], tfa.STATS["fused_selects"])
    c0 = dict(texec.STATS)
    ours = tctx.sql(sql).to_arrow()
    if i in EXPECT_CB_FUSED:
        assert (tfa.STATS["fused_queries"], tfa.STATS["fused_selects"]) \
            != before, "left the fused route"
    if i in CLASSIC:
        assert CLASSIC[i] in tfa.STATS["last_bail"]
        assert texec.STATS != c0, "the classic path did not run"
    assert_same_answer(ours, jctx, sql)


@pytest.mark.parametrize("i", sorted(CLASSIC))
def test_classic_oracle_matches_the_reference(sessions, i):
    """The pyarrow oracle phase 6e of `chip_smoke.py` holds the port to,
    against the reference's answer (its whole answer where a LIMIT cuts
    through ties, under the tie rule of `oracle.CUTS`)."""
    jctx, _ = sessions
    name = f"cb_q{i}"
    want = oracle.answers({"hits": NANO_HITS}, [name])[name]
    assert oracle.same_table(jctx.sql(_sql(i)).to_arrow(), want,
                             oracle.CUTS.get(name))


def test_tie_rule_compares_only_the_count_at_the_cut():
    """Of the rows tied at the cut, the pick is open; each must still be
    one of the reference's rows with that key."""
    sql = 'SELECT "k", COUNT(*) AS c FROM t GROUP BY "k" ORDER BY c DESC LIMIT 3'
    cols, q = _order_columns(sql)
    assert cols == [1]
    cut = (tuple(cols), 0, q.limit)
    whole = [pa.array([1, 2, 3, 4]), pa.array([9, 5, 5, 5])]

    def same(k, c):
        return same_table(pa.table({"k": k, "c": c}), whole, cut)

    assert same([1, 4, 2], [9, 5, 5])
    assert not same([7, 2, 3], [9, 5, 5])  # a row above the cut differs
    assert not same([1, 2, 3], [9, 5, 4])  # the tied count differs
    assert not same([1, 2, 8], [9, 5, 5])  # a tied row the reference lacks
