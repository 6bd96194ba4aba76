"""Port coverage fence, TPC-DS: the 95 queries of
`liquid_tpu_torch.bench.tpcds_queries` at SF 0.005 through the port on
the CPU, each held to the reference's pandas oracle
(`liquid_tpu.bench.tpcds_ref`) as `tests/test_tpcds.py` holds the
reference: shapes equal, floats to rtol 1e-6, everything else exactly,
rows in the query's order.

`ANSWERED` pins, as a set that may only grow, the queries the port
answers equal to the oracle; `RAISES` maps each other query to the
`NotImplementedError` text it raises.  Where the oracle shares a defect
of the reference engine, `SQL_ORACLES` gives SQL's answer instead (q51:
pandas' running max is NULL on a NULL row; SQL's max skips it).  The
pyarrow oracles of phase 6h of `chip_smoke.py` (`bench/oracle.py`) are
held against the pandas oracle here too."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import pyarrow as pa  # noqa: E402

from liquid_tpu.bench import tpcds_data as jtpcds  # noqa: E402
from liquid_tpu.bench import tpcds_ref  # noqa: E402
from liquid_tpu_torch.bench import oracle  # noqa: E402
from liquid_tpu_torch.bench import tpcds_data, tpcds_queries  # noqa: E402
from liquid_tpu_torch.sql import exec as texec  # noqa: E402
from liquid_tpu_torch.sql.session import LiquidCacheLocalBuilder  # noqa: E402
from tests.test_tpcds import assert_equal  # noqa: E402

SF = 0.005
QIDS = sorted(tpcds_queries.QUERIES)

#: TPC-DS queries the port answers equal to the oracle -- grow-only
ANSWERED = set(QIDS)

#: what each query the port does not answer yet raises for
RAISES: dict = {}

#: the queries that need windows and the ones that need grouping sets
WINDOWS = {12, 20, 36, 44, 47, 49, 51, 53, 57, 63, 67, 70, 86, 89, 98}
GROUPING_SETS = {5, 14, 18, 22, 27, 36, 67, 70, 77, 80, 86}


def _q51_sql(t):
    """`tpcds_ref.q51` with SQL's running max, which skips NULLs (pandas'
    `cummax` leaves a NULL row NULL): the running max carried forward."""
    def v1(fact, pfx):
        j = t[fact].merge(t["date_dim"], left_on=f"{pfx}_sold_date_sk",
                          right_on="d_date_sk")
        j = j[j.d_month_seq.between(24, 27)]
        g = j.groupby([f"{pfx}_item_sk", "d_date"],
                      as_index=False)[f"{pfx}_sales_price"].sum()
        g = g.sort_values([f"{pfx}_item_sk", "d_date"])
        g["cume_sales"] = g.groupby(
            f"{pfx}_item_sk")[f"{pfx}_sales_price"].cumsum()
        return g.rename(columns={f"{pfx}_item_sk": "item_sk"})[
            ["item_sk", "d_date", "cume_sales"]]
    m = v1("web_sales", "ws").merge(
        v1("store_sales", "ss"), on=["item_sk", "d_date"], how="outer",
        suffixes=("_w", "_s")).rename(columns={
            "cume_sales_w": "web_sales", "cume_sales_s": "store_sales"})
    m = m.sort_values(["item_sk", "d_date"]).reset_index(drop=True)
    for c in ("web", "store"):
        m[f"{c}_cumulative"] = m.groupby("item_sk")[f"{c}_sales"].cummax()
        m[f"{c}_cumulative"] = m.groupby("item_sk")[
            f"{c}_cumulative"].ffill()
    m = m[m.web_cumulative > m.store_cumulative]
    m = m.sort_values(["item_sk", "d_date"]).head(100)
    return m[["item_sk", "d_date", "web_sales", "store_sales",
              "web_cumulative", "store_cumulative"]]


#: oracles where the pandas one shares the reference engine's defect
SQL_ORACLES = {51: _q51_sql}


@pytest.fixture(scope="module")
def tpcds(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_fence_tpcds")
    tables = tpcds_data.generate(SF)
    paths = tpcds_data.write_parquet(tables, str(d))
    ctx, _ = (LiquidCacheLocalBuilder(device="cpu")
              .with_max_memory_bytes(1 << 28).build())
    for name, path in paths.items():
        ctx.register_parquet(name, path)
    return ctx, tpcds_ref.to_pandas_tables(tables), paths, tables


def test_fence_sets_cover_every_query():
    assert ANSWERED.isdisjoint(RAISES)
    assert ANSWERED | set(RAISES) == set(QIDS)
    assert len(ANSWERED) >= 90
    assert not any("window" in v or "GROUPING" in v for v in RAISES.values())


def test_the_generator_is_the_references(tpcds):
    _, _, _, tables = tpcds
    ref = jtpcds.generate(SF)
    assert sorted(tables) == sorted(ref)
    for name, t in tables.items():
        assert t.equals(ref[name]), name


@pytest.mark.parametrize("qid", QIDS, ids=[f"q{i}" for i in QIDS])
def test_tpcds_query(tpcds, qid):
    ctx, pdt, _, _ = tpcds
    sql = tpcds_queries.QUERIES[qid]
    if qid not in ANSWERED:
        with pytest.raises(NotImplementedError, match=RAISES[qid]):
            ctx.sql(sql).to_arrow()
        return
    c0 = dict(texec.STATS)
    out = ctx.sql(sql).to_arrow()
    assert texec.STATS["windows"] > c0["windows"] or qid not in WINDOWS
    assert (texec.STATS["grouping_sets"] > c0["grouping_sets"]
            or qid not in GROUPING_SETS)
    ref = SQL_ORACLES.get(qid, tpcds_ref.REFS[qid])(pdt)
    assert_equal(out, ref, qid)


def test_q51_oracle_differs_from_the_references(tpcds):
    """The pandas oracle's running max is NULL on a NULL row, so it keeps
    other rows than SQL's: SQL_ORACLES is needed."""
    _, pdt, _, _ = tpcds
    assert not _q51_sql(pdt).reset_index(drop=True).equals(
        tpcds_ref.q51(pdt).reset_index(drop=True))


@pytest.mark.parametrize("qid", oracle.TPCDS_QUERIES,
                         ids=[f"q{i}" for i in oracle.TPCDS_QUERIES])
def test_card_oracle_matches_the_pandas_oracle(tpcds, qid):
    """The pyarrow oracle phase 6h holds the port to, cut as the query's
    LIMIT cuts it, against the pandas oracle (SQL's for q51)."""
    _, pdt, paths, _ = tpcds
    name = f"ds_q{qid}"
    want = oracle.answers(paths, [name])[name]
    ref = SQL_ORACLES.get(qid, tpcds_ref.REFS[qid])(pdt)
    _, offset, limit = oracle.CUTS[name]
    got = pa.table({str(i): c for i, c in enumerate(want)}).slice(
        offset, limit)
    assert got.num_rows > 0
    assert_equal(got, ref, qid)
