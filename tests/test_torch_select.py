"""The port's fused bare SELECT (`fused_agg.try_fused_select`) against the
JAX package's, both on the CPU, through each package's
`LiquidCacheLocalBuilder` over one table this test writes and the vendored
`nano_hits.parquet`.

A query the reference answers on its fused select must answer through
the port's (`STATS["fused_selects"]` +1 in both) with the same rows in the
same order -- including which of the rows tied at the LIMIT cut it keeps:
both pick the lower row ids first.  The port fetches the cap's rows at
once where the reference fetches 4k + 64: where the k-th row ties the
reference's boundary the port must give the reference's classic answer.
Each case the fused select does not take (a tie at the fetch cap's
boundary, a NaN or nullable order key, an unordered scan too large to
fetch, SELECT *, SELECT DISTINCT, a stated NULL placement, a LIMIT beyond
the fetch cap) sends both packages to their classic paths, which give
the same answer."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
import pyarrow as pa  # noqa: E402
import pyarrow.parquet as pq  # noqa: E402
import re  # noqa: E402

from liquid_tpu.sql import fused_agg as jfa  # noqa: E402
from liquid_tpu.sql.session import LiquidCacheLocalBuilder as JBuilder  # noqa: E402
from liquid_tpu_torch.bench.hits import NANO_HITS  # noqa: E402
from liquid_tpu_torch.sql import exec as texec  # noqa: E402
from liquid_tpu_torch.sql import fused_agg as tfa  # noqa: E402
from liquid_tpu_torch.sql.session import LiquidCacheLocalBuilder  # noqa: E402
from tests.test_torch_route_fence import assert_same_answer  # noqa: E402

N = 30_000


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_select")
    rng = np.random.default_rng(31)
    f = rng.normal(0.0, 10.0, N)
    f[rng.integers(0, N, 5)] = np.nan
    words = np.array([f"s{i:04d}" for i in range(2000)])
    table = pa.table({
        "u": pa.array(rng.permutation(N).astype(np.int64)),
        # about 30 rows per value: ties at every LIMIT cut
        "o": pa.array(rng.integers(0, 1000, N)),
        "x": pa.array(rng.integers(0, 10, N).astype(np.int32)),
        "c": pa.array(np.ones(N, np.int64)),
        "f": pa.array(f),
        "nn": pa.array(rng.integers(0, 50, N), mask=rng.random(N) < 0.01),
        # about 300 rows per value: ties past the reference's fetch boundary
        "o2": pa.array(rng.integers(0, 100, N)),
        "s": pa.array(words[rng.integers(0, 2000, N)]),
    })
    path = str(d / "t.parquet")
    pq.write_table(table, path, row_group_size=1 << 14)
    jctx, _ = JBuilder().with_max_memory_bytes(1 << 30).build()
    tctx, _ = (LiquidCacheLocalBuilder(device="cpu")
               .with_max_memory_bytes(1 << 30).build())
    for ctx in (jctx, tctx):
        ctx.register_parquet("t", path)
        ctx.register_parquet("hits", NANO_HITS)
    return jctx, tctx


#: (name, sql) the reference answers on its fused select
ANSWERED = [
    ("ties_at_the_cut", "SELECT u, o, s FROM t WHERE x > 3 ORDER BY o "
     "LIMIT 10"),
    ("ties_desc_offset", "SELECT u, o FROM t WHERE x < 8 ORDER BY o DESC "
     "LIMIT 7 OFFSET 4"),
    ("second_key_on_host", "SELECT o, s, u FROM t ORDER BY o, s LIMIT 12"),
    ("string_order_key", "SELECT s, u FROM t WHERE x = 2 ORDER BY s DESC "
     "LIMIT 9"),
    ("expression_order_key", "SELECT u, o - x AS k FROM t WHERE s <> 's0001' "
     "ORDER BY o - x LIMIT 6"),
    ("unordered_limit", "SELECT u, x FROM t WHERE x = 3 LIMIT 5"),
    ("unordered_small", "SELECT u FROM t WHERE o = 17 AND x = 4"),
    ("empty_scan", "SELECT u FROM t WHERE x > 100 ORDER BY o LIMIT 3"),
    ("hits_unordered", 'SELECT "UserID" FROM hits WHERE "AdvEngineID" <> 0 '
     'LIMIT 3'),
    ("cb_q24", 'SELECT "SearchPhrase" FROM hits WHERE "SearchPhrase" <> \'\' '
     'ORDER BY to_timestamp_seconds("EventTime") LIMIT 10'),
    ("cb_q26", 'SELECT "SearchPhrase" FROM hits WHERE "SearchPhrase" <> \'\' '
     'ORDER BY to_timestamp_seconds("EventTime"), "SearchPhrase" LIMIT 10'),
]


@pytest.mark.parametrize("name,sql", ANSWERED, ids=[q[0] for q in ANSWERED])
def test_select_matches_reference(sessions, name, sql):
    jctx, tctx = sessions
    j0, t0 = jfa.STATS.get("fused_selects", 0), tfa.STATS["fused_selects"]
    ref = jctx.sql(sql).to_arrow()
    ours = tctx.sql(sql).to_arrow()
    assert jfa.STATS.get("fused_selects", 0) == j0 + 1, \
        f"reference left its fused select: {jfa.STATS.get('fsel_bail')}"
    assert tfa.STATS["fused_selects"] == t0 + 1
    assert ours.schema == ref.schema
    assert ours.to_pylist() == ref.to_pylist()
    if name != "empty_scan":
        assert ours.num_rows > 0


def test_ties_at_the_cut_keep_the_lowest_row_ids(sessions):
    """The rows tied at the LIMIT cut are the lowest row ids among the
    tied ones, as `jax.lax.top_k` picks them."""
    _, tctx = sessions
    out = tctx.sql("SELECT u, o FROM t ORDER BY o LIMIT 10").to_arrow()
    table = tctx._tables["t"]
    o = np.concatenate([table.cache.get(table.ensure_cached(rg, "o")[b])
                        .to_numpy() for rg in range(table.num_row_groups)
                        for b in range(table.num_batches(rg))])
    order = np.argsort(o, kind="stable")[:10]
    assert out.column("o").to_pylist() == o[order].tolist()
    tied = o[order[-1]]
    assert (o[order] == tied).sum() < (o == tied).sum()  # a cut inside ties


#: (name, sql): the k-th row ties the reference's fetch boundary
#: (k2 = 104), where the reference goes to its classic path; the port's
#: fetch of the cap holds the tie and answers as the classic path does
#: (both sort stably)
BOUNDARY_TIES = [
    ("one_key", "SELECT u, o2 FROM t WHERE x < 5 ORDER BY o2 LIMIT 10"),
    ("two_keys", "SELECT u, o2, s FROM t ORDER BY o2 DESC, s, u LIMIT 12"),
]


@pytest.mark.parametrize("name,sql", BOUNDARY_TIES,
                         ids=[q[0] for q in BOUNDARY_TIES])
def test_boundary_tie_selects_again_at_the_cap(sessions, name, sql):
    jctx, tctx = sessions
    j0, t0 = jfa.STATS.get("fused_selects", 0), tfa.STATS["fused_selects"]
    ref = jctx.sql(sql).to_arrow()
    assert jfa.STATS.get("fused_selects", 0) == j0  # the reference: classic
    ours = tctx.sql(sql).to_arrow()
    assert tfa.STATS["fused_selects"] == t0 + 1
    assert ours.schema == ref.schema
    assert ours.to_pylist() == ref.to_pylist()


#: (name, sql, what the NotImplementedError names)
REFUSED = [
    ("boundary_tie", "SELECT u FROM t ORDER BY c LIMIT 10",
     "tie at the fetched boundary"),
    ("nan_order_key", "SELECT u FROM t ORDER BY f LIMIT 10", "NaN order key"),
    ("nullable_order_key", "SELECT u FROM t ORDER BY nn LIMIT 10",
     "nullable order key"),
    ("unordered_too_large", "SELECT u FROM t WHERE x > 0",
     "unordered scan of"),
    ("star", "SELECT * FROM t ORDER BY o LIMIT 3", "SELECT \\*"),
    ("distinct", "SELECT DISTINCT x FROM t LIMIT 3", "SELECT DISTINCT"),
    ("nulls_placement", "SELECT u FROM t ORDER BY o NULLS FIRST LIMIT 3",
     "NULLS FIRST"),
    ("limit_too_large", "SELECT u FROM t ORDER BY o LIMIT 2000",
     "LIMIT 2000"),
]


@pytest.mark.parametrize("name,sql,names", REFUSED,
                         ids=[q[0] for q in REFUSED])
def test_refused_shapes_raise_where_the_reference_goes_classic(
        sessions, name, sql, names):
    """The fused select refuses these in both packages (the port names
    why in `last_bail`); the classic scan then answers as the
    reference's does.  Each was a raise before the classic path."""
    jctx, tctx = sessions
    j0, t0 = jfa.STATS.get("fused_selects", 0), tfa.STATS["fused_selects"]
    c0 = texec.STATS["classic_selects"]
    ref = jctx.sql(sql).to_arrow()
    assert jfa.STATS.get("fused_selects", 0) == j0
    ours = tctx.sql(sql).to_arrow()
    assert tfa.STATS["fused_selects"] == t0
    assert re.search(names, tfa.STATS["last_bail"])
    assert texec.STATS["classic_selects"] == c0 + 1
    assert_same_answer(ours, jctx, sql)
    assert ours.num_rows == ref.num_rows


def test_select_run_ranks_and_ids(monkeypatch):
    """The device step alone: ranks ascending, the lowest row ids first
    among equal ranks, in both directions."""
    p = tfa._Plan()
    n = 2 * 8192
    p.arrays = [torch.full((2, 256), -1, dtype=torch.int32),  # all live
                torch.tensor([5, 3, 3, 9, 3] + [7] * (n - 5))]
    p.rv_ix = 0
    # the order key as a "pay" column read through an identity probe
    p.colmap = {"v": {"kind": "pay", "probe": 0, "vals": 1}}
    real = tfa._Decoders

    class _Identity(real):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.probe_j = {0: torch.arange(n, dtype=torch.int32)}

    monkeypatch.setattr(tfa, "_Decoders", _Identity)
    count, idx, ranks = tfa._fused_select_run(p, [], ("col", "v", "i64"),
                                              False, 4)
    assert int(count) == n
    assert idx.tolist() == [1, 2, 4, 0]
    assert ranks.tolist() == [3.0, 3.0, 3.0, 5.0]
    _, idx, ranks = tfa._fused_select_run(p, [], ("col", "v", "i64"), True, 3)
    assert idx.tolist() == [3, 5, 6] and ranks.tolist() == [-9.0, -7.0, -7.0]
