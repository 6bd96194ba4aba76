"""TPC-H under tight memory caps through the port, on the CPU: the squeeze
and disk pipeline must engage without changing any answer.

- `tests/test_memory_pressure.py`'s two cases at the same caps (1 MB and
  16 MB at SF 0.005; 32 KB at SF 0.002), answers held against the
  reference's sessions under the same caps, each package on its own
  generator's tables (same seed);
- `memory_used` stays within the cap and the pipeline engaged;
- one case with `NoHydration` and one in `liquid-no-squeeze` mode
  (`bench/runner.make_session`);
- a fused plan or prep stack cached before a squeeze is not served after
  it: the answer after a squeeze, after a hydration, and after the
  entries are replaced with other values is the fresh one."""
import pytest

torch = pytest.importorskip("torch")

import pyarrow as pa  # noqa: E402
import pyarrow.compute as pc  # noqa: E402
import pyarrow.parquet as pq  # noqa: E402

from liquid_tpu.bench import tpch_data as jtpch  # noqa: E402
from liquid_tpu.bench.tpch_queries import QUERIES  # noqa: E402
from liquid_tpu.sql.session import LiquidCacheLocalBuilder as JBuilder  # noqa: E402
from liquid_tpu_torch.bench import oracle  # noqa: E402
from liquid_tpu_torch.bench import tpch_data as ttpch  # noqa: E402
from liquid_tpu_torch.bench.runner import make_session  # noqa: E402
from liquid_tpu_torch.cache import policies as tpol  # noqa: E402
from liquid_tpu_torch.sql import fused_agg as tfa  # noqa: E402
from liquid_tpu_torch.sql.session import LiquidCacheLocalBuilder  # noqa: E402
from tests.test_torch_route_fence import assert_same_answer  # noqa: E402

#: the reference's memory-pressure subset
SUBSET = (1, 3, 6, 12, 14, 19)


def _tables(tmp_path_factory, sf, side):
    gen = jtpch if side == "j" else ttpch
    d = tmp_path_factory.mktemp(f"{side}_sf{sf}")
    paths = {}
    for name, t in gen.generate(sf).items():
        paths[name] = str(d / f"{name}.parquet")
        pq.write_table(t, paths[name], row_group_size=1 << 16)
    return paths


@pytest.fixture(scope="module")
def sf005(tmp_path_factory):
    return (_tables(tmp_path_factory, 0.005, "j"),
            _tables(tmp_path_factory, 0.005, "t"))


@pytest.fixture(scope="module")
def sf002(tmp_path_factory):
    return (_tables(tmp_path_factory, 0.002, "j"),
            _tables(tmp_path_factory, 0.002, "t"))


def _session(paths, builder, tmp_path):
    ctx, cache = builder.with_cache_dir(str(tmp_path)).build()
    for n, p in paths.items():
        ctx.register_parquet(n, p)
    return ctx, cache


@pytest.mark.parametrize("cap_mb", [1, 16])
def test_tpch_under_memory_cap(sf005, tmp_path, cap_mb):
    jpaths, tpaths = sf005
    jctx, _ = _session(jpaths, JBuilder().with_max_memory_bytes(
        cap_mb << 20), tmp_path / "j")
    tctx, cache = _session(tpaths, LiquidCacheLocalBuilder(
        device="cpu").with_max_memory_bytes(cap_mb << 20), tmp_path / "t")
    for qid in SUBSET:
        ours = tctx.sql(QUERIES[qid]).to_arrow()
        assert ours.num_rows > 0, qid
        assert_same_answer(ours, jctx, QUERIES[qid])
        assert cache.stats()["memory_used"] <= cap_mb << 20, qid
    st = cache.stats()
    if cap_mb <= 1:  # the cap is below the working set
        assert st["squeezes"] > 0 and st["disk_writes"] > 0, st


def _lineitem_query(ctx):
    q = ("select l_returnflag, count(*) as c, sum(l_quantity) as s "
         "from lineitem group by l_returnflag order by l_returnflag")
    return ctx.sql(q).to_arrow()


@pytest.mark.parametrize("how", ["default", "NoHydration",
                                 "liquid-no-squeeze"])
def test_eviction_degrades_to_disk_not_wrong_answers(sf002, tmp_path, how):
    jpaths, tpaths = sf002
    cap = 32 << 10
    jctx, _ = _session(jpaths, JBuilder().with_max_memory_bytes(cap),
                       tmp_path / "j")
    if how == "liquid-no-squeeze":
        tctx, cache = make_session(how, cap, str(tmp_path / "t"), "cpu")
        for n, p in tpaths.items():
            tctx.register_parquet(n, p)
        assert isinstance(cache.squeeze_policy, tpol.TranscodeEvict)
    else:
        b = LiquidCacheLocalBuilder(device="cpu").with_max_memory_bytes(cap)
        tctx, cache = _session(tpaths, b, tmp_path / "t")
        if how == "NoHydration":
            cache.hydration_policy = tpol.NoHydration()
    first = _lineitem_query(tctx)
    assert oracle.same_table(first, _lineitem_query(jctx).columns)
    for _ in range(3):
        assert _lineitem_query(tctx).equals(first)
        assert cache.stats()["memory_used"] <= cap
    for qid in (6, 12):
        assert_same_answer(tctx.sql(QUERIES[qid]).to_arrow(), jctx,
                           QUERIES[qid])
    st = cache.stats()
    assert st["disk_writes"] > 0 and st["squeezes"] > 0, st
    assert st["memory_used"] <= cap
    resident = sum(st["by_state"].get(s, 0) for s in (
        "memory_arrow", "memory_liquid", "memory_squeezed"))
    assert resident < st["entries"], st["by_state"]
    if how == "liquid-no-squeeze":
        assert "memory_squeezed" not in st["by_state"]
    if how == "NoHydration":
        assert st["hydrations"] == 0


SCAN = ("SELECT sum(l_quantity) AS s, count(*) AS c FROM lineitem "
        "WHERE l_quantity < 25")


def test_cached_fused_state_is_not_served_after_a_squeeze(sf002, tmp_path,
                                                          monkeypatch):
    _, tpaths = sf002
    ctx, cache = _session(tpaths, LiquidCacheLocalBuilder(
        device="cpu").with_max_memory_bytes(1 << 30), tmp_path)
    builds = []
    real = tfa._prep_column

    def counted(*a):
        builds.append(1)
        return real(*a)
    monkeypatch.setattr(tfa, "_prep_column", counted)

    def run():
        before = tfa.STATS["fused_queries"]
        out = ctx.sql(SCAN).to_arrow()
        return out, tfa.STATS["fused_queries"] > before

    want, fused = run()
    assert fused and builds
    again, fused = run()
    assert again.equals(want) and fused
    n_builds, epoch = len(builds), cache.epoch
    # squeezed to disk: the fused route passes, the classic scan answers
    # (and hydrates the blocks it reads)
    cache.flush_all_to_disk()
    assert cache.epoch > epoch
    out, fused = run()
    assert out.equals(want) and not fused
    assert cache.stats()["hydrations"] > 0
    # hydrated: new payloads, so the preps are built again
    out, fused = run()
    assert out.equals(want) and fused and len(builds) > n_builds
    # every lineitem entry squeezed and replaced with other values under
    # the same ids: the answer follows the cache, not a stale prep
    table = ctx._tables["lineitem"]
    cache.flush_all_to_disk()
    li = pq.read_table(tpaths["lineitem"], columns=["l_quantity"]).column(0)
    bumped = pc.subtract(li, pa.scalar(1.0, li.type))
    for rg in range(table.num_row_groups):
        base = sum(table.rg_num_rows(r) for r in range(rg))
        for b in range(table.num_batches(rg)):
            lo = base + b * 8192
            cache.insert(table.entry_id(rg, "l_quantity", b),
                         bumped.slice(lo, table.batch_length(rg, b))
                         .combine_chunks())
    out, fused = run()
    keep = pc.less(bumped, 25)
    assert fused
    assert out.column("c")[0].as_py() == pc.sum(keep.cast("int64")).as_py()
    assert out.column("s")[0].as_py() == pytest.approx(
        pc.sum(pc.filter(bumped, keep)).as_py(), rel=1e-12)


def test_q19_oracle_matches_the_reference(tmp_path_factory, tmp_path):
    """The pyarrow oracle phase 6f of `chip_smoke.py` holds q19 to, on the
    port's tables, against the reference's answer on its own (SF 0.05:
    below it no row passes q19's branches)."""
    jpaths, tpaths = (_tables(tmp_path_factory, 0.05, side)
                      for side in ("j", "t"))
    jctx, _ = _session(jpaths, JBuilder().with_max_memory_bytes(1 << 30),
                       tmp_path)
    want = oracle.answers(tpaths, ["tpch_q19"])["tpch_q19"]
    ref = jctx.sql(QUERIES[19]).to_arrow()
    assert ref.num_rows == 1 and want[0][0].as_py() > 0
    assert oracle.same_table(ref, want)
