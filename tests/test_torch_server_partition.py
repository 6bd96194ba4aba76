"""The port's partition-parallel, streaming server execution on the CPU.

The cases of `tests/test_server_partition.py` (a partition executes only
its own row groups, one at a time, and the partitions' union is the full
answer), the row-group split and the scan shapes held to the JAX
package's `LiquidCacheServiceInner`, and the three hazards of a row-group
slice that shares its base table's memos:
- the union of the partitions equals the full scan, on the fused and
  the classic routes;
- a full-table aggregate after the partitions, and after an aggregate
  run through a slice, still equals pyarrow (a plan made over one row
  group must not answer for the table);
- four concurrent partition streams, five rounds, give the serial run's
  answer and counters (route counts and K1 launches counted as the card
  counts them).
"""
import threading

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402
import pyarrow as pa  # noqa: E402
import pyarrow.compute as pc  # noqa: E402
import pyarrow.parquet as pq  # noqa: E402

from liquid_tpu_torch.cache.core import LiquidCacheBuilder  # noqa: E402
from liquid_tpu_torch.ops import bitpack_cuda as k1  # noqa: E402
from liquid_tpu_torch.server import flight as tflight  # noqa: E402
from liquid_tpu_torch.server.client import (  # noqa: E402
    LiquidCacheClientBuilder,
)
from liquid_tpu_torch.server.flight import (  # noqa: E402
    LiquidCacheService, LiquidCacheServiceInner, _RowGroupSlice,
)
from liquid_tpu_torch.sql import exec as texec  # noqa: E402
from liquid_tpu_torch.sql import fused_agg  # noqa: E402
from liquid_tpu_torch.sql.exec import QueryExecutor  # noqa: E402

ROWS_PER_RG = 8192
SCAN = "SELECT rg, v FROM part WHERE v < 900"
#: a row group's share of it fits the fused select's unordered fetch
#: (`fused_agg.SELECT_K_CAP`), the whole table's does not
NARROW = "SELECT rg, v FROM part WHERE v < 300"


def _make_file(tmp, n_rg=4, name="part"):
    rng = np.random.default_rng(3)
    n = ROWS_PER_RG * n_rg
    t = pa.table({
        "rg": pa.array(np.repeat(np.arange(n_rg), ROWS_PER_RG)
                       .astype(np.int32)),
        "v": pa.array(rng.integers(0, 1000, n)),
        "w": pa.array(np.round(rng.normal(10, 3, n), 2)),
    })
    path = f"{tmp}/{name}.parquet"
    pq.write_table(t, path, row_group_size=ROWS_PER_RG)
    return path, t


@pytest.fixture(scope="module")
def part_file(tmp_path_factory):
    return _make_file(tmp_path_factory.mktemp("part"))


def _cache(tmp, transcode=True):
    return (LiquidCacheBuilder().with_device("cpu")
            .with_transcode_on_insert(transcode)
            .with_disk_path(f"{tmp}/store.bin").build())


def _inner(tmp, path, sql=SCAN, partitions=2, transcode=True):
    cache = _cache(tmp, transcode)
    inner = LiquidCacheServiceInner(cache)
    inner.register_plan(sql, "h1", {"part": path}, partitions=partitions)
    return inner, cache


def _sorted_rows(t: pa.Table):
    return sorted(zip(*(t.column(c).to_pylist() for c in t.column_names)))


def _expect(t, limit=900):
    return t.filter(pc.less(t["v"], limit)).select(["rg", "v"])


# -- the reference's cases ---------------------------------------------------------

def test_partitions_scan_disjoint_row_groups(part_file, tmp_path):
    path, t = part_file
    inner, _cache_ = _inner(tmp_path, path)
    p0 = inner.execute_partition("h1", 0)
    p1 = inner.execute_partition("h1", 1)
    # each partition produced only its own row groups' rows
    assert set(p0.column("rg").to_pylist()) == {0, 1}
    assert set(p1.column("rg").to_pylist()) == {2, 3}
    assert _sorted_rows(pa.concat_tables([p0, p1])) == _sorted_rows(
        _expect(t))


def test_partition_executes_only_its_row_groups_io(part_file, tmp_path):
    """Executing partition 0 neither reads nor caches partition 1's data."""
    path, _t = part_file
    inner, cache = _inner(tmp_path, path)
    inner.execute_partition("h1", 0)
    ins_after_p0 = cache.stats()["inserts"]
    base = inner.ctx._tables["part"]
    cached = {rg for rg in range(4) for c in ("rg", "v")
              if cache.contains(base.entry_id(rg, c, 0))}
    assert cached == {0, 1}
    inner.execute_partition("h1", 1)
    assert cache.stats()["inserts"] == 2 * ins_after_p0


def test_streaming_yields_before_later_row_groups_execute(part_file,
                                                          tmp_path):
    path, _t = part_file
    inner, cache = _inner(tmp_path, path, "SELECT rg, v FROM part", 1)
    gen = inner.execute_partition_stream("h1", 0)
    first = next(gen)
    ins_first = cache.stats()["inserts"]
    rest = list(gen)
    ins_all = cache.stats()["inserts"]
    # the first row group's rows arrived before the later ones were read
    assert set(first.column("rg").to_pylist()) == {0}
    assert ins_all == 4 * ins_first
    assert [set(r.column("rg").to_pylist()) for r in rest] == [{1}, {2}, {3}]


def test_flight_partitions_end_to_end(part_file, tmp_path):
    path, t = part_file
    svc = LiquidCacheService(_cache(tmp_path))
    host, port = svc.start()
    try:
        client = (LiquidCacheClientBuilder().with_server(host, port)
                  .with_parquet_table("part", path)
                  .with_partitions(2).build())
        out = client.sql("SELECT rg, v FROM part WHERE v >= 100")
        want = t.filter(pc.greater_equal(t["v"], 100)).select(["rg", "v"])
        assert _sorted_rows(out) == _sorted_rows(want)
        assert client.last_metrics.rows == want.num_rows
        # an aggregate does not decompose by row group: it comes back whole
        agg = client.sql("SELECT rg, count(*) c, sum(v) s FROM part "
                         "GROUP BY rg ORDER BY rg")
        g = t.group_by("rg").aggregate([("v", "count"), ("v", "sum")]) \
            .sort_by("rg")
        assert agg.column("c").to_pylist() == g["v_count"].to_pylist()
        assert agg.column("s").to_pylist() == g["v_sum"].to_pylist()
    finally:
        svc.stop()


# -- held to the reference's service ------------------------------------------------

class _Rgs:
    def __init__(self, n):
        self.num_row_groups = n


@pytest.mark.parametrize("nrg", [0, 1, 2, 3, 4, 7, 8, 13])
def test_partition_row_groups_equal_the_reference(nrg, tmp_path):
    from liquid_tpu.cache.core import LiquidCacheBuilder as JCacheBuilder
    from liquid_tpu.server.flight import LiquidCacheServiceInner as JInner
    jinner = JInner(JCacheBuilder().with_disk_path(
        str(tmp_path / "j.bin")).build())
    tinner = LiquidCacheServiceInner(_cache(tmp_path))
    for n in (1, 2, 3, 4, 5, 8):
        for p in range(n):
            assert tinner._partition_rgs(_Rgs(nrg), p, n) == \
                jinner._partition_rgs(_Rgs(nrg), p, n), (nrg, n, p)


SHAPES = [
    "SELECT rg, v FROM part WHERE v < 900",
    "SELECT * FROM part",
    "SELECT v + 1 AS x FROM part WHERE w > 10 AND rg <> 2",
    "SELECT count(*) FROM part",
    "SELECT rg, sum(v) FROM part GROUP BY rg",
    "SELECT v FROM part ORDER BY v",
    "SELECT v FROM part LIMIT 5",
    "SELECT DISTINCT rg FROM part",
    "SELECT v FROM part WHERE v IN (SELECT v FROM part WHERE rg = 1)",
    "SELECT v, (SELECT max(v) FROM part) AS m FROM part",
    "SELECT v, row_number() OVER (ORDER BY v) AS r FROM part",
    "WITH c AS (SELECT v FROM part) SELECT v FROM c",
    "SELECT v FROM part UNION ALL SELECT v FROM part",
    "SELECT a.v FROM part a, part b WHERE a.rg = b.rg",
    "SELECT v FROM other",
    "SELEC nonsense",
]


@pytest.mark.parametrize("sql", SHAPES)
def test_partitionable_scan_equals_the_reference(sql):
    from liquid_tpu.server.flight import _partitionable_scan as jscan
    tables = {"part": object()}
    assert tflight._partitionable_scan(sql, tables) == jscan(sql, tables)


# -- a slice shares its base's memos --------------------------------------------------

@pytest.mark.parametrize("route", ["fused", "classic"])
def test_partition_union_equals_full_scan(route, part_file, tmp_path):
    path, t = part_file
    sql, limit = (NARROW, 300) if route == "fused" else (SCAN, 900)
    inner, _c = _inner(tmp_path, path, sql, partitions=4,
                       transcode=route == "fused")
    counter = (fused_agg.STATS, "fused_selects") if route == "fused" \
        else (texec.STATS, "classic_selects")
    before = counter[0][counter[1]]
    parts = [inner.execute_partition("h1", p) for p in range(4)]
    # each row group executed on the route, once
    assert counter[0][counter[1]] - before == 4
    for p, part in enumerate(parts):
        assert set(part.column("rg").to_pylist()) <= {p}
    full = inner.ctx.sql(sql).to_arrow()
    assert _sorted_rows(pa.concat_tables(parts)) == _sorted_rows(full) \
        == _sorted_rows(_expect(t, limit))


AGG = "SELECT count(*) AS c, sum(v) AS s FROM part WHERE v < 900"


def test_full_aggregate_after_partitions_equals_pyarrow(part_file, tmp_path):
    path, t = part_file
    inner, _c = _inner(tmp_path, path, partitions=4)
    for p in range(4):
        inner.execute_partition("h1", p)
    base = inner.ctx._tables["part"]
    # an aggregate through a one-row-group slice plans that row group only
    sliced = QueryExecutor({"part": _RowGroupSlice(base, [1])},
                           "cpu").execute_sql(AGG)
    one = t.filter(pc.equal(t["rg"], 1))
    assert sliced.to_pylist() == [{
        "c": pc.sum(pc.less(one["v"], 900)).as_py(),
        "s": pc.sum(one.filter(pc.less(one["v"], 900))["v"]).as_py()}]
    # ... and neither that plan nor the scans' serve the whole table
    full = inner.ctx.sql(AGG).to_arrow()
    keep = t.filter(pc.less(t["v"], 900))
    assert full.to_pylist() == [{"c": keep.num_rows,
                                 "s": pc.sum(keep["v"]).as_py()}]
    # the block-keyed memos are the base's own; the plan memo is not
    sl = _RowGroupSlice(base, [2])
    mine, its = fused_agg.table_state(sl), fused_agg.table_state(base)
    assert mine.preps is its.preps
    assert mine.rowvalid is its.rowvalid
    assert mine.plans is not its.plans and not mine.plans
    mine.plans.put("x", 1)
    assert its.plans.get("x") is None
    sl.zone_prunes = sl.zone_prunes + 0  # other writes reach the base
    assert "zone_prunes" not in sl.__dict__


def _numeric(d):
    return {k: v for k, v in d.items() if isinstance(v, int)}


def _counted_k1(monkeypatch):
    """Count K1 as the card does (one per call with planes to read): the
    CPU wrapper runs the plain version and counts nothing."""
    for name in ("in_interval_many", "cmp_const_many"):
        real = getattr(k1, name)

        def counted(planes, *a, _real=real):
            if planes.shape[0] * planes.shape[1]:
                k1.LAUNCHES["cmp_const_many"] += 1
            return _real(planes, *a)
        monkeypatch.setattr(k1, name, counted)


def _snapshot():
    return (_numeric(fused_agg.STATS), _numeric(texec.STATS),
            dict(k1.LAUNCHES))


def _delta(before, after):
    return tuple({k: a[k] - b[k] for k in a} for b, a in zip(before, after))


def test_concurrent_partition_streams_match_the_serial_run(
        part_file, tmp_path, monkeypatch):
    path, t = part_file
    _counted_k1(monkeypatch)
    svc = LiquidCacheService(_cache(tmp_path))
    host, port = svc.start()
    try:
        client = (LiquidCacheClientBuilder(host, port)
                  .with_parquet_table("part", path)
                  .with_partitions(4).build())
        client.sql(NARROW)  # read and transcode every row group once
        handle = client._handles[NARROW]
        s0 = _snapshot()
        serial = pa.concat_tables([svc.inner.execute_partition(handle, p)
                                   for p in range(4)])
        want = _delta(s0, _snapshot())
        assert want[0]["fused_selects"] == 4
        assert want[2]["cmp_const_many"] > 0
        assert _sorted_rows(serial) == _sorted_rows(_expect(t, 300))
        for _ in range(5):
            s0 = _snapshot()
            out = client.sql(NARROW)
            assert _delta(s0, _snapshot()) == want
            assert _sorted_rows(out) == _sorted_rows(serial)
            assert client.last_metrics.batches >= 4
    finally:
        svc.stop()


def test_concurrent_streams_interleave_on_their_own_threads(part_file,
                                                            tmp_path):
    """The four streams run at once on the server's threads; the engine
    lock lets one row group execute at a time."""
    path, _t = part_file
    inner, _c = _inner(tmp_path, path, partitions=4)
    active, peak, lock = [0], [0], threading.Lock()
    real = inner._execute_slice

    def watched(*a):
        with lock:
            active[0] += 1
            peak[0] = max(peak[0], active[0])
        try:
            return real(*a)
        finally:
            with lock:
                active[0] -= 1
    inner._execute_slice = watched
    gate = threading.Barrier(4)
    outs = [None] * 4

    def run(p):
        gate.wait()
        outs[p] = inner.execute_partition("h1", p)
    threads = [threading.Thread(target=run, args=(p,)) for p in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert peak[0] >= 2  # the streams were in flight together
    assert not inner._engine.locked()
    assert [set(o.column("rg").to_pylist()) for o in outs] == \
        [{0}, {1}, {2}, {3}]
