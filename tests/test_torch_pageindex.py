"""The port's page-index pruning against the JAX package's, on the CPU.

- `page_zones` (and the footer's index locations, the parsed column and
  offset indexes) equal the reference's on `tests/test_pageindex.py`'s
  gap file, exactly;
- the first scan prunes before any data-page range: through a
  `MockStore`, the byte ranges the port's scan asks for equal the
  reference's and touch no data page, with the same answer, zone prunes
  and page-index seeds;
- a selective first scan prunes one batch, with exact answers;
- a file without a page index keeps the lazy zones of the first load.
"""
import tempfile

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402
import pyarrow as pa  # noqa: E402
import pyarrow.parquet as pq  # noqa: E402

from liquid_tpu.cache.core import LiquidCacheBuilder as JCacheBuilder  # noqa: E402
from liquid_tpu.common.object_store import MockStore as JMock  # noqa: E402
from liquid_tpu.common.object_store import StoreFile as JFile  # noqa: E402
from liquid_tpu.io import pageindex as jpi  # noqa: E402
from liquid_tpu.io.parquet import ParquetTable as JTable  # noqa: E402
from liquid_tpu.sql.exec import QueryExecutor as JExec  # noqa: E402
from liquid_tpu_torch.cache.core import LiquidCacheBuilder  # noqa: E402
from liquid_tpu_torch.common.object_store import MockStore, StoreFile  # noqa: E402
from liquid_tpu_torch.io import pageindex as tpi  # noqa: E402
from liquid_tpu_torch.io.parquet import ParquetTable  # noqa: E402
from liquid_tpu_torch.sql.exec import QueryExecutor  # noqa: E402


@pytest.fixture(scope="module")
def gap_file(tmp_path_factory):
    """One row group whose x values jump 0..8191 then 100000..108191:
    the row group's stats span [0, 108191], no page holds 50000."""
    d = tmp_path_factory.mktemp("torch_pageindex")
    x = np.concatenate([np.arange(8192), np.arange(100_000, 108_192)])
    t = pa.table({"x": pa.array(x, pa.int64()),
                  "y": pa.array(np.arange(len(x), dtype=np.float64))})
    path = str(d / "gap.parquet")
    pq.write_table(t, path, row_group_size=len(x), write_page_index=True,
                   data_page_size=1, write_batch_size=4096)
    return path, t


def _session(side, path, store=None):
    """(executor, table) of one package over `path`, read through `store`
    (a MockStore) when given."""
    disk = tempfile.mktemp(suffix=".bin")
    if side == "j":
        cache = JCacheBuilder().with_disk_path(disk).build()
        open_file = (lambda: JFile(store, "gap.parquet")) if store else None
        table = JTable("gap", path, cache, 0, open_file=open_file)
        return JExec({"gap": table}), table
    cache = (LiquidCacheBuilder().with_device("cpu").with_disk_path(disk)
             .build())
    open_file = (lambda: StoreFile(store, "gap.parquet")) if store else None
    table = ParquetTable("gap", path, cache, 0, open_file=open_file)
    return QueryExecutor({"gap": table}, device="cpu"), table


def test_page_zones_equal_the_reference(gap_file):
    path, _t = gap_file
    md = pq.ParquetFile(path).metadata
    n = md.row_group(0).num_rows
    for ci, phys in ((0, "INT64"), (1, "DOUBLE")):
        got = tpi.PageIndexReader(path).page_zones(0, ci, phys, n)
        assert got == jpi.PageIndexReader(path).page_zones(0, ci, phys, n)
    zones = tpi.PageIndexReader(path).page_zones(0, 0, "INT64", n)
    assert len(zones) >= 2 and zones[0][2] == 0 and zones[-1][3] == 108_191
    assert all(not (lo <= 50_000 <= hi) for _, _, lo, hi in zones)
    footer = tpi.read_footer(path)
    assert footer == jpi.read_footer(path)
    tl, jl = (m.parse_footer_index_locs(footer) for m in (tpi, jpi))
    assert [[(c.ci_off, c.ci_len, c.oi_off, c.oi_len) for c in rg]
            for rg in tl] == [[(c.ci_off, c.ci_len, c.oi_off, c.oi_len)
                               for c in rg] for rg in jl]
    loc = tl[0][0]
    with open(path, "rb") as f:
        f.seek(loc.ci_off)
        ci_buf = f.read(loc.ci_len)
        f.seek(loc.oi_off)
        oi_buf = f.read(loc.oi_len)
    assert tpi.parse_column_index(ci_buf) == jpi.parse_column_index(ci_buf)
    assert tpi.parse_offset_index(oi_buf) == jpi.parse_offset_index(oi_buf)
    for raw, phys in ((b"\x01\x00\x00\x00", "INT32"), (b"\x00" * 8, "DOUBLE"),
                      (b"abc", "BYTE_ARRAY"), (b"\x01", "INT64")):
        assert tpi.decode_stat(raw, phys) == jpi.decode_stat(raw, phys)


def test_first_scan_prunes_before_data_io(gap_file):
    """`x = 50000` passes the row group's stats but every batch's zone
    (from the page index) disproves it: the first scan reads no data
    page, and asks the store for the reference's ranges."""
    path, _t = gap_file
    data = open(path, "rb").read()
    md = pq.ParquetFile(path).metadata
    cc = md.row_group(0).column(0)
    data_start = min(cc.data_page_offset,
                     cc.dictionary_page_offset or cc.data_page_offset)
    data_end = (data_start + cc.total_compressed_size
                + md.row_group(0).column(1).total_compressed_size)
    seen = {}
    for side, Mock in (("j", JMock), ("t", MockStore)):
        store = Mock({"gap.parquet": data})
        ex, table = _session(side, path, store)
        before = len(store.get_access_ranges("gap.parquet"))
        out = ex.execute_sql("select count(*) as c from gap where x = 50000")
        new = store.get_access_ranges("gap.parquet")[before:]
        seen[side] = (out.column("c").to_pylist(), table.zone_prunes,
                      table.pageindex_seeds, new)
    assert seen["t"] == seen["j"]
    count, zone_prunes, seeds, new = seen["t"]
    assert count == [0] and zone_prunes >= 2 and seeds >= 1
    assert not [(a, b) for a, b in new if a < data_end and b > data_start]


def test_first_scan_selective_batches(gap_file):
    path, _t = gap_file
    sql = "select count(*) as c, sum(x) as s from gap where x < 5000"
    got = {}
    for side in ("j", "t"):
        ex, table = _session(side, path)
        out = ex.execute_sql(sql)
        got[side] = (out.column("c").to_pylist(), out.column("s").to_pylist(),
                     table.zone_prunes, table.pageindex_seeds)
    assert got["t"] == got["j"]
    assert got["t"][:2] == ([5000], [sum(range(5000))])
    assert got["t"][2] >= 1 and got["t"][3] >= 1


def test_lazy_zones_still_work(tmp_path):
    """Without a page index the zones come from the first load and prune
    the later scans, as in the reference."""
    x = np.concatenate([np.zeros(8192), np.full(8192, 10_000)])
    path = str(tmp_path / "noindex.parquet")
    pq.write_table(pa.table({"x": pa.array(x, pa.int64())}), path,
                   row_group_size=len(x), write_page_index=False)
    assert tpi.PageIndexReader(path).page_zones(0, 0, "INT64", len(x)) is None
    got = {}
    for side in ("j", "t"):
        ex, table = _session(side, path)
        a = ex.execute_sql("select count(*) as c from gap where x = 10000")
        b = ex.execute_sql("select count(*) as c from gap where x = 5")
        got[side] = (a.column("c").to_pylist(), b.column("c").to_pylist(),
                     table.zone_prunes, table.pageindex_seeds)
    assert got["t"] == got["j"]
    assert got["t"][:2] == ([8192], [0]) and got["t"][2] >= 1
    assert got["t"][3] == 0
