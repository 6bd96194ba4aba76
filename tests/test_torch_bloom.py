"""The port's parquet bloom-filter pruning against the JAX package's, on
the CPU.

- XXH64 on the canonical seed-0 vectors and on lengths that reach every
  lane and tail path, equal to the reference's (exact);
- filter locations read from the footer's thrift equal pyarrow's, and a
  reader over metadata without pyarrow's location fields (older
  pyarrow) gives the same verdicts;
- `BloomReader` verdicts equal to the reference's for every probe on the
  same file (present and absent ints, int32, strings, an out-of-range
  int32, a column without a filter);
- row-group pruning end to end through a session on each package, with
  `bloom_prunes` and the SQL answers equal;
- a fully pruned scan inserts nothing, and the scan's byte ranges through
  a `MockStore` equal the reference's;
- a filter is probed only with the column's own encoding: `=` on decimal
  and float32 columns with bloom filters equals pyarrow.
"""
from decimal import Decimal

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import pyarrow as pa  # noqa: E402
import pyarrow.compute as pc  # noqa: E402
import pyarrow.parquet as pq  # noqa: E402

from liquid_tpu.arrays.base import Predicate as JPred  # noqa: E402
from liquid_tpu.common.object_store import MockStore as JMock  # noqa: E402
from liquid_tpu.common.object_store import StoreFile as JFile  # noqa: E402
from liquid_tpu.io import bloom as jbloom  # noqa: E402
from liquid_tpu.io.parquet import ParquetTable as JTable  # noqa: E402
from liquid_tpu.sql.session import LiquidCacheLocalBuilder as JBuilder  # noqa: E402
from liquid_tpu_torch.arrays.base import Predicate as TPred  # noqa: E402
from liquid_tpu_torch.common.object_store import MockStore, StoreFile  # noqa: E402
from liquid_tpu_torch.io import bloom as tbloom  # noqa: E402
from liquid_tpu_torch.sql.session import LiquidCacheLocalBuilder  # noqa: E402


def _write(tmp_path, name, table, **kw):
    p = str(tmp_path / name)
    pq.write_table(table, p, **kw)
    return p


def _sessions(tmp_path, path):
    j, _ = JBuilder().with_cache_dir(str(tmp_path / "j")).build()
    t, _ = (LiquidCacheLocalBuilder(device="cpu")
            .with_cache_dir(str(tmp_path / "t")).build())
    for ctx in (j, t):
        ctx.register_parquet("t", path)
    return j, t


def test_xxhash64_vectors():
    assert tbloom.xxhash64(b"") == 0xEF46DB3751D8E999
    assert tbloom.xxhash64(b"a") == 0xD24EC4F1A98C6E5B
    assert tbloom.xxhash64(b"abc") == 0x44BC2CF5AD770999
    for n in range(0, 130):
        data = bytes((i * 37 + n) % 256 for i in range(n))
        assert tbloom.xxhash64(data) == jbloom.xxhash64(data), n
        assert tbloom.xxhash64(data, 7) == jbloom.xxhash64(data, 7), n


def test_bloom_header_rejects_garbage():
    with pytest.raises((ValueError, IndexError)):
        tbloom.parse_bloom_header(b"\xff\xff\xff\xff\xff\xff")


def test_bloom_reader_verdicts_equal_the_reference(tmp_path):
    ints = list(range(0, 4000, 4))
    strs = [f"val_{i:06d}_{'x' * (i % 37)}" for i in range(1000)]
    t = pa.table({"k": pa.array(ints, pa.int64()),
                  "k32": pa.array([i % 2**31 for i in ints], pa.int32()),
                  "s": strs, "plain": pa.array(ints, pa.int64())})
    p = _write(tmp_path, "b.parquet", t,
               bloom_filter_options={"k": True, "k32": True, "s": True})
    md = pq.ParquetFile(p).metadata
    jr, tr = jbloom.BloomReader(p, md), tbloom.BloomReader(p, md)
    probes = ([(0, v, "INT64") for v in range(0, 4000, 3)]
              + [(1, v, "INT32") for v in range(0, 4000, 3)]
              + [(1, 2**40, "INT32"), (0, 2**70, "INT64"), (0, True, "INT64"),
                 (0, None, "INT64"), (3, 4, "INT64")]
              + [(2, s, "BYTE_ARRAY") for s in strs[::7]]
              + [(2, f"nope_{i}", "BYTE_ARRAY") for i in range(200)])
    got = [tr.might_contain(0, ci, v, ph) for ci, v, ph in probes]
    want = [jr.might_contain(0, ci, v, ph) for ci, v, ph in probes]
    assert got == want
    # every written value probes True (hash, header and filter agree with
    # Arrow C++'s writer)
    assert all(tr.might_contain(0, 0, v, "INT64") for v in ints)
    assert all(tr.might_contain(0, 2, s, "BYTE_ARRAY") for s in strs)
    assert tr.might_contain(0, 1, 2**40, "INT32") is False
    assert tr.might_contain(0, 3, 4, "INT64") is None  # no filter


class _NoBloomAttrs:
    """Parquet metadata as an older pyarrow shows it: column chunks
    without `bloom_filter_offset` / `bloom_filter_length`."""

    def __init__(self, md):
        self._md = md

    def row_group(self, rg):
        md = self._md

        class _RG:
            def column(self, ci):
                col = md.row_group(rg).column(ci)
                return type("Col", (), {"physical_type": col.physical_type})()
        return _RG()


def test_footer_bloom_locations_equal_pyarrows(tmp_path):
    """The footer's thrift gives every chunk's filter location as pyarrow
    reports it, and a reader without pyarrow's fields gives the same
    verdicts."""
    ints = list(range(0, 6000, 3))
    t = pa.table({"a": pa.array(ints, pa.int64()),
                  "s": [f"v{i}" for i in ints],
                  "b": pa.array(ints, pa.int32())})
    p = _write(tmp_path, "locs.parquet", t, row_group_size=700,
               bloom_filter_options={"a": True, "s": True})
    md = pq.ParquetFile(p).metadata
    locs = tbloom.parse_footer_bloom_locs(tbloom.read_footer(p))
    want = [[None if md.row_group(rg).column(ci).bloom_filter_offset is None
             else (md.row_group(rg).column(ci).bloom_filter_offset,
                   md.row_group(rg).column(ci).bloom_filter_length)
             for ci in range(3)] for rg in range(md.num_row_groups)]
    assert locs == want and locs[0][0] is not None and locs[0][2] is None
    plain, footer = tbloom.BloomReader(p, md), tbloom.BloomReader(
        p, _NoBloomAttrs(md))
    for rg in range(md.num_row_groups):
        for ci, phys, probes in ((0, "INT64", range(0, 200)),
                                 (1, "BYTE_ARRAY", [f"v{i}" for i in
                                                    range(0, 200)]),
                                 (2, "INT32", range(3))):
            for v in probes:
                assert footer.might_contain(rg, ci, v, phys) == \
                    plain.might_contain(rg, ci, v, phys)


def test_row_group_pruning_end_to_end(tmp_path):
    """rg0 holds the even keys, rg1 the odd ones: min/max cannot separate
    them, the bloom filters do, alike in both packages."""
    evens, odds = list(range(0, 1000, 2)), list(range(1, 1000, 2))
    t = pa.table({
        "k": pa.array(evens + odds, pa.int64()),
        "tag": pa.array(["e"] * len(evens) + ["o"] * len(odds)),
        "v": pa.array(list(range(len(evens) + len(odds))), pa.int64()),
    })
    p = _write(tmp_path, "two_rg.parquet", t, row_group_size=500,
               bloom_filter_options={"k": True, "tag": True})
    j, tt = _sessions(tmp_path, p)
    jt, pt = j._tables["t"], tt._tables["t"]
    for col, op, lit in (("k", "eq", 2), ("k", "eq", 3), ("tag", "eq", "e"),
                         ("tag", "eq", "zz"), ("k", "gt", 0),
                         ("k", "eq", 5001)):
        assert pt.prune_row_groups([(col, TPred(op, lit))]) == \
            jt.prune_row_groups([(col, JPred(op, lit))])
    assert pt.bloom_prunes == jt.bloom_prunes >= 2
    assert pt.prune_row_groups([("k", TPred("eq", 2))]) == [0]
    assert pt.prune_row_groups([("k", TPred("eq", 3))]) == [1]
    assert pt.prune_row_groups([("tag", TPred("eq", "e"))]) == [0]
    pt.bloom_prunes = jt.bloom_prunes = 0
    for sql in ("SELECT v FROM t WHERE k = 3",
                "SELECT count(*) FROM t WHERE tag = 'zz'",
                "SELECT sum(v) FROM t WHERE k = 998"):
        assert tt.sql(sql).to_arrow().to_pylist() == \
            j.sql(sql).to_arrow().to_pylist()
    assert pt.bloom_prunes == jt.bloom_prunes


def test_bloom_pruning_skips_io(tmp_path):
    """A query whose literal every bloom filter rules out inserts nothing
    and reads no column chunk: the ranges it asks a MockStore for are the
    reference's (the footer only)."""
    t = pa.table({"k": pa.array([10, 20, 30] * 100, pa.int64()),
                  "v": pa.array(range(300), pa.int64())})
    p = _write(tmp_path, "skip.parquet", t, bloom_filter_options={"k": True})
    j, tt = _sessions(tmp_path, p)
    sql = "SELECT sum(v) FROM t WHERE k = 11"
    assert tt.sql(sql).to_arrow().column(0).to_pylist() in ([None], [0])
    assert tt.cache.stats()["inserts"] == 0
    data = open(p, "rb").read()
    ranges = []
    for side, Mock, File in (("j", JMock, JFile), ("t", MockStore, StoreFile)):
        store = Mock({"skip.parquet": data})
        ctx = j if side == "j" else tt
        if side == "j":
            ctx._tables["s"] = JTable("s", "skip.parquet", ctx.cache, 9,
                                      open_file=lambda: File(store,
                                                             "skip.parquet"))
        else:
            ctx.register_parquet("s", "skip.parquet", open_file=lambda: File(
                store, "skip.parquet"))
        before = len(store.get_access_ranges("skip.parquet"))
        out = ctx.sql("SELECT sum(v) FROM s WHERE k = 11").to_arrow()
        assert out.column(0).to_pylist() in ([None], [0])
        ranges.append(store.get_access_ranges("skip.parquet")[before:])
    assert ranges[0] == ranges[1]
    md = pq.ParquetFile(p).metadata
    chunk = md.row_group(0).column(1)
    lo = chunk.dictionary_page_offset or chunk.data_page_offset
    hi = lo + chunk.total_compressed_size
    assert not [r for r in ranges[1] if r[0] < hi and r[1] > lo]


@pytest.mark.parametrize("as_integer", [False, True],
                         ids=["fixed_len", "integer_stored"])
def test_bloom_probe_only_in_the_columns_own_encoding(tmp_path, as_integer):
    """Bloom filters on DECIMAL(15,2) columns (fixed-length bytes or
    unscaled integers), a float32 column and a float64 column holding -0:
    `=` answers equal pyarrow's count (exact).  A decimal hashes its
    unscaled bytes and a float32 its 4-byte value, so a float or int
    literal is never probed there; the reference probes them and answers
    0 (ROADMAP Queue 3).  A float64 literal absent from the file still
    prunes."""
    rng = np.random.default_rng(3)
    disc, qty = rng.integers(0, 11, 4000), rng.integers(1, 51, 4000)
    t = pa.table({
        "disc": pa.array([Decimal(int(x)).scaleb(-2) for x in disc],
                         pa.decimal128(15, 2)),
        "qty": pa.array([Decimal(int(x)) for x in qty], pa.decimal128(15, 2)),
        "f32": pa.array(disc.astype(np.float32) / 4, pa.float32()),
        "neg": pa.array(-(disc / 4.0), pa.float64()),
        "i": pa.array(qty, pa.int64()),
    })
    p = _write(tmp_path, "dec.parquet", t, row_group_size=1000,
               store_decimal_as_integer=as_integer,
               bloom_filter_options={c: True for c in t.column_names})
    assert pq.ParquetFile(p).metadata.row_group(0).column(0).physical_type \
        == ("INT64" if as_integer else "FIXED_LEN_BYTE_ARRAY")
    tt, _ = (LiquidCacheLocalBuilder(device="cpu")
             .with_cache_dir(str(tmp_path / "t")).build())
    tt.register_parquet("t", p)
    cases = (("disc", "=", 0.05, Decimal("0.05")),
             ("disc", "=", 0.1, Decimal("0.10")),
             ("disc", ">=", 0.1, Decimal("0.10")),
             ("qty", "=", 24, Decimal(24)), ("qty", "=", 50, Decimal(50)),
             ("f32", "=", 0.25, 0.25), ("f32", "=", 2, 2.0),
             ("neg", "=", 0.0, 0.0), ("neg", "=", -0.5, -0.5),
             ("i", "=", 24.0, 24))
    for col, op, lit, arrow_lit in cases:
        cmp = pc.equal if op == "=" else pc.greater_equal
        want = pc.sum(cmp(t[col], pa.scalar(arrow_lit, t[col].type))).as_py()
        got = tt.sql(f"SELECT count(*) FROM t WHERE {col} {op} {lit}"
                     ).to_arrow().column(0).to_pylist()
        assert got == [want] and want > 0, (col, op, lit)
    assert tt._tables["t"].bloom_prunes == 0
    assert tt.sql("SELECT count(*) FROM t WHERE neg = -1.3").to_arrow() \
        .column(0).to_pylist() == [0]
    assert tt._tables["t"].bloom_prunes == 4
