"""The port's string encodings and string SQL against the JAX package's,
both on the CPU.

- FSST: the same values give the same symbol table and compressed bytes
  in both packages (the native codec has no random source), and the
  round trip returns the input.
- `prefix_verdict` equal, for every operator, on raw and FSST-backed
  dictionaries with a shared prefix.
- `LiquidByteViewArray`: codes, `to_arrow` and the packed (bits, valid)
  masks of `try_eval_predicate` bit-exact, for eq / ne / lt / lt_eq / gt
  / gt_eq / contains / not_contains / starts_with / ends_with, raw- and
  FSST-backed, with NULLs and empty strings, with and without substring
  fingerprints; `from_numpy_fields("byteview", ...)` rebuilds the JAX
  block exactly; a column's later blocks share its first compressor.
- SQL through each package's `LiquidCacheLocalBuilder` (the port on
  device "cpu") over `nano_hits.parquet`, TPC-H SF 0.01 and a small
  table with NULL strings: `cb_like`, `tpch_q1` and other string shapes
  answer the same on the fused route.  Keys, counts and integer or
  scaled-integer sums exactly, f64 results rtol 1e-12 (the packages add
  in different orders)."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402
import pyarrow as pa  # noqa: E402
import pyarrow.parquet as pq  # noqa: E402

from liquid_tpu.arrays import byteview as jbv  # noqa: E402
from liquid_tpu.arrays import fsst as jfsst  # noqa: E402
from liquid_tpu.arrays import prefixkeys as jpk  # noqa: E402
from liquid_tpu.arrays.base import Predicate as JPredicate  # noqa: E402
from liquid_tpu.cache.core import LiquidCache as JCache  # noqa: E402
from liquid_tpu.cache.expressions import SubstringSearch as JSubstr  # noqa: E402
from liquid_tpu.sql import fused_agg as jfa  # noqa: E402
from liquid_tpu.sql.session import LiquidCacheLocalBuilder as JBuilder  # noqa: E402
from liquid_tpu_torch import _native  # noqa: E402
from liquid_tpu_torch.arrays import byteview as tbv  # noqa: E402
from liquid_tpu_torch.arrays import fsst as tfsst  # noqa: E402
from liquid_tpu_torch.arrays import prefixkeys as tpk  # noqa: E402
from liquid_tpu_torch.arrays.base import Predicate  # noqa: E402
from liquid_tpu_torch.arrays.convert import from_numpy_fields  # noqa: E402
from liquid_tpu_torch.bench import tpch_data as ttpch  # noqa: E402
from liquid_tpu_torch.bench.hits import NANO_HITS  # noqa: E402
from liquid_tpu_torch.cache.core import LiquidCache  # noqa: E402
from liquid_tpu_torch.cache.expressions import SubstringSearch  # noqa: E402
from liquid_tpu_torch.device import words_to_numpy  # noqa: E402
from liquid_tpu_torch.sql import fused_agg as tfa  # noqa: E402
from liquid_tpu_torch.sql.session import LiquidCacheLocalBuilder  # noqa: E402

OPS = ("eq", "ne", "lt", "lt_eq", "gt", "gt_eq", "contains",
       "not_contains", "starts_with", "ends_with")


def _urls(n: int, seed: int, nulls: bool) -> pa.Array:
    """URL-like strings sharing a long prefix, a few duplicates, empty
    strings and (optionally) NULLs."""
    rng = np.random.default_rng(seed)
    hosts = ["yandex.ru", "google.com", "mail.ru", "ya.ru", "x"]
    vals = []
    for i in range(n):
        r = rng.random()
        if r < 0.05:
            vals.append("")
        elif nulls and r < 0.12:
            vals.append(None)
        else:
            h = hosts[int(rng.integers(len(hosts)))]
            vals.append(f"http://{h}/p{int(rng.integers(0, n // 3))}"
                        + "?q=" * int(rng.integers(0, 3)))
    return pa.array(vals, pa.string())


#: literals probing every prefix-key route: the shared prefix, inside it,
#: past it, a needle longer than 8 bytes after it, an empty needle
LITERALS = ["http://", "http://ya", "http://yandex.ru/p1", "yandex", "",
            "http://mail.ru/p12345678901", "zzz", "ht", "/p1"]


def _blocks(seed: int, nulls: bool, compress: str, fps: bool):
    arr = _urls(3000, seed, nulls)
    j = jbv.LiquidByteViewArray.from_arrow(arr, with_fingerprints=fps,
                                           compress=compress)
    t = tbv.LiquidByteViewArray.from_arrow(arr, with_fingerprints=fps,
                                           compress=compress)
    return arr, j, t


def test_native_library_builds_into_the_port():
    path = _native.build()
    assert path.startswith(_native.BUILD_DIR)
    assert _native.lib() is _native.lib()


def test_fsst_bytes_and_round_trip_match():
    arr = _urls(4000, 1, nulls=False)
    jc = jfsst.FsstCompressor.train_on_arrow(arr)
    tc = tfsst.FsstCompressor.train_on_arrow(arr)
    assert tc.to_bytes() == jc.to_bytes()
    assert tc.num_symbols == jc.num_symbols
    data, offs = tfsst._arrow_bytes(arr)
    jd, jo = jc.compress_batch(data, offs)
    td, to = tc.compress_batch(data, offs)
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_array_equal(to, jo)
    back, boffs = tc.decompress_batch(td, to, int(offs[-1]))
    np.testing.assert_array_equal(back, data)
    np.testing.assert_array_equal(boffs, offs.astype(np.uint64))
    one = b"http://yandex.ru/p42"
    assert tc.compress(one) == jc.compress(one)
    assert tc.decompress(tc.compress(one)) == one
    # a table rebuilt from its bytes compresses identically
    assert tfsst.FsstCompressor.from_bytes(jc.to_bytes()).compress(one) \
        == jc.compress(one)
    buf = tfsst.FsstBuffer.from_arrow(arr.unique(), tc)
    assert buf.to_arrow(pa.string()).equals(arr.unique())
    assert buf.take_bytes(np.array([0, 3])) == [
        arr.unique()[i].as_py().encode() for i in (0, 3)]


@pytest.mark.parametrize("with_shared", [True, False])
def test_prefix_verdict_matches(with_shared):
    vals = _urls(2000, 2, nulls=False).unique()
    jm = jpk.build_prefix_meta(vals, with_shared)
    tm = tpk.build_prefix_meta(vals, with_shared)
    assert tm.shared == jm.shared
    np.testing.assert_array_equal(tm.prefixes, jm.prefixes)
    np.testing.assert_array_equal(tm.rest_lens, jm.rest_lens)
    fps = tbv._fingerprints(vals)
    np.testing.assert_array_equal(fps, jbv._fingerprints(vals))
    for op in OPS:
        for lit in LITERALS:
            b = lit.encode()
            nfp = tbv._needle_fingerprint(b)
            assert nfp == jbv._needle_fingerprint(b)
            jv, ja = jpk.prefix_verdict(jm, op, b, fps, nfp)
            tv, ta = tpk.prefix_verdict(tm, op, b, fps, nfp)
            for got, want in ((tv, jv), (ta, ja)):
                if want is None:
                    assert got is None, (op, lit)
                else:
                    np.testing.assert_array_equal(got, want, err_msg=(op, lit))


def _assert_block_equal(t, j):
    np.testing.assert_array_equal(t.codes_np, j.codes_np)
    if j.validity_np is None:
        assert t.validity_np is None
    else:
        np.testing.assert_array_equal(t.validity_np, j.validity_np)
    assert t.is_fsst == j.is_fsst and t.dict_size == j.dict_size
    assert t.to_arrow().equals(j.to_arrow())
    assert t.to_arrow_flat().equals(j.to_arrow_flat())
    assert t.memory_bytes() == j.memory_bytes()


def _assert_masks_equal(t, j):
    for op in OPS:
        for lit in LITERALS:
            jm = j.try_eval_predicate(JPredicate(op, lit))
            tm = t.try_eval_predicate(Predicate(op, lit), "cpu")
            assert (tm is None) == (jm is None), (op, lit)
            if jm is None:
                continue
            np.testing.assert_array_equal(words_to_numpy(tm.bits),
                                          np.asarray(jm.bits),
                                          err_msg=(op, lit))
            np.testing.assert_array_equal(words_to_numpy(tm.valid),
                                          np.asarray(jm.valid),
                                          err_msg=(op, lit))


BLOCK_CASES = [("raw", False, "never", False), ("raw-nulls", True, "never",
                                                 True),
               ("fsst", False, "always", False),
               ("fsst-nulls-fps", True, "always", True)]


@pytest.mark.parametrize("name,nulls,compress,fps", BLOCK_CASES,
                         ids=[c[0] for c in BLOCK_CASES])
def test_byteview_block_matches(name, nulls, compress, fps):
    arr, j, t = _blocks(10 + len(name), nulls, compress, fps)
    assert t.length == len(arr) and t.arrow_type == j.arrow_type
    _assert_block_equal(t, j)
    codes, valid = t.to_device("cpu")
    np.testing.assert_array_equal(codes.numpy(), np.asarray(j.codes))
    assert (valid is None) == (j.validity is None)
    _assert_masks_equal(t, j)


@pytest.mark.parametrize("name,nulls,compress,fps", BLOCK_CASES,
                         ids=[c[0] for c in BLOCK_CASES])
def test_from_numpy_fields_rebuilds_the_reference_block(name, nulls,
                                                        compress, fps):
    _arr, j, _t = _blocks(20 + len(name), nulls, compress, fps)
    fields = dict(codes=j.codes_np, validity=j.validity_np, length=j.length,
                  arrow_type=j.arrow_type, fingerprints=j._fingerprints)
    if j.is_fsst:
        fields.update(fsst_table=j.fsst.compressor.to_bytes(),
                      comp_data=j.fsst.comp_data,
                      comp_offsets=j.fsst.comp_offsets,
                      uncompressed_bytes=j.fsst.uncompressed_bytes,
                      prefix_shared=j.prefix_meta.shared,
                      prefixes=j.prefix_meta.prefixes,
                      rest_lens=j.prefix_meta.rest_lens)
    else:
        fields["dictionary"] = j.dictionary
    t = from_numpy_fields("byteview", fields)
    _assert_block_equal(t, j)
    _assert_masks_equal(t, j)


def test_small_dictionary_stays_raw_and_auto_compresses_large_ones():
    small = pa.array(["a", "b", None, "a", ""] * 20)
    assert not tbv.LiquidByteViewArray.from_arrow(small).is_fsst
    big = _urls(5000, 3, nulls=True)
    t = tbv.LiquidByteViewArray.from_arrow(big)
    assert t.is_fsst == jbv.LiquidByteViewArray.from_arrow(big).is_fsst
    assert t.is_fsst
    # IPC bytes and the squeezed form are the reference's
    j = jbv.LiquidByteViewArray.from_arrow(big)
    assert t.to_bytes() == j.to_bytes()
    sq, backing = t.squeeze()
    jsq, jbacking = j.squeeze()
    assert backing == jbacking
    assert sq.memory_bytes() == jsq.memory_bytes()


def test_column_blocks_share_the_first_compressor(tmp_path):
    """Both caches train on a column's first string block and compress
    its later blocks with that table: the same bytes in both packages."""
    jc = JCache(max_memory_bytes=1 << 30,
                disk_path=str(tmp_path / "store.bin"))
    tc = LiquidCache(max_memory_bytes=1 << 30, device="cpu")
    col = (3 << 48) | (0 << 32) | (5 << 16)
    for b in range(3):
        arr = _urls(8192, 40 + b, nulls=b == 1)
        jc.insert(col | b, arr, hint=JSubstr())
        tc.insert(col | b, arr, hint=SubstringSearch())
    tblocks = [tc._entries[col | b].payload for b in range(3)]
    jblocks = [jc._entries[col | b].payload for b in range(3)]
    assert tblocks[1].fsst.compressor is tblocks[0].fsst.compressor
    assert tblocks[2].fsst.compressor is tblocks[0].fsst.compressor
    assert tc.metadata.compressor_for(col | 7) is tblocks[0].fsst.compressor
    other = (3 << 48) | (6 << 16)
    assert tc.metadata.compressor_for(other) is None
    for t, j in zip(tblocks, jblocks):
        np.testing.assert_array_equal(t.fsst.comp_data, j.fsst.comp_data)
        assert t.fingerprints is not None
        _assert_block_equal(t, j)
        assert tc.get(col) is not None


Q1 = """SELECT l_returnflag, l_linestatus, sum(l_quantity) as sum_qty,
 sum(l_extendedprice) as sum_base_price,
 sum(l_extendedprice * (1 - l_discount)) as sum_disc_price,
 sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) as sum_charge,
 avg(l_quantity) as avg_qty, avg(l_extendedprice) as avg_price,
 avg(l_discount) as avg_disc, count(*) as count_order
 FROM lineitem WHERE l_shipdate <= date '1998-09-02'
 GROUP BY l_returnflag, l_linestatus
 ORDER BY l_returnflag, l_linestatus"""

#: (name, sql): each ends in a total order
QUERIES = [
    ("cb_like", 'SELECT COUNT(*) FROM hits WHERE "URL" LIKE \'%yandex%\''),
    ("tpch_q1", Q1),
    ("eq_empty", 'SELECT COUNT(*) FROM hits WHERE "SearchPhrase" = \'\''),
    ("ne_sum", 'SELECT COUNT(*), SUM("AdvEngineID") FROM hits '
     'WHERE "SearchPhrase" <> \'\''),
    ("starts_with", 'SELECT COUNT(*) FROM hits WHERE "URL" LIKE '
     '\'http://%\''),
    ("not_like", 'SELECT COUNT(*) FROM hits WHERE "URL" NOT LIKE '
     '\'%yandex%\''),
    ("lt", 'SELECT COUNT(*) FROM hits WHERE "URL" < \'https\''),
    ("gt_eq", 'SELECT COUNT(*) FROM hits WHERE "Title" >= \'M\''),
    ("or_alternatives", 'SELECT COUNT(*) FROM hits WHERE "URL" LIKE '
     '\'%yandex%\' OR "AdvEngineID" = 2'),
    ("in_list_residual", 'SELECT COUNT(*) FROM hits WHERE "SearchPhrase" '
     'IN (\'\', \'x\') OR "AdvEngineID" + 1 = 3'),
    ("two_likes", 'SELECT COUNT(*) FROM hits WHERE "URL" LIKE '
     '\'%yandex%\' AND "Title" LIKE \'%а%\''),
    ("string_key", 'SELECT "SearchPhrase", COUNT(*) AS c FROM hits WHERE '
     '"SearchPhrase" <> \'\' GROUP BY "SearchPhrase" '
     'ORDER BY c DESC, "SearchPhrase" LIMIT 10'),
    ("string_and_int_keys", 'SELECT "MobilePhoneModel", "RegionID", '
     'COUNT(*) AS c FROM hits GROUP BY "MobilePhoneModel", "RegionID" '
     'ORDER BY c DESC, "MobilePhoneModel", "RegionID" LIMIT 10'),
    ("min_max_strings", 'SELECT MIN("URL"), MAX("URL"), COUNT("Title"), '
     'MIN("SearchPhrase") FROM hits'),
    ("grouped_min_max", 'SELECT "AdvEngineID", MIN("Title"), MAX("URL"), '
     'COUNT(*) FROM hits GROUP BY "AdvEngineID" ORDER BY "AdvEngineID"'),
    ("string_function_key", 'SELECT substring("URL", 1, 8) AS p, '
     'COUNT(*) AS c FROM hits GROUP BY substring("URL", 1, 8) '
     'ORDER BY c DESC, p LIMIT 5'),
    ("numeric_function", 'SELECT SUM(length("URL")), COUNT(*) FROM hits'),
    ("string_where_key", "SELECT l_returnflag, COUNT(*), SUM(l_quantity) "
     "FROM lineitem WHERE l_linestatus = 'F' GROUP BY l_returnflag "
     "ORDER BY l_returnflag"),
    ("string_in_key", "SELECT l_shipmode, COUNT(*) FROM lineitem WHERE "
     "l_shipmode IN ('MAIL', 'SHIP') GROUP BY l_shipmode ORDER BY "
     "l_shipmode"),
    ("null_string_key", "SELECT s, COUNT(*), COUNT(s), SUM(v) FROM t "
     "GROUP BY s ORDER BY s NULLS FIRST"),
    ("null_string_filter", "SELECT COUNT(*), MIN(s), MAX(s) FROM t "
     "WHERE s <> 'b' AND s LIKE '%a%'"),
]


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_strings")
    paths = {"hits": NANO_HITS, "lineitem": str(d / "lineitem.parquet"),
             "t": str(d / "t.parquet")}
    pq.write_table(ttpch.generate(0.01)["lineitem"], paths["lineitem"],
                   row_group_size=1 << 14)
    rng = np.random.default_rng(12)
    n = 20000
    words = np.array(["alpha", "beta", "", "gamma", "b", "delta", "zeta"])
    s = words[rng.integers(0, len(words), n)]
    pq.write_table(pa.table({
        "s": pa.array(s, mask=rng.random(n) < 0.1),
        "v": pa.array(rng.integers(-100, 100, n))}), paths["t"],
        row_group_size=1 << 13)
    jctx, _ = JBuilder().with_max_memory_bytes(1 << 30).build()
    tctx, _ = (LiquidCacheLocalBuilder(device="cpu")
               .with_max_memory_bytes(1 << 30).build())
    for name, p in paths.items():
        jctx.register_parquet(name, p)
        tctx.register_parquet(name, p)
    return jctx, tctx


def _assert_same_answer(ours: pa.Table, ref: pa.Table):
    assert ours.column_names == ref.column_names
    assert ours.num_rows == ref.num_rows
    for name in ref.column_names:
        a, b = ours.column(name), ref.column(name)
        assert a.type == b.type, (name, a.type, b.type)
        if pa.types.is_floating(a.type):
            np.testing.assert_allclose(
                np.asarray(a.to_numpy(zero_copy_only=False), float),
                np.asarray(b.to_numpy(zero_copy_only=False), float),
                rtol=1e-12, equal_nan=True)
        else:
            assert a.to_pylist() == b.to_pylist(), name


@pytest.mark.parametrize("name,sql", QUERIES, ids=[q[0] for q in QUERIES])
def test_query_matches_reference_on_fused_route(sessions, name, sql):
    jctx, tctx = sessions
    j0, t0 = jfa.STATS["fused_queries"], tfa.STATS["fused_queries"]
    ref = jctx.sql(sql).to_arrow()
    ours = tctx.sql(sql).to_arrow()
    assert jfa.STATS["fused_queries"] == j0 + 1, "reference left the route"
    assert tfa.STATS["fused_queries"] == t0 + 1, "port left the fused route"
    _assert_same_answer(ours, ref)
    # warm: the cached plan (LUTs, vocabularies, gid stacks) answers alike
    _assert_same_answer(tctx.sql(sql).to_arrow(), ours)


def test_string_ordering_in_a_residual_bails_with_its_reason(sessions):
    """The fused path names a string ordering as its reason to pass; it
    was a raise before the classic path, which now answers as the
    reference's does."""
    jctx, tctx = sessions
    sql = ('SELECT COUNT(*) FROM hits WHERE "URL" < \'b\' OR '
           '"AdvEngineID" + 1 = 3')
    ours = tctx.sql(sql).to_arrow()
    assert "string ordering" in tfa.STATS["last_bail"]
    assert ours.to_pylist() == jctx.sql(sql).to_arrow().to_pylist()
