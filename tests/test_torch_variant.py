"""The port's variant (JSON) columns against the JAX package's, on the CPU.

Every case of `tests/test_variant.py` runs on both packages and compares
them, exactly:
- paths: `parse_path`, typed extraction, type mismatches as NULL,
  untyped subtrees as JSON, `contains_path_docs`;
- shredded blocks: the same (path, type) keys, each block's Liquid IPC
  bytes equal to the reference's, zero-IO reads of resident paths, one
  read for another, the full column from disk; `merged_with`;
- hints: the vote's union of variant paths, the planner's
  `column_hints`;
- the cache: squeeze and zero-IO path reads, the merge of a new path,
  full reads after a squeeze, squeezed to disk and back, and eviction
  under pressure, with event traces equal to the reference's;
- SQL: `variant_get` (select, aggregate, filter), answers served from
  the shredded paths after a squeeze (`squeeze_io_saved` grows, no
  read), `variant_pretty` and `variant_to_json`;
- the five JSONBench queries on 20,000 events: uncapped, equal to the
  reference's answers and to a `json` + `collections.Counter` oracle;
  capped so that the blocks shred, equal to the oracle with reads served
  from the shredded paths (the reference raises there: it cannot
  concatenate shredded and JSON blocks); the port's event generator
  equals `benchmark/json_bench/generate.py`'s draw for draw.
"""
import json
import os
import shutil
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402
import pyarrow as pa  # noqa: E402
import pyarrow.parquet as pq  # noqa: E402

from liquid_tpu.arrays import variant as jv  # noqa: E402
from liquid_tpu.cache import LiquidCacheBuilder as JCacheBuilder  # noqa: E402
from liquid_tpu.cache import expressions as jexpr  # noqa: E402
from liquid_tpu.sql import planner as jplan  # noqa: E402
from liquid_tpu.sql.parser import parse_statement as jparse  # noqa: E402
from liquid_tpu.sql.session import LiquidCacheLocalBuilder as JBuilder  # noqa: E402
from liquid_tpu_torch.arrays import variant as tv  # noqa: E402
from liquid_tpu_torch.bench import json_bench  # noqa: E402
from liquid_tpu_torch.cache import expressions as texpr  # noqa: E402
from liquid_tpu_torch.cache.core import LiquidCacheBuilder  # noqa: E402
from liquid_tpu_torch.sql import planner as tplan  # noqa: E402
from liquid_tpu_torch.sql.parser import parse_statement as tparse  # noqa: E402
from liquid_tpu_torch.sql.session import LiquidCacheLocalBuilder  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def make_json_column(n=100, seed=0):
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        doc = {"user": {"id": int(rng.integers(0, 1000)),
                        "name": f"user{i}"},
               "score": float(rng.random()) if i % 3 else int(i),
               "tags": [f"t{i % 5}", f"t{i % 7}"],
               "flag": bool(i % 2)}
        if i % 10 == 0:
            del doc["score"]
        rows.append(json.dumps(doc))
    if n > 5:
        rows[5] = None
    return pa.array(rows, type=pa.string())


def _struct_lists(st):
    return [(st.type.field(i).name, st.field(i).to_pylist())
            for i in range(st.type.num_fields)]


# -- paths -----------------------------------------------------------------

def test_parse_path():
    for p in ("a.b.c", "$.a[0].c", "tags[1]", "$a", "x[12].y[3]"):
        assert tv.parse_path(p) == jv.parse_path(p)
    assert tv.parse_path("$.a[0].c") == ("a", 0, "c")


REQUESTS = [("user.id", "int64"), ("user.name", "utf8"), ("flag", "bool"),
            ("tags[0]", "utf8"), ("score", "float64"), ("user", "variant"),
            ("tags[-1]", "utf8"), ("missing.path", "int64")]


def test_extract_typed_paths():
    arr = make_json_column(30)
    got = _struct_lists(tv.extract_paths(tv.parse_docs(arr), REQUESTS))
    assert got == _struct_lists(jv.extract_paths(jv.parse_docs(arr),
                                                 REQUESTS))
    assert got[1][1][0] == "user0" and got[3][1][0] == "t0"


def test_type_mismatch_is_null():
    arr = pa.array([json.dumps({"x": "str"}), json.dumps({"x": 3}),
                    json.dumps({"x": 1.5}), json.dumps({"x": True}),
                    "not json"])
    reqs = [("x", "int64"), ("x", "utf8"), ("x", "float64"), ("x", "bool")]
    got = _struct_lists(tv.extract_paths(tv.parse_docs(arr), reqs))
    assert got == _struct_lists(jv.extract_paths(jv.parse_docs(arr), reqs))
    assert got[0][1] == [None, 3, None, None, None]


def test_untyped_variant_returns_json():
    arr = pa.array([json.dumps({"a": {"b": [1, 2]}})])
    st = tv.extract_paths(tv.parse_docs(arr), [("a", "variant")])
    assert json.loads(st.field(0)[0].as_py()) == {"b": [1, 2]}


def test_contains_path():
    arr = pa.array([json.dumps({"a": 1}), json.dumps({"b": 2}),
                    json.dumps({"a": None}), None,
                    json.dumps({"a": [1, {"c": 2}]})])
    for path in ("a", "b", "a[1].c", "a[5]", "z"):
        assert tv.contains_path_docs(tv.parse_docs(arr), path).to_pylist() \
            == jv.contains_path_docs(jv.parse_docs(arr), path).to_pylist()
    assert tv.contains_path_docs(tv.parse_docs(arr), "a").to_pylist() == [
        True, False, True, None, True]


# -- shred / squeeze --------------------------------------------------------

class _MemIo:
    def __init__(self, data: bytes):
        self.data = data
        self.reads = 0

    def read(self, rng):
        self.reads += 1
        if rng is None:
            return self.data
        off, ln = rng
        return self.data[off:off + ln]


def test_shred_variant_roundtrip():
    arr = make_json_column(64)
    reqs = [("user.id", "int64"), ("user.name", "utf8"), ("flag", "bool"),
            ("score", "float64")]
    tsq, tback = tv.shred_variant(arr, reqs)
    jsq, jback = jv.shred_variant(arr, reqs)
    assert tback == jback
    assert tsq.resident_requests() == jsq.resident_requests()
    for key, block in tsq.shredded.items():
        assert type(block).__name__ == type(jsq.shredded[key]).__name__
        assert block.to_bytes() == jsq.shredded[key].to_bytes(), key
    assert tsq.memory_bytes() == jsq.memory_bytes()
    io = _MemIo(tback)
    st, used = tsq.to_arrow_with_paths(reqs[:2], io)
    assert not used and io.reads == 0
    jst, _ = jsq.to_arrow_with_paths(reqs[:2], _MemIo(jback))
    assert _struct_lists(st) == _struct_lists(jst)
    st2, used2 = tsq.to_arrow_with_paths([("tags[1]", "utf8")], io)
    assert used2 and io.reads == 1
    assert _struct_lists(st2) == _struct_lists(jsq.to_arrow_with_paths(
        [("tags[1]", "utf8")], _MemIo(jback))[0])
    assert tsq.to_arrow(io).to_pylist() == arr.to_pylist()
    assert tv.shred_variant(pa.array([1, 2]), reqs) is None


def test_merged_with_unions_paths():
    arr = make_json_column(32)
    tsq, tback = tv.shred_variant(arr, [("user.id", "int64")])
    jsq, jback = jv.shred_variant(arr, [("user.id", "int64")])
    tm = tsq.merged_with([("flag", "bool")], _MemIo(tback))
    jm = jsq.merged_with([("flag", "bool")], _MemIo(jback))
    assert tm.resident_requests() == jm.resident_requests() == (
        ("user.id", "int64"), ("flag", "bool"))
    for key in tm.shredded:
        assert tm.shredded[key].to_bytes() == jm.shredded[key].to_bytes()


# -- hints --------------------------------------------------------------------

def test_hint_parse_and_merge():
    """The port takes hints from its planner only (it has no metadata
    string parser): the requests the reference parses from a hint string
    make an equal port hint, and both votes merge the same paths."""
    want = jexpr.parse_hint("variant_get:a.b@int64,c")
    assert texpr.VariantGet(want.requests) == texpr.VariantGet(
        (("a.b", "int64"), ("c", "variant")))
    jv, tv = jexpr.HintVote(), texpr.HintVote()
    for reqs in ((("a", "int64"),), (("b", "utf8"),), (("a", "int64"),)):
        jv.record(jexpr.VariantGet(reqs))
        tv.record(texpr.VariantGet(reqs))
    assert tv.majority().requests == jv.majority().requests
    assert set(tv.majority().requests) == {("a", "int64"), ("b", "utf8")}
    with pytest.raises(AssertionError):
        texpr.VariantGet((("a", "decimal"),))


@pytest.mark.parametrize("sql", [
    "SELECT variant_get(p, 'a.b', 'int') AS x FROM t "
    "WHERE variant_get(p, 'c', 'string') = 'z'",
    "SELECT variant_get(p, 'a') AS x, p FROM t",
    "SELECT variant_get(p, 'k', 'boolean') AS x, count(*) FROM t "
    "GROUP BY x ORDER BY x",
    "SELECT id FROM t WHERE variant_get(p, 'n', 'double') > 1.5"])
def test_column_hints_equal_the_reference(sql):
    got = tplan.column_hints(tparse(sql)[1])
    want = jplan.column_hints(jparse(sql)[1])
    assert {c: (type(h).__name__, getattr(h, "requests", None))
            for c, h in got.items()} == {
        c: (type(h).__name__, getattr(h, "requests", None))
        for c, h in want.items()}


# -- the cache ------------------------------------------------------------------

def _caches(tmp_path, mem=1 << 20):
    j = (JCacheBuilder().with_max_memory_bytes(mem).with_trace_events()
         .with_disk_path(str(tmp_path / "j.bin")).build())
    t = (LiquidCacheBuilder().with_device("cpu").with_max_memory_bytes(mem)
         .with_trace_events().with_disk_path(str(tmp_path / "t.bin")).build())
    return (("j", j, jexpr), ("t", t, texpr))


def _events(cache):
    return [(e.kind, e.entry_id, e.detail)
            for e in cache.observer.consume_event_trace()]


def _script_squeeze_and_read(cache, ex):
    arr = make_json_column(200)
    out = [cache.insert(1, arr, hint=ex.VariantGet(
        (("user.id", "int64"), ("user.name", "utf8")))),
        cache.entry_state(1)]
    cache._squeeze_victim(1)
    out.append(cache.entry_state(1))
    reads = cache.observer.stats.get("squeeze_io_reads")
    st = cache.get_variant_paths(1, [("user.id", "int64")])
    out += [_struct_lists(st),
            cache.observer.stats.get("squeeze_io_reads") - reads,
            cache.observer.stats.get("squeeze_io_saved")]
    # a new path: one read to re-shred, then resident
    st = cache.get_variant_paths(1, [("flag", "bool")])
    out += [_struct_lists(st), cache._entries[1].payload.resident_requests(),
            cache.get_variant_paths(2, [("flag", "bool")])]
    out.append(cache.get(1).to_pylist() == arr.to_pylist())
    out.append(cache.entry_state(1))
    return out


def _script_to_disk_and_back(cache, ex):
    arr = make_json_column(50)
    cache.insert(4, arr, hint=ex.VariantGet((("user.id", "int64"),)))
    cache._squeeze_victim(4)
    cache._squeeze_victim(4)
    out = [cache.entry_state(4), cache.get(4).to_pylist() == arr.to_pylist(),
           cache.entry_state(4),
           cache.get_variant_paths(4, [("user.id", "int64")])]
    return out


def _script_pressure(cache, ex):
    hint = ex.VariantGet((("user.id", "int64"),))
    out = []
    arrays = {i: make_json_column(300, seed=i) for i in range(12)}
    for i, arr in arrays.items():
        out.append(cache.insert(i, arr, hint=hint))
    for i, arr in arrays.items():
        got = cache.get(i)
        out.append(None if got is None else got.to_pylist() == arr.to_pylist())
        st = cache.get_variant_paths(i, [("user.id", "int64")])
        out.append(None if st is None else _struct_lists(st))
    s = cache.stats()
    out.append({k: s[k] for k in ("squeezes", "disk_writes", "disk_reads",
                                  "squeeze_io_saved", "squeeze_io_reads",
                                  "hydrations", "by_state")})
    return out


@pytest.mark.parametrize("script,mem", [
    (_script_squeeze_and_read, 1 << 20), (_script_to_disk_and_back, 1 << 20),
    (_script_pressure, 40_000)], ids=["squeeze_read_merge", "disk_and_back",
                                      "pressure"])
def test_cache_scripts_and_event_traces_equal_the_reference(tmp_path,
                                                            script, mem):
    got = {}
    for side, cache, ex in _caches(tmp_path, mem):
        got[side] = (script(cache, ex), _events(cache))
    assert got["t"][0] == got["j"][0]
    assert got["t"][1] == got["j"][1]
    assert got["t"][1]  # events were traced


def test_squeezed_read_is_zero_io(tmp_path):
    (_, _j, _), (_, cache, ex) = _caches(tmp_path)
    out = _script_squeeze_and_read(cache, ex)
    assert out[1:3] == ["memory_arrow", "memory_squeezed"]
    assert out[4] == 0 and out[5] == 1  # no read, one saved
    assert ("flag", "bool") in out[7] and out[8] is None


# -- SQL ------------------------------------------------------------------------

def _variant_sessions(path, d):
    out = {}
    for side, b in (("j", JBuilder()),
                    ("t", LiquidCacheLocalBuilder(device="cpu"))):
        ctx, _ = (b.with_max_memory_bytes(1 << 24)
                  .with_cache_dir(str(d / side)).build())
        ctx.register_parquet("events", path)
        out[side] = ctx
    return out


@pytest.fixture(scope="module")
def variant_sessions(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_variant")
    n = 300
    rng = np.random.default_rng(42)
    rows = [json.dumps({
        "user": {"id": int(rng.integers(0, 50)), "name": f"u{i % 20}"},
        "score": float(np.round(rng.random(), 6)),
        "active": bool(i % 3 == 0)}) for i in range(n)]
    t = pa.table({"id": pa.array(range(n), pa.int64()),
                  "payload": pa.array(rows, pa.string())})
    path = str(d / "variants.parquet")
    pq.write_table(t, path)
    return _variant_sessions(path, d), t, path


SQLS = [
    "SELECT variant_get(payload, 'user.id', 'int64') AS uid FROM events "
    "WHERE id < 10",
    "SELECT variant_get(payload, 'user.name', 'utf8') AS nm, COUNT(*) AS c "
    "FROM events GROUP BY nm ORDER BY nm",
    "SELECT COUNT(*) AS c FROM events "
    "WHERE variant_get(payload, 'active', 'bool')",
    "SELECT SUM(variant_get(payload, 'user.id', 'int64')) AS s FROM events",
    "SELECT variant_to_json(payload) AS j, variant_pretty(payload) AS p "
    "FROM events WHERE id = 0",
    "SELECT id, variant_get(payload, 'score', 'double') AS s FROM events "
    "WHERE variant_get(payload, 'score', 'float') > 0.9 ORDER BY id",
]


@pytest.mark.parametrize("i", range(len(SQLS)))
def test_sql_variant_functions(variant_sessions, i):
    sessions, t, _path = variant_sessions
    got = sessions["t"].sql(SQLS[i]).to_arrow()
    assert got.to_pylist() == sessions["j"].sql(SQLS[i]).to_arrow().to_pylist()
    docs = [json.loads(s) for s in t.column("payload").to_pylist()]
    if i == 0:
        assert got.column("uid").to_pylist() == [
            d["user"]["id"] for d in docs[:10]]
    if i == 2:
        assert got.column("c")[0].as_py() == sum(d["active"] for d in docs)
    if i == 4:
        assert json.loads(got.column("j")[0].as_py()) == docs[0]
        assert "\n" in got.column("p")[0].as_py()


def test_sql_variant_served_from_squeezed(variant_sessions, tmp_path):
    _, _t, path = variant_sessions
    sessions = _variant_sessions(path, tmp_path)
    q = ("SELECT SUM(variant_get(payload, 'user.id', 'int64')) AS s "
         "FROM events")
    seen = {}
    for side, ctx in sessions.items():
        first = ctx.sql(q).to_arrow()
        for eid in list(ctx.cache._entries):
            ctx.cache._squeeze_victim(eid)
        states = {ctx.cache.entry_state(e) for e in ctx.cache._entries}
        saved = ctx.cache.observer.stats.get("squeeze_io_saved")
        reads = ctx.cache.observer.stats.get("squeeze_io_reads")
        second = ctx.sql(q).to_arrow()
        seen[side] = (first.to_pylist(), second.to_pylist(),
                      "memory_squeezed" in states,
                      ctx.cache.observer.stats.get("squeeze_io_saved") - saved,
                      ctx.cache.observer.stats.get("squeeze_io_reads") - reads)
    assert seen["t"] == seen["j"]
    first, second, squeezed, saved, reads = seen["t"]
    assert first == second and squeezed and saved > 0 and reads == 0


# -- JSONBench ------------------------------------------------------------------

def test_event_generator_equals_the_benchmark_script(tmp_path):
    shutil.copy(os.path.join(ROOT, "benchmark", "json_bench", "generate.py"),
                tmp_path / "generate.py")
    subprocess.run([sys.executable, "generate.py", "--rows", "3000"],
                   cwd=tmp_path, check=True, capture_output=True, timeout=120)
    want = pq.read_table(tmp_path / "data" / "events.parquet")
    assert json_bench.generate(3000).equals(want)


@pytest.fixture(scope="module")
def jsonbench(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_jsonbench")
    table = json_bench.generate(20_000)
    path = str(d / "events.parquet")
    pq.write_table(table, path)
    return path, table, json_bench.answers(table)


def _run_bench(ctx, path):
    ctx.register_parquet("events", path)
    return [ctx.sql(q).to_arrow() for q in json_bench.QUERIES]


def test_jsonbench_uncapped_equals_the_reference_and_the_oracle(jsonbench,
                                                                tmp_path):
    path, _table, want = jsonbench
    jctx, _ = JBuilder().with_cache_dir(str(tmp_path / "j")).build()
    tctx, _ = (LiquidCacheLocalBuilder(device="cpu")
               .with_cache_dir(str(tmp_path / "t")).build())
    got, ref = _run_bench(tctx, path), _run_bench(jctx, path)
    for i, (g, r, w) in enumerate(zip(got, ref, want)):
        assert g.to_pylist() == r.to_pylist(), i
        assert json_bench.same_rows(g, w, i in (0, 1)), i


def test_jsonbench_capped_shreds_and_answers(jsonbench, tmp_path):
    """Capped at half the column's arrow bytes (each block is charged the
    bytes of its slice of the row group), the default policy shreds the
    variant blocks, the warm runs read shredded paths with no IO, and
    every answer equals the oracle.  The reference fails at 1.5x, where
    its charge of the whole row group per block lets it shred: a scan
    that reads some blocks as shredded structs and others as JSON text
    cannot concatenate them."""
    path, table, want = jsonbench
    cap = table.column("event").nbytes // 2
    ctx, cache = (LiquidCacheLocalBuilder(device="cpu")
                  .with_max_memory_bytes(cap)
                  .with_cache_dir(str(tmp_path / "t")).build())
    runs = [_run_bench(ctx, path)]
    saved = cache.observer.stats.get("squeeze_io_saved")
    runs.append([ctx.sql(q).to_arrow() for q in json_bench.QUERIES])
    s = cache.stats()
    for run in runs:
        for i, (g, w) in enumerate(zip(run, want)):
            assert json_bench.same_rows(g, w, i in (0, 1)), i
    assert s["squeezes"] > 0 and s["squeeze_io_saved"] - saved > 0
    assert s["memory_used"] <= cap
    jctx, _ = (JBuilder().with_max_memory_bytes(
        table.column("event").nbytes * 3 // 2)
               .with_cache_dir(str(tmp_path / "j")).build())
    with pytest.raises(pa.ArrowInvalid, match="Schema at index"):
        _run_bench(jctx, path)


def test_json_caps_sweep_reports_each_cap(jsonbench, tmp_path):
    """`bench/json_caps.sweep` at 20,000 events (3 blocks): one row per
    cap, every block in some state, squeezes at 0.5x the column's bytes
    and none at 40x (exact counts)."""
    from liquid_tpu_torch.bench import json_caps
    path, table, _want = jsonbench
    rows = list(json_caps.sweep(path, [0.5, 40.0], "cpu", str(tmp_path)))
    assert [r["fraction"] for r in rows] == [0.5, 40.0]
    for r in rows:
        assert r["blocks"] == 3 and sum(r["by_state"].values()) == 3
        assert r["column_bytes"] == table.column("event").nbytes
        assert r["memory_used"] <= r["cap"]
    assert rows[0]["first_squeezes"] > 0
    assert rows[1]["first_squeezes"] == 0
    assert rows[1]["warm"]["squeeze_io_saved"] == 0
    assert rows[1]["by_state"] == {"memory_arrow": 3}
