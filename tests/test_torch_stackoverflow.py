"""The port's StackOverflow-DBA suite (`bench/stackoverflow_data.py`)
against the JAX package's, on the CPU.

- `generate()` makes the reference's five tables, value for value.
- The eight queries at the reference CI's 10 MB cap: the port's `liquid`
  and `arrow` sessions agree with each other, with the reference
  session's answers and with the pyarrow oracles (`oracle.SO_ORACLES`).
- At 256 KiB the cap squeezes or spills and holds after every query
  (reference `tests/test_stackoverflow.py:95-106`).
- `main` writes the data and a manifest that `bench/manifest.py` loads,
  and with `--answers --cpu` answers that the in-process runner verifies.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import json  # noqa: E402

from liquid_tpu.bench import stackoverflow_data as jso  # noqa: E402
from liquid_tpu_torch.bench import oracle  # noqa: E402
from liquid_tpu_torch.bench import stackoverflow_data as so  # noqa: E402
from liquid_tpu_torch.bench.manifest import Manifest  # noqa: E402
from liquid_tpu_torch.bench.runner import InProcessRunner, make_session  # noqa: E402

CAP = 10 << 20


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("so")
    tables = so.generate()
    return d, tables, so.write_parquet(tables, str(d / "data"))


@pytest.fixture(scope="module")
def expect(data):
    return oracle.answers(data[2], list(oracle.SO_ORACLES))


def _answers(d, paths, mode, cap):
    ctx, cache = make_session(mode, cap, str(d / f"c_{mode}_{cap}"), "cpu")
    for n, p in paths.items():
        ctx.register_parquet(n, p)
    outs = []
    for q in so.QUERIES:
        outs.append(ctx.sql(q).to_arrow())
        st = cache.stats()
        assert st["memory_used"] <= cap, st
    return outs, cache.stats()


@pytest.fixture(scope="module")
def port_answers(data):
    d, _tables, paths = data
    return {mode: _answers(d, paths, mode, CAP)[0]
            for mode in ("liquid", "arrow")}


@pytest.fixture(scope="module")
def reference_answers(data):
    from liquid_tpu.sql.session import LiquidCacheLocalBuilder as JBuilder
    d, _tables, paths = data
    sess, _ = (JBuilder().with_max_memory_bytes(CAP)
               .with_cache_dir(str(d / "ref")).build())
    for n, p in paths.items():
        sess.register_parquet(n, p)
    return [sess.sql(q).to_arrow() for q in jso.QUERIES]


def test_queries_are_the_reference_queries():
    assert so.QUERIES == jso.QUERIES


def test_generate_equals_reference(data):
    want = jso.generate()
    got = data[1]
    assert list(got) == list(want)
    for name in want:
        assert got[name].equals(want[name]), name


def test_generate_equals_reference_at_other_sizes():
    got, want = so.generate(37, 301, seed=5), jso.generate(37, 301, seed=5)
    assert all(got[n].equals(want[n]) for n in want)


@pytest.mark.parametrize("qi", range(len(so.QUERIES)))
def test_query_at_10mb(port_answers, reference_answers, expect, qi):
    liquid = port_answers["liquid"][qi]
    arrow = port_answers["arrow"][qi]
    assert liquid.equals(arrow.rename_columns(liquid.column_names)), qi
    ref = reference_answers[qi]
    assert liquid.equals(ref.rename_columns(liquid.column_names)), qi
    assert oracle.same_table(liquid, expect[f"so_q{qi}"]), qi


def test_eviction_engaged_at_cap(data, expect):
    d, _tables, paths = data
    cap = 256 << 10
    outs, st = _answers(d, paths, "liquid", cap)
    assert st["squeezes"] + st["disk_writes"] > 0, st
    for qi, out in enumerate(outs):
        assert oracle.same_table(out, expect[f"so_q{qi}"]), qi


def test_main_writes_manifest_and_answers(tmp_path):
    assert so.main(["--users", "50", "--posts", "400", "--answers", "--cpu",
                    "--out", str(tmp_path)]) == 0
    m = Manifest.load(str(tmp_path / "manifest.dba.json"))
    assert m.name == "StackOverflow-DBA"
    assert sorted(m.tables) == sorted(so.generate(1, 32))
    assert m.queries == so.QUERIES
    raw = json.loads((tmp_path / "manifest.dba.json").read_text())
    assert all(not p.startswith("/") for p in raw["tables"].values())
    res = InProcessRunner(m, iterations=1, cache_dir=str(tmp_path / "c"),
                          device="cpu").run()
    assert [q["verified"] for q in res["queries"]] == [True] * 8
