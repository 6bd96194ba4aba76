"""The port's benchmark entry point (`python -m liquid_tpu_torch.bench.main`)
in its CPU mode at a tiny size: one JSON line on stdout, all six of the
reference bench's queries -- five on the fused route, `tpch_q3` on the
star route -- every answer through the pyarrow oracle gate (non-float
columns exact, float columns rtol 1e-9), and the reference's `arrow` mode
named as not ported and not run."""
import pytest

torch = pytest.importorskip("torch")

import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import pyarrow as pa  # noqa: E402

from liquid_tpu_torch.bench import main as bench  # noqa: E402
from liquid_tpu_torch.bench import oracle  # noqa: E402
from liquid_tpu_torch.bench.runner import make_session  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--device", "cpu", "--hits-rows", "20000", "--sf", "0.01"]
FUSED = {"cb_filter", "cb_groupby", "cb_like", "tpch_q1", "tpch_q6"}


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("torch_bench"))


@pytest.fixture(scope="module")
def line(data_dir):
    res = subprocess.run(
        [sys.executable, "-m", "liquid_tpu_torch.bench.main", *ARGS,
         "--data-dir", data_dir], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = res.stdout.strip().splitlines()
    assert len(lines) == 1, res.stdout
    return json.loads(lines[0]), res.stderr


def test_one_json_line_with_five_fused_queries(line):
    out, log = line
    assert set(out["queries_ms"]) == FUSED | {"tpch_q3"}
    assert all(v > 0 for v in out["queries_ms"].values())
    assert out["routes"] == {**{q: "fused" for q in FUSED},
                             "tpch_q3": "star"}
    assert "correctness gate: liquid == pyarrow oracle" in log
    assert out["device"] == {"platform": "cpu", "kind": "cpu"}
    assert out["data"]["hits_rows"] == 20000
    assert out["value"] > 0 and out["unit"] == "rows/s/chip"


def test_not_ported_are_named_and_not_run(line):
    out, log = line
    assert set(out["not_ported"]) == {"arrow"}
    assert out["arrow_ms"] is None and out["vs_baseline"] is None
    assert "[arrow]" not in log
    assert set(bench.NOT_PORTED) == {"arrow"}
    names = [q[0] for q in bench.queries(1, 1)]
    assert names == ["cb_filter", "cb_groupby", "cb_like", "tpch_q1",
                     "tpch_q6", "tpch_q3"]


def test_tpch_q3_answers_equal_the_oracle_on_the_star_route(line, data_dir):
    """The star join's answer, re-run in this process on the entry
    point's own parquet, equals the pyarrow oracle's joins."""
    out, log = line
    assert out["routes"]["tpch_q3"] == "star"
    assert "[liquid] tpch_q3:" in log and "[star]" in log
    paths = bench.prepare_data(data_dir, out["data"]["hits_rows"], 0.01)
    assert set(bench.TPCH_TABLES) <= set(paths)
    ctx, _ = make_session("liquid", 1 << 30, "cpu")
    for name, path in paths.items():
        ctx.register_parquet(name, path)
    sql = dict((q[0], q[3]) for q in bench.queries(1, 1))["tpch_q3"]
    got = ctx.sql(sql).to_arrow()
    assert got.num_rows == 10
    assert oracle.same_table(got, oracle.answers(paths, ["tpch_q3"])[
        "tpch_q3"])


def test_cpu_mode_reports_no_device_rates(line):
    out, _ = line
    assert out["operators"] is None
    assert out["micro_packed_compare_rows_per_s"] is None
    assert out["micro_rows"] == 1 << 15


def test_a_wrong_answer_fails_the_run(line, data_dir, monkeypatch, capsys):
    real = oracle.answers

    def off_by_one(paths, names):
        got = real(paths, names)
        got["cb_filter"] = [pa.array([got["cb_filter"][0][0].as_py() + 1])]
        return got
    monkeypatch.setattr(oracle, "answers", off_by_one)
    with pytest.raises(AssertionError, match="cb_filter"):
        bench.main(ARGS + ["--data-dir", data_dir])
    assert capsys.readouterr().out == ""  # no result line


def test_oracle_gate_tolerances():
    want = [pa.array([1, 2]), pa.array([1.0, 2.0])]
    ok = pa.table({"a": [1, 2], "b": [1.0 + 1e-10, 2.0]})
    assert oracle.same_table(ok, want)
    assert not oracle.same_table(pa.table({"a": [1, 3], "b": [1.0, 2.0]}),
                                 want)
    assert not oracle.same_table(pa.table({"a": [1, 2], "b": [1.0 + 1e-8,
                                                             2.0]}), want)
    assert not oracle.same_table(pa.table({"a": [1]}), want)


def test_only_liquid_mode_is_ported():
    for mode in ("arrow", "liquid-no-squeeze"):
        with pytest.raises(NotImplementedError, match="not ported"):
            make_session(mode, 1 << 20, "cpu")
    with pytest.raises(ValueError):
        make_session("nope", 1 << 20, "cpu")
    ctx, cache = make_session("liquid", 1 << 20, "cpu")
    assert cache.device.type == "cpu" and ctx.device.type == "cpu"
