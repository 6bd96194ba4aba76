"""The port's examples (`examples/torch/`), each run in-process with
`--device cpu`, their answers held against pyarrow on the same file.

The six runnable examples end without error and answer what the
reference's examples answer; `example_server.py` hands its options to
`bench.clients.serve` (it serves until shut down, so its `serve` is
replaced by a recorder here).
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import importlib.util  # noqa: E402
import os  # noqa: E402

import pyarrow.compute as pc  # noqa: E402
import pyarrow.parquet as pq  # noqa: E402

from liquid_tpu_torch.bench.hits import NANO_HITS  # noqa: E402

EXAMPLES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "examples", "torch")
NAMES = ("example_local", "example_inprocess_read",
         "example_inprocess_insertion", "example_inprocess_cache_eviction",
         "example_client", "example_projection_pushdown", "example_server")
CPU = ["--device", "cpu"]


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"torch_{name}", os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_reference_examples_all_have_ports():
    ref = {f[:-3] for f in os.listdir(os.path.join(EXAMPLES, ".."))
           if f.startswith("example_") and f.endswith(".py")}
    assert ref == set(NAMES)
    assert {f[:-3] for f in os.listdir(EXAMPLES)
            if f.endswith(".py")} == set(NAMES)


def test_local_counts_the_file():
    out = _load("example_local").main(CPU)
    assert out.column(0).to_pylist() == [pq.ParquetFile(
        NANO_HITS).metadata.num_rows]


def test_inprocess_read_goes_through_disk():
    assert _load("example_inprocess_read").main(CPU)["disk_reads"] >= 1


def test_inprocess_insertion_keeps_the_entry_resident():
    assert _load("example_inprocess_insertion").main(CPU) == "memory_liquid"


def test_inprocess_cache_eviction_engages():
    st = _load("example_inprocess_cache_eviction").main(CPU)
    assert st["entries"] == 724
    assert sum(st["by_state"].values()) == 724
    assert st["squeezes"] > 0 and st["disk_writes"] > 0
    assert st["memory_used"] <= 1 << 20


def test_projection_pushdown_answer():
    out, st = _load("example_projection_pushdown").main(CPU)
    t = pq.read_table(NANO_HITS, columns=["RegionID", "AdvEngineID"])
    g = t.filter(pc.not_equal(t["AdvEngineID"], 0)).group_by(
        "RegionID").aggregate([([], "count_all")])
    counts = sorted(g["count_all"].to_pylist(), reverse=True)[:5]
    assert out.column("c").to_pylist() == counts
    # only the two referenced columns entered the cache
    n_batches = sum(-(-pq.ParquetFile(NANO_HITS).metadata.row_group(i)
                      .num_rows // 8192) for i in range(
                          pq.ParquetFile(NANO_HITS).metadata.num_row_groups))
    assert st["entries"] == 2 * n_batches


def test_client_through_an_inprocess_server():
    out = _load("example_client").main(CPU)
    t = pq.read_table(NANO_HITS, columns=["UserID"])
    assert out.column("c").to_pylist() == [t.num_rows]
    assert out.column("u").to_pylist() == [len(pc.unique(t["UserID"]))]


def test_server_hands_its_options_to_serve(monkeypatch):
    mod = _load("example_server")
    seen = {}
    monkeypatch.setattr(mod, "serve", lambda **kw: seen.update(kw))
    mod.main(["--port", "0", "--admin-port", "0", "--max-memory-mb", "64",
              "--device", "cpu"])
    assert seen == {"cache_mode": "liquid", "max_memory_mb": 64, "port": 0,
                    "admin_port": 0, "device": "cpu"}
