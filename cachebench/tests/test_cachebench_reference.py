"""Each query's frozen reference against the port's answer, on tiny data on
the CPU."""
import pytest
import torch

from cachebench import compare, data, harness, spec
from cachebench.tests.conftest import SEED, tiny_config

CASES = [(c["name"], c["config"], q)
         for c in spec.benchmark()["workloads"]
         for q in spec.workload(c["name"])["queries"]]


@pytest.fixture(scope="module")
def sessions(data_root):
    """{config: (port session, table paths)}, one per configuration."""
    out = {}
    yield out
    for port, _paths in out.values():
        port.close()


def _session(sessions, data_root, config_name):
    if config_name not in sessions:
        cfg = tiny_config(config_name)
        paths = data.prepare(cfg, SEED, data_root)
        queries = sorted({q for c, k, q in CASES if k == config_name})
        sqls = {q: spec.query_sql(config_name, q) for q in queries}
        port = spec.program("session").Program(
            torch, "cpu", {"max_memory_bytes": 1 << 30}, paths, sqls)
        sessions[config_name] = (port, paths)
    return sessions[config_name]


@pytest.mark.parametrize("cell,config_name,query", CASES)
def test_reference_equals_port(sessions, data_root, cell, config_name,
                               query):
    port, paths = _session(sessions, data_root, config_name)
    got = port.answer(query)
    want, cut = harness.reference_answers(
        tiny_config(config_name), [query], paths)[query]
    limit = spec.config(config_name)["limits"]["float_rel_gap"]
    assert compare.agrees(got, want, cut, limit), (query, got, want)
    assert compare.float_gap(got, want) <= limit


def test_every_query_has_its_files():
    for cell in spec.benchmark()["workloads"]:
        for q in spec.workload(cell["name"])["queries"]:
            assert spec.query_sql(cell["config"], q)
            assert callable(spec.reference(cell["config"], q).answer)


@pytest.mark.parametrize("cell", sorted(
    c["name"] for c in spec.benchmark()["workloads"]))
def test_every_workload_names_its_traffic_and_program(cell):
    w = spec.workload(cell)
    assert callable(spec.traffic(w["traffic"]).drive)
    assert callable(spec.program(w["program"]).Program)
