"""The benchmark's files, found by name: `BENCHMARK.json` at the root of
the checkout, `configs/<config>.json`, `workloads/<cell>.json`,
`queries/<config>/<query>.sql`, `reference/<config>/<query>.py`,
`metrics/<metric>.py`, and the `traffic/<traffic>.py` and
`programs/<program>.py` that a workload file names.  A cell, a query, a
metric, a traffic or a program is added by adding its files and entries;
nothing here names one.
"""
from __future__ import annotations

import importlib.util
import json
import os
from types import ModuleType
from typing import List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return _json(os.path.join(ROOT, "BENCHMARK.json"))


def cell(name: str) -> dict:
    """The `workloads` entry of `BENCHMARK.json` named `name`."""
    for c in benchmark()["workloads"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no cell {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return _json(os.path.join(HERE, "configs", f"{name}.json"))


def workload(cell_name: str) -> dict:
    """The traffic mix of a cell: its queries in order, the traffic that
    drives them, the program under test, the warm passes of set-up and
    the cache's memory budget."""
    return _json(os.path.join(HERE, "workloads", f"{cell_name}.json"))


def query_sql(config_name: str, query: str) -> str:
    with open(os.path.join(HERE, "queries", config_name,
                           f"{query}.sql")) as f:
        return f.read().strip().rstrip(";").strip()


def _load(path: str, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference(config_name: str, query: str) -> ModuleType:
    """The plain reference of one query: `answer(db)` and, where a LIMIT
    may cut through ties, `CUT`."""
    return _load(os.path.join(HERE, "reference", config_name,
                              f"{query}.py"),
                 f"cachebench_reference_{config_name}_{query}")


def traffic(name: str) -> ModuleType:
    """A traffic: `drive(answer, workload, deadline_ns, record)`."""
    return _load(os.path.join(HERE, "traffic", f"{name}.py"),
                 f"cachebench_traffic_{name.replace('.', '_')}")


def program(name: str) -> ModuleType:
    """A program under test: `Program(torch, device, workload, paths,
    sqls)`."""
    return _load(os.path.join(HERE, "programs", f"{name}.py"),
                 f"cachebench_program_{name.replace('.', '_')}")


def metric(name: str) -> ModuleType:
    """The reader of one metric: `read(run)` -> a number, or None where the
    run holds nothing to read; optionally `HOOKS`."""
    return _load(os.path.join(HERE, "metrics", f"{name}.py"),
                 f"cachebench_metric_{name.replace('.', '_')}")


def metrics_of(cell_name: str, kind: str) -> List[dict]:
    """The `end_to_end` or `per_layer` entries that a cell reports: those
    that list it under `workloads`, and those with no such list."""
    return [m for m in benchmark()[kind]
            if cell_name in m.get("workloads", [cell_name])]
