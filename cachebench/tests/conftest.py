"""Tiny copies of the benchmark's configurations, and the harness run on the
CPU over them (the port with `device="cpu"`)."""
import time

import pytest

from cachebench import harness, spec

SEED = 2 ** 31 + 17
#: the configurations' sizes for a CPU run: TPC-H at SF 0.01, 20,000 hits
TINY = {"scale_factor": 0.01, "rows": 20_000}


def tiny_config(name: str) -> dict:
    cfg = spec.config(name)
    for key, value in TINY.items():
        if key in cfg:
            cfg[key] = value
    return cfg


@pytest.fixture(scope="session")
def data_root(tmp_path_factory):
    return str(tmp_path_factory.mktemp("cachebench_data"))


@pytest.fixture(scope="session")
def run_tiny(data_root):
    """run_tiny(cell, trace=False, workload=None, program=None,
    seed=SEED) -> the result object of a one-second CPU run (`program`
    None: the one the workload names)."""
    def run(cell_name, trace=False, workload=None, program=None,
            seed=SEED):
        cfg = tiny_config(spec.cell(cell_name)["config"])
        return harness.run_cell(
            cell_name, seed, 1.0, trace, time.perf_counter(), device="cpu",
            config=cfg, workload=workload, data_root=data_root,
            program=program)
    return run
