"""Each cell's files through the harness at tiny sizes on the CPU, a
workload under a cache cap, and the command's refusal without a card."""
import json
import os
import subprocess
import sys

import pytest

from cachebench import spec
from cachebench.spec import HERE, ROOT

CELLS = [c["name"] for c in spec.benchmark()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_cell_rehearsal(run_tiny, cell, trace):
    r = run_tiny(cell, trace)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in spec.metrics_of(cell, kind)}
    # the device readers find nothing to read on the CPU and stay silent
    silent = {"k1_roofline", "k2_roofline", "device.idle_share"}
    assert want - silent <= set(r["metrics"]) <= want
    for m in r["metrics"].values():
        assert m["value"] == m["value"] and m["value"] >= 0
    if trace:
        assert r["device"]["window_s"] > 0
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}


def test_capped_workload(run_tiny):
    with open(os.path.join(HERE, "tests", "capped.json")) as f:
        workload = json.load(f)
    r = run_tiny("tpch_sf1.fused", workload=workload)
    assert r["correct"], r["checks"]


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for cell in CELLS:
        e2e = {m["name"] for m in spec.metrics_of(cell, "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec.metrics_of(cell, "per_layer")
        for m in spec.metrics_of(cell, "end_to_end") + spec.metrics_of(
                cell, "per_layer"):
            assert callable(spec.metric(m["name"]).read)


def test_command_fails_without_a_card():
    b = spec.benchmark()
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    p = subprocess.run(
        [sys.executable, *b["command"][1:], "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr
