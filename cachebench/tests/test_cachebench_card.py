"""The command itself on the card: each cell correct in a short window.
Run on a machine with a card: `python -m pytest cachebench/ -m card`."""
import json
import subprocess
import sys

import pytest

from cachebench import spec
from cachebench.spec import ROOT

CELLS = [c["name"] for c in spec.benchmark()["workloads"]]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(card, cell, trace):
    b = spec.benchmark()
    p = subprocess.run(
        [sys.executable, *b["command"][1:], "--workload", cell,
         "--seed", "2147483659", "--seconds", "3", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-4000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu"
    if trace:
        assert r["device"]["busy_s"] > 0
