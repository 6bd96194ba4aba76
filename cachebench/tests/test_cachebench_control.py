"""The check that decides `correct` fails its control and the faults a
run can have, on tiny data on the CPU."""
import os

import pyarrow as pa
import pyarrow.compute as pc
import pyarrow.parquet as pq
import pytest

from cachebench import control, spec
from cachebench.tests.conftest import tiny_config

SESSION = spec.program("session").Program

CELLS = [c["name"] for c in spec.benchmark()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(run_tiny, cell):
    name = spec.cell(cell)["config"]
    r = run_tiny(cell, program=lambda *a: control.Control(name, *a))
    assert not r["correct"]
    assert r["checks"]["float_rel_gap"]["value"] > \
        r["checks"]["float_rel_gap"]["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_readings(cell, data_root):
    r = control.readings(cell, 5, tiny_config(spec.cell(cell)["config"]),
                         data_root)
    assert r["float_rel_gap"] > 1e-9


class Altered(SESSION):
    """An answer altered where it is produced: one cell of the first
    non-empty answer of every query is changed."""

    def answer(self, query):
        out = super().answer(query)
        if out.num_rows == 0:
            return out
        col = out.column(out.num_columns - 1)
        first = col[0].as_py()
        if isinstance(first, (int, float)):
            vals = col.to_pylist()
            vals[0] = first + 1
            col = pa.array(vals, col.type)
        else:
            col = pc.binary_join_element_wise(col.cast(pa.string()), "x", "")
        return out.set_column(out.num_columns - 1, out.field(
            out.num_columns - 1).name, col)


def _halved(paths, root):
    """Copies of the tables with the back half of their rows left out."""
    out = {}
    for t, p in paths.items():
        table = pq.read_table(p)
        out[t] = os.path.join(root, f"half_{t}.parquet")
        pq.write_table(table.slice(0, (table.num_rows + 1) // 2), out[t])
    return out


@pytest.mark.parametrize("cell", CELLS)
def test_altered_answer_is_not_correct(run_tiny, cell):
    r = run_tiny(cell, program=Altered)
    assert not r["correct"] and r["checks"]["wrong_answers"]["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_half_the_rows_left_out_is_not_correct(run_tiny, cell, tmp_path):
    def half(torch, device, workload, paths, sqls):
        return SESSION(torch, device, workload,
                            _halved(paths, str(tmp_path)), sqls)
    r = run_tiny(cell, program=half)
    assert not r["correct"] and r["checks"]["wrong_answers"]["value"] > 0
