"""The comparison that decides `correct`."""
import math

import pyarrow as pa
import pytest

from cachebench import compare


def _t(*cols):
    return pa.table({f"c{i}": c for i, c in enumerate(cols)})


def test_exact_and_float_cells():
    want = [pa.array(["a", "b"]), pa.array([1.0, 2.0])]
    assert compare.agrees(_t(*want), want, None, 1e-9)
    near = _t(pa.array(["a", "b"]), pa.array([1.0, 2.0 * (1 + 1e-12)]))
    assert compare.agrees(near, want, None, 1e-9)
    assert compare.float_gap(near, want) == pytest.approx(1e-12, rel=1e-3)
    far = _t(pa.array(["a", "b"]), pa.array([1.0, 2.0 * (1 + 1e-6)]))
    assert not compare.agrees(far, want, None, 1e-9)
    assert not compare.agrees(_t(pa.array(["a", "c"]), want[1]), want,
                              None, 1e-9)


def test_tie_rule_accepts_any_tied_pick():
    # ORDER BY c DESC LIMIT 2 over counts 5, 3, 3: either 3 may be picked
    want = [pa.array(["x", "y", "z"]), pa.array([5, 3, 3])]
    cut = ((1,), 0, 2)
    assert compare.agrees(_t(pa.array(["x", "z"]), pa.array([5, 3])), want,
                          cut, 1e-9)
    assert not compare.agrees(_t(pa.array(["x", "q"]), pa.array([5, 3])),
                              want, cut, 1e-9)
    assert not compare.agrees(_t(pa.array(["x"]), pa.array([5])), want,
                              cut, 1e-9)


def test_float_gap_of_nulls_and_nans():
    want = [pa.array([1]), pa.array([None], pa.float64())]
    assert compare.float_gap(_t(pa.array([1]), pa.array([0.5])),
                             want) == math.inf
    nan = [pa.array([1]), pa.array([float("nan")])]
    assert compare.float_gap(_t(*nan), nan) == 0.0
