"""The port's differential fuzz cases (`bench/fuzz.py`) against pyarrow
and the JAX package's arrays, on the CPU.

For the reference's seeds (0-59 string cases, 0-39 integer cases), every
compare's row mask equals pyarrow compute's (inside `check_case` /
`check_primitive_case`) and the reference array's on the same input: the
same NULL rows, the same truth value on every other row.  A seed draws
the same case in both packages (the generators are copies), which the
tests check too; `fuzz/fuzz_byteview_torch.py` runs a few seeds.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402

from liquid_tpu.arrays.base import Predicate as JPredicate  # noqa: E402
from liquid_tpu.arrays.byteview import LiquidByteViewArray as JByteView  # noqa: E402
from liquid_tpu.arrays.primitive import LiquidPrimitiveArray as JPrimitive  # noqa: E402
from liquid_tpu.ops import mask as jmops  # noqa: E402
from liquid_tpu_torch.bench import fuzz  # noqa: E402
from tests import test_fuzz_differential as jfuzz  # noqa: E402

CPU = torch.device("cpu")


def _reference_rows(liquid, op, lit, n):
    got = liquid.try_eval_predicate(JPredicate(op, lit))
    assert got is not None
    return (np.asarray(jmops.unpack_bits(got.bits))[:n],
            np.asarray(jmops.unpack_bits(got.valid))[:n])


def _same_as_reference(compares, liquid, n):
    for op, lit, bits, valid in compares:
        rbits, rvalid = _reference_rows(liquid, op, lit, n)
        assert (valid == rvalid).all(), (op, lit)
        assert (bits[valid] == rbits[valid]).all(), (op, lit)


@pytest.mark.parametrize("seed", range(60))
def test_byteview_differential(seed):
    compares = fuzz.check_case(seed, CPU)
    arr, with_fp, preds = fuzz.byteview_case(seed)
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 2000))
    assert arr.to_pylist() == jfuzz.random_strings(rng, n)
    assert [(op, lit) for op, lit, _b, _v in compares] == preds
    _same_as_reference(compares, JByteView.from_arrow(
        arr, with_fingerprints=with_fp), len(arr))


@pytest.mark.parametrize("seed", range(40))
def test_primitive_differential(seed):
    compares = fuzz.check_primitive_case(seed, CPU)
    arr, preds = fuzz.primitive_case(seed)
    assert [(op, lit) for op, lit, _b, _v in compares] == preds
    _same_as_reference(compares, JPrimitive.from_arrow(arr), len(arr))


def test_divergence_names_the_seed(monkeypatch):
    """A wrong mask fails with the seed, the op and the literal."""
    from liquid_tpu_torch.arrays.primitive import LiquidPrimitiveArray
    real = LiquidPrimitiveArray.try_eval_predicate

    def flipped(self, pred, device):
        m = real(self, pred, device)
        return type(m)(~m.bits, m.valid)
    monkeypatch.setattr(LiquidPrimitiveArray, "try_eval_predicate", flipped)
    with pytest.raises(AssertionError, match=r"seed=3 op=\w+ literal="):
        fuzz.check_primitive_case(3, CPU)


def test_loop_runs_on_the_cpu(capsys):
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(__file__), "..", "fuzz",
                        "fuzz_byteview_torch.py")
    spec = importlib.util.spec_from_file_location("fuzz_loop", path)
    loop = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(loop)
    assert loop.main(["--minutes", "0.01", "--start-seed", "0", "--cpu"]) == 0
    assert "no divergence" in capsys.readouterr().out
