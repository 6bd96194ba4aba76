"""The fused path's predicate lowering against the JAX package's, on
identical encoded blocks (built in the port from the reference's fields
with `from_numpy_fields`): per-block u64 intervals, ALP patch overlays
and the packed masks `_in_interval_many` computes from them.  Bit-exact
(tolerance 0)."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pyarrow as pa  # noqa: E402

from liquid_tpu.arrays.base import Predicate as JPred  # noqa: E402
from liquid_tpu.cache import transcode as jtc  # noqa: E402
from liquid_tpu.sql import fused_agg as jfa  # noqa: E402
from liquid_tpu_torch.arrays.base import Predicate  # noqa: E402
from liquid_tpu_torch.arrays.convert import from_numpy_fields  # noqa: E402
from liquid_tpu_torch.device import (  # noqa: E402
    u64_to_i64, words_to_numpy, words_to_tensor,
)
from liquid_tpu_torch.ops import bitpack_cuda  # noqa: E402
from liquid_tpu_torch.sql import fused_agg as tfa  # noqa: E402

OPS = ("eq", "ne", "lt", "lt_eq", "gt", "gt_eq")


def _blocks(kind: str):
    """Five 8192-row blocks of one column (the last one short), with
    nulls, as (reference blocks, port blocks built from their fields)."""
    rng = np.random.default_rng({"int": 1, "float": 2}[kind])
    ref = []
    for b in range(5):
        n = 8192 if b < 4 else 3000
        mask = rng.random(n) < 0.05
        if kind == "int":
            vals = rng.integers(100 * b, 100 * b + 3000, n)
            arr = pa.array(vals, pa.int32(), mask=mask)
        else:
            vals = np.round(rng.integers(0, 100_000, n) / 100.0, 2)
            vals[:: 50 + b] = rng.standard_normal(len(vals[:: 50 + b]))
            arr = pa.array(vals, pa.float64(), mask=mask)
        ref.append(jtc.transcode(arr))
    ours = []
    for r in ref:
        f = dict(planes=r.planes_np, width=r.width,
                 reference_value=r.reference_value, validity=r.validity_np,
                 length=r.length, arrow_type=r.arrow_type)
        if kind == "float":
            f.update(exponent=r.exponent, patch_idx=r.patch_idx,
                     patch_vals=r.patch_vals)
        ours.append(from_numpy_fields("float" if kind == "float"
                                      else "primitive", f))
    return ref, ours


def _stack(blocks):
    wb = max(max(p.planes_np.shape[0] for p in blocks), 1)
    out = np.zeros((len(blocks), wb, 256), np.uint32)
    for i, p in enumerate(blocks):
        out[i, : p.planes_np.shape[0]] = p.planes_np
    return out


def _masks_equal(planes, lo, hi):
    ref = np.asarray(jfa._in_interval_many(
        jnp.asarray(planes), jnp.asarray(lo), jnp.asarray(hi)))
    got = tfa._in_interval_many(words_to_tensor(planes),
                                torch.from_numpy(u64_to_i64(lo)),
                                torch.from_numpy(u64_to_i64(hi)))
    np.testing.assert_array_equal(words_to_numpy(got), ref)


@pytest.mark.parametrize("op", OPS)
def test_primitive_intervals_and_masks(op):
    ref, ours = _blocks("int")
    planes = _stack(ref)
    for lit in (-5, 0, 150, 401, 1234.5, 2999, 3400, 10 ** 9):
        riv = jfa._primitive_interval(ref, JPred(op, lit))
        tiv = tfa._primitive_interval(ours, Predicate(op, lit))
        assert (riv is None) == (tiv is None)
        np.testing.assert_array_equal(tiv[0], riv[0])
        np.testing.assert_array_equal(tiv[1], riv[1])
        assert tiv[2] == riv[2]
        _masks_equal(planes, tiv[0], tiv[1])


@pytest.mark.parametrize("op", OPS)
def test_float_intervals_overlays_and_masks(op):
    ref, ours = _blocks("float")
    planes = _stack(ref)
    assert any(p.num_patches for p in ours)
    for lit in (-1.0, 0.0, 0.05, 123.45, 999.99, 1e9, float("nan")):
        riv = jfa._float_interval(ref, JPred(op, lit))
        tiv = tfa._float_interval(ours, Predicate(op, lit))
        for a, b in zip(tiv[:2], riv[:2]):
            np.testing.assert_array_equal(a, b)
        assert tiv[2] == riv[2]
        np.testing.assert_array_equal(tiv[3], riv[3])
        np.testing.assert_array_equal(tiv[4], riv[4])
        _masks_equal(planes, tiv[0], tiv[1])


def test_interval_masks_take_one_k1_call(monkeypatch):
    """The fused path's interval mask is one call of K1's interval form
    (one launch on the card), never a pair of single-constant calls."""
    calls = []
    real = bitpack_cuda.in_interval_many

    def spy(*a, **k):
        calls.append("interval")
        return real(*a, **k)

    monkeypatch.setattr(bitpack_cuda, "in_interval_many", spy)
    monkeypatch.setattr(bitpack_cuda, "cmp_const_many",
                        lambda *a, **k: calls.append("single"))
    ref, _ = _blocks("int")
    planes = _stack(ref)
    lo = np.full(len(ref), 150, np.uint64)
    hi = np.full(len(ref), 2999, np.uint64)
    _masks_equal(planes, lo, hi)
    assert calls == ["interval"]
