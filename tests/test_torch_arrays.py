"""Port encodings against the JAX package's: transcoding the same arrow
block gives identical host fields (planes, reference value, validity,
ALP exponent and patches, linear slope), identical arrow decode and
identical device decode; `from_numpy_fields` rebuilds a JAX block in the
port exactly.  Tolerance 0 throughout: the encodings are integer images
and the float decode is the same IEEE multiply on both sides."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
import pyarrow as pa  # noqa: E402

from liquid_tpu.arrays.float_alp import LiquidFloatArray as JFloat  # noqa: E402
from liquid_tpu.arrays.linear import LiquidLinearArray as JLinear  # noqa: E402
from liquid_tpu.cache import transcode as jtc  # noqa: E402
from liquid_tpu_torch.arrays.convert import from_numpy_fields  # noqa: E402
from liquid_tpu_torch.arrays.float_alp import LiquidFloatArray  # noqa: E402
from liquid_tpu_torch.arrays.linear import LiquidLinearArray  # noqa: E402
from liquid_tpu_torch.arrays.primitive import LiquidPrimitiveArray  # noqa: E402
from liquid_tpu_torch.cache import transcode as ttc  # noqa: E402
from liquid_tpu_torch.device import words_to_numpy  # noqa: E402


def _nulls(rng, n, frac):
    return rng.random(n) < frac if frac else None


def _int_block(t, n, seed, null_frac):
    rng = np.random.default_rng(seed)
    info = np.iinfo(t.to_pandas_dtype())
    lo, hi = max(info.min, -(1 << 40)), min(info.max, 1 << 40)
    vals = rng.integers(lo, hi, n, dtype=np.int64, endpoint=True)
    return pa.array(vals.astype(t.to_pandas_dtype()), t,
                    mask=_nulls(rng, n, null_frac))


def _cases():
    rng = np.random.default_rng(0)
    out = []
    for seed, t in enumerate((pa.int8(), pa.int16(), pa.int32(), pa.int64(),
                              pa.uint8(), pa.uint16(), pa.uint32(),
                              pa.uint64())):
        out.append((f"{t}", _int_block(t, 8192, seed, 0.1)))
    out.append(("int64-short", _int_block(pa.int64(), 1000, 5, 0.0)))
    days = rng.integers(8000, 10500, 8192).astype(np.int32)
    out.append(("date32", pa.array(days, pa.date32(),
                                   mask=_nulls(rng, 8192, 0.05))))
    out.append(("bool", pa.array(rng.random(5000) < 0.3, pa.bool_(),
                                 mask=_nulls(rng, 5000, 0.2))))
    # linear: a near-monotonic key with small noise (row ids, offsets)
    lin = (np.arange(8192, dtype=np.int64) * 37 + 1_000_000
           + rng.integers(-3, 4, 8192))
    out.append(("linear", pa.array(lin, pa.int64())))
    cents = np.round(rng.integers(100, 10_000_000, 8192) / 100.0, 2)
    cents[::97] = rng.standard_normal(85) * 1e6  # exception patches
    out.append(("float64-alp", pa.array(cents, pa.float64(),
                                        mask=_nulls(rng, 8192, 0.05))))
    out.append(("float64-wild", pa.array(
        np.concatenate([rng.standard_normal(4000),
                        [np.nan, np.inf, -np.inf, 0.0, -0.0]]),
        pa.float64())))
    out.append(("float32", pa.array(
        (rng.integers(0, 1000, 3000) / 10.0).astype(np.float32),
        pa.float32())))
    return out


CASES = _cases()


def _fields(block):
    """The reference block's encoded host fields, as plain numpy."""
    if isinstance(block, JLinear):
        r = block.residuals
        return "linear", dict(planes=r.planes_np, width=r.width,
                              reference_value=r.reference_value,
                              validity=r.validity_np, length=block.length,
                              arrow_type=block.arrow_type, slope=block.slope)
    f = dict(planes=block.planes_np, width=block.width,
             reference_value=block.reference_value,
             validity=block.validity_np, length=block.length,
             arrow_type=block.arrow_type)
    if isinstance(block, JFloat):
        f.update(exponent=block.exponent, patch_idx=block.patch_idx,
                 patch_vals=block.patch_vals)
        return "float", f
    return "primitive", f


def _assert_same_fields(ours, ref_fields):
    kind, f = ref_fields
    blk = ours.residuals if kind == "linear" else ours
    np.testing.assert_array_equal(blk.planes_np, f["planes"])
    assert blk.width == f["width"]
    assert blk.reference_value == f["reference_value"]
    if f["validity"] is None:
        assert blk.validity_np is None
    else:
        np.testing.assert_array_equal(blk.validity_np, f["validity"])
    assert ours.length == f["length"] and ours.arrow_type == f["arrow_type"]
    if kind == "linear":
        assert ours.slope == f["slope"]
    if kind == "float":
        assert ours.exponent == f["exponent"]
        np.testing.assert_array_equal(ours.patch_idx, f["patch_idx"])
        np.testing.assert_array_equal(ours.patch_vals, f["patch_vals"])


def _assert_same_arrow(a: pa.Array, b: pa.Array):
    """Equal type, nulls and value bits (NaN-safe, -0.0 distinct)."""
    assert a.type == b.type and len(a) == len(b)
    np.testing.assert_array_equal(np.asarray(a.is_valid()),
                                  np.asarray(b.is_valid()))
    va = np.asarray(a.fill_null(False if a.type == pa.bool_() else 0))
    vb = np.asarray(b.fill_null(False if b.type == pa.bool_() else 0))
    if va.dtype.kind == "f":
        va, vb = va.view(f"i{va.itemsize}"), vb.view(f"i{vb.itemsize}")
    np.testing.assert_array_equal(va, vb)


def _assert_same_device_decode(ours, ref):
    rv, rvalid = ref.to_device()
    tv, tvalid = ours.to_device("cpu")
    np.testing.assert_array_equal(tv.numpy(), np.asarray(rv))
    if rvalid is None:
        assert tvalid is None
    else:
        np.testing.assert_array_equal(words_to_numpy(tvalid),
                                      np.asarray(rvalid))


@pytest.mark.parametrize("name,arr", CASES, ids=[c[0] for c in CASES])
def test_transcode_matches_reference(name, arr):
    ref = jtc.transcode(arr)
    ours = ttc.transcode(arr)
    expect = {"linear": LiquidLinearArray}.get(name, (
        LiquidFloatArray if name.startswith("float")
        else LiquidPrimitiveArray))
    assert isinstance(ours, expect), type(ours)
    assert type(ours).__name__ == type(ref).__name__
    _assert_same_fields(ours, _fields(ref))
    _assert_same_arrow(ours.to_arrow(), ref.to_arrow())
    assert ours.memory_bytes() == ref.memory_bytes()
    _assert_same_device_decode(ours, ref)


@pytest.mark.parametrize("name,arr", CASES, ids=[c[0] for c in CASES])
def test_from_numpy_fields_round_trips_reference_block(name, arr):
    ref = jtc.transcode(arr)
    kind, f = _fields(ref)
    ours = from_numpy_fields(kind, f)
    _assert_same_fields(ours, (kind, f))
    _assert_same_arrow(ours.to_arrow(), ref.to_arrow())
    _assert_same_device_decode(ours, ref)


def test_patches_present_in_alp_case():
    arr = dict(CASES)["float64-alp"]
    assert ttc.transcode(arr).num_patches > 0


@pytest.mark.parametrize("arr", [
    pa.array(["a", "b", None]), pa.array([b"x"], pa.binary()),
    pa.array([1, 2], pa.decimal128(10, 2)),
    pa.array(["a", "b"]).dictionary_encode()])
def test_strings_and_decimals_raise(arr):
    """Decimals still raise; strings and binaries transcode to the same
    dictionary block as the reference's (tests/test_torch_strings.py
    covers the string encodings in depth)."""
    if pa.types.is_decimal(arr.type):
        with pytest.raises(NotImplementedError):
            ttc.transcode(arr)
        return
    ours, ref = ttc.transcode(arr), jtc.transcode(arr)
    np.testing.assert_array_equal(ours.codes_np, ref.codes_np)
    assert ours.to_arrow().equals(ref.to_arrow())
