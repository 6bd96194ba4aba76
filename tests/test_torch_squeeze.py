"""The squeezed forms: the port's `arrays/hybrid.py` and
`SqueezedFloatArray` against the JAX package's, both on the CPU.

For each kind (clamped and quantized integers, byte-view, date32, ALP
float) the squeezed form is built from the same liquid block in both
packages, then:
- every comparison op against literals below the reference, inside the
  narrow range, at the sentinel or bucket edge, above the range, and
  fractional gives masks equal bit for bit and the same number of IO
  reads (a counting IO handler serves the backing bytes);
- `to_arrow(io)`, `memory_bytes()` and the backing bytes are equal, and
  `to_component_array` for every date field.

Also: every packed compare of one block (a liquid primitive or float
block, each squeezed kind, the cache's batched scan with a width bucket
of one block) is one call of K1's single form,
`bitpack_cuda.cmp_const_many`, counted on the CPU by wrapping it."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402
import pyarrow as pa  # noqa: E402

from liquid_tpu.arrays import byteview as jbv  # noqa: E402
from liquid_tpu.arrays import float_alp as jfa  # noqa: E402
from liquid_tpu.arrays import hybrid as jhy  # noqa: E402
from liquid_tpu.arrays import primitive as jprim  # noqa: E402
from liquid_tpu.arrays.base import Predicate as JPred  # noqa: E402
from liquid_tpu_torch.arrays import byteview as tbv  # noqa: E402
from liquid_tpu_torch.arrays import float_alp as tfa  # noqa: E402
from liquid_tpu_torch.arrays import hybrid as thy  # noqa: E402
from liquid_tpu_torch.arrays import primitive as tprim  # noqa: E402
from liquid_tpu_torch.arrays.base import Predicate as TPred  # noqa: E402
from liquid_tpu_torch.device import words_to_numpy  # noqa: E402
from liquid_tpu_torch.ops import bitpack_cuda  # noqa: E402

OPS = ("eq", "ne", "lt", "lt_eq", "gt", "gt_eq")


class CountingIo:
    """An IO handler that serves the backing bytes and counts reads."""

    def __init__(self, backing: bytes):
        self.backing = backing
        self.reads = 0

    def read(self, rng):
        self.reads += 1
        if rng is None:
            return self.backing
        off, ln = rng
        return self.backing[off: off + ln]


def _ints(seed, n=8192, hi=1_000_000, ref=-500, gap=False):
    rng = np.random.default_rng(seed)
    v = ref + rng.integers(0, hi, n)
    if gap:  # two clusters: the buckets between them stay empty
        v = np.where(v - ref < hi // 2, ref + (v - ref) % 1000,
                     ref + hi - 1 - (v - ref) % 1000)
    return pa.array(v.astype(np.int64), mask=rng.random(n) < 0.03)


def _squeeze_pair(kind):
    """(reference squeezed, port squeezed, backing, reference liquid)."""
    if kind in ("clamp", "quantize"):
        arr = _ints(1, gap=kind == "quantize")
        j = jprim.LiquidPrimitiveArray.from_arrow(arr)
        t = tprim.LiquidPrimitiveArray.from_arrow(arr)
        f = (jhy.squeeze_primitive, thy.squeeze_primitive) if kind == \
            "clamp" else (jhy.squeeze_primitive_quantized,
                          thy.squeeze_primitive_quantized)
    elif kind == "float":
        rng = np.random.default_rng(2)
        v = np.round(rng.uniform(-20, 500, 8192), 2)
        v[::499] = np.pi * np.arange(v[::499].size)  # patches
        arr = pa.array(v, mask=rng.random(8192) < 0.02)
        j = jfa.LiquidFloatArray.from_arrow(arr)
        t = tfa.LiquidFloatArray.from_arrow(arr)
        f = (jfa.squeeze_float, tfa.squeeze_float)
    else:
        fsst = kind == "bv_fsst"
        rng = np.random.default_rng(3)
        words = [f"{'https://' if i % 3 else 'ftp://'}host{i % 41}/{i}"
                 for i in range(2500 if fsst else 40)]
        vals = [words[i] for i in rng.integers(0, len(words), 8192)]
        arr = pa.array([None if i % 13 == 0 else x
                        for i, x in enumerate(vals)])
        j = jbv.LiquidByteViewArray.from_arrow(arr)
        t = tbv.LiquidByteViewArray.from_arrow(arr)
        assert j.is_fsst == fsst
        f = (jhy.squeeze_byteview, thy.squeeze_byteview)
    jsq, jback = f[0](j)
    tsq, tback = f[1](t)
    assert tback == jback
    jsq._disk_range = tsq._disk_range = None  # the handler serves it all
    return jsq, tsq, jback, j


def _numeric_literals(kind, jsq, j):
    r = j.reference_value
    if kind == "float":
        stored = [x for x in j.to_arrow().to_pylist()[:50] if x is not None]
        return [-1e9, -20.0, 0.0, 3.25, 100.5, 100.49, 499.99, 1e9,
                float("nan"), 250, stored[3], stored[7] + 1e-9]
    if kind == "clamp":
        s = jsq.sentinel
        return [r - 10, r, r + 5, r + s // 2, r + s - 1, r + s, r + s + 1,
                r + (1 << 20), r + 10.5, float(r + 7)]
    bs = jsq.bucket_size
    return [r - 10, r, r + 5, r + 999, r + 1000, r + 3 * bs, r + 3 * bs - 1,
            r + 600_000, r + 999_999, r + (1 << 21), r + 10.5]


def _mask_pair(jsq, tsq, back, pred_args):
    jio, tio = CountingIo(back), CountingIo(back)
    jm = jsq.try_eval_predicate(JPred(*pred_args), jio)
    tm = tsq.try_eval_predicate(TPred(*pred_args), tio, "cpu")
    return jm, tm, jio.reads, tio.reads


def _assert_masks(jm, tm, what):
    assert (jm is None) == (tm is None), what
    if jm is None:
        return
    np.testing.assert_array_equal(words_to_numpy(tm.bits),
                                  np.asarray(jm.bits), err_msg=str(what))
    np.testing.assert_array_equal(words_to_numpy(tm.valid),
                                  np.asarray(jm.valid), err_msg=str(what))


NUMERIC = ("clamp", "quantize", "float")


@pytest.mark.parametrize("kind", NUMERIC)
@pytest.mark.parametrize("op", OPS)
def test_numeric_masks_and_io_equal_the_reference(kind, op):
    jsq, tsq, back, j = _squeeze_pair(kind)
    ios = []
    for lit in _numeric_literals(kind, jsq, j):
        jm, tm, jr, tr = _mask_pair(jsq, tsq, back, (op, lit))
        _assert_masks(jm, tm, (kind, op, lit))
        assert tr == jr, (kind, op, lit)
        ios.append(tr)
    # both IO-free and IO-reading literals occur in the sweep
    assert 0 in ios and max(ios) > 0, ios


STRING_LITS = ("", "ftp://", "https://host1/1", "https://host17/",
               "https://host40/2499", "zzz", "host3", "/7")


@pytest.mark.parametrize("kind", ("bv_raw", "bv_fsst"))
@pytest.mark.parametrize("op", OPS + ("contains", "starts_with",
                                      "ends_with"))
def test_byteview_masks_and_io_equal_the_reference(kind, op):
    jsq, tsq, back, _ = _squeeze_pair(kind)
    for lit in STRING_LITS:
        jm, tm, jr, tr = _mask_pair(jsq, tsq, back, (op, lit))
        _assert_masks(jm, tm, (kind, op, lit))
        assert tr == jr, (kind, op, lit)


@pytest.mark.parametrize("kind", NUMERIC + ("bv_raw", "bv_fsst"))
def test_decode_and_memory_bytes_equal_the_reference(kind):
    jsq, tsq, back, _ = _squeeze_pair(kind)
    assert tsq.memory_bytes() == jsq.memory_bytes()
    jio, tio = CountingIo(back), CountingIo(back)
    assert tsq.to_arrow(tio).equals(jsq.to_arrow(jio))
    assert tio.reads == jio.reads == 1
    assert tsq.disk_backing() == jsq.disk_backing()


def test_non_numeric_literals_have_no_packed_form():
    for kind in NUMERIC:
        _jsq, tsq, back, _ = _squeeze_pair(kind)
        io = CountingIo(back)
        assert tsq.try_eval_predicate(TPred("eq", "x"), io, "cpu") is None
        assert tsq.try_eval_predicate(TPred("contains", 1), io, "cpu") is None
        assert io.reads == 0


def _dates():
    rng = np.random.default_rng(4)
    d = rng.integers(-800, 20000, 7000)
    return pa.array(d.astype("datetime64[D]"), mask=rng.random(7000) < 0.05)


@pytest.mark.parametrize("field", ("year", "month", "day", "dow"))
def test_date32_component_read_equals_the_reference(field):
    arr = _dates()
    j = jprim.LiquidPrimitiveArray.from_arrow(arr)
    t = tprim.LiquidPrimitiveArray.from_arrow(arr)
    jsq, jback = jhy.squeeze_date32(j, field)
    tsq, tback = thy.squeeze_date32(t, field)
    assert tback == jback and tsq.memory_bytes() == jsq.memory_bytes()
    tv, tvalid = tsq.to_component_array(field, "cpu")
    jv, jvalid = jsq.to_component_array(field)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(words_to_numpy(tvalid), np.asarray(jvalid))
    other = "year" if field != "year" else "dow"
    assert tsq.to_component_array(other, "cpu") is None
    # a predicate on the date itself reads the backing
    jsq._disk_range = tsq._disk_range = None
    for lit in (0, 9000, 19999):
        jm, tm, jr, tr = _mask_pair(jsq, tsq, jback, ("lt", lit))
        _assert_masks(jm, tm, (field, lit))
        assert tr == jr == 1


def test_narrow_blocks_do_not_squeeze():
    arr = pa.array(np.arange(8192) % 4)
    assert thy.squeeze_primitive(tprim.LiquidPrimitiveArray.from_arrow(
        arr)) is None
    assert thy.squeeze_primitive_quantized(
        tprim.LiquidPrimitiveArray.from_arrow(arr)) is None
    assert tfa.squeeze_float(tfa.LiquidFloatArray.from_arrow(
        pa.array(np.arange(8192) % 4, pa.float64()))) is None
    assert thy.squeeze_date32(tprim.LiquidPrimitiveArray.from_arrow(arr),
                              "year") is None


# -- K1's single form for every packed compare of one block ---------------------

@pytest.fixture()
def k1_calls(monkeypatch):
    calls = []
    real = bitpack_cuda.cmp_const_many

    def counting(planes, cs):
        calls.append(tuple(planes.shape))
        return real(planes, cs)

    monkeypatch.setattr(bitpack_cuda, "cmp_const_many", counting)
    return calls


def _liquid_int(gap=False):
    return tprim.LiquidPrimitiveArray.from_arrow(_ints(5, gap=gap))


def _liquid_float():
    rng = np.random.default_rng(6)
    return tfa.LiquidFloatArray.from_arrow(
        pa.array(np.round(rng.uniform(0, 100, 8192), 2)))


#: (site, build, predicate, expected K1 calls): one per constant the site
#: compares against; the squeezed sites' literals are decided with no IO
#: (the clamped form compares the sentinel and the literal)
SITES = [
    ("primitive", _liquid_int, ("gt", 1000), 1),
    ("float_lt", _liquid_float, ("lt", 50.505), 1),
    ("float_gt_eq", _liquid_float, ("gt_eq", 50.505), 1),
    ("float_eq", _liquid_float, ("eq", 50.505), 2),
    ("clamped", lambda: thy.squeeze_primitive(_liquid_int())[0],
     ("gt", 100), 2),
    ("quantized", lambda: thy.squeeze_primitive_quantized(
        _liquid_int(gap=True))[0], ("lt", 500_000), 1),
    ("squeezed_float", lambda: tfa.squeeze_float(_liquid_float())[0],
     ("lt", 120.0), 1),
]


@pytest.mark.parametrize("site", SITES, ids=[s[0] for s in SITES])
def test_single_block_compares_run_k1(site, k1_calls):
    _name, build, pred, want = site
    block = build()
    if hasattr(block, "disk_backing"):
        io = CountingIo(b"")
        out = block.try_eval_predicate(TPred(*pred), io, "cpu")
        assert io.reads == 0
    else:
        out = block.try_eval_predicate(TPred(*pred), "cpu")
    assert out is not None
    assert len(k1_calls) == want, k1_calls
    assert all(s[0] == 1 and s[2] == 256 for s in k1_calls), k1_calls


def test_a_bucket_of_one_block_runs_k1(k1_calls, tmp_path):
    """The cache's batched scan: a width bucket holding a single block is
    one K1 call, as every bucket is."""
    from liquid_tpu_torch.cache.core import LiquidCacheBuilder
    cache = LiquidCacheBuilder().with_device("cpu").with_disk_path(
        str(tmp_path / "s.bin")).build()
    cache.insert(1, _ints(7, hi=1 << 20))     # 20 bits
    cache.insert(2, _ints(8, hi=1 << 12))     # 12 bits
    cache.insert(3, _ints(9, hi=1 << 12))
    masks = cache.eval_predicate_many([1, 2, 3], TPred("gt", 1000))
    assert all(m is not None for m in masks)
    assert sorted(s[0] for s in k1_calls) == [1, 2]
