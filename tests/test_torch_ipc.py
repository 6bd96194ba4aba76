"""Liquid IPC and the block store: the port against the JAX package, on the
CPU.

- `to_bytes()` of primitive blocks of every width 0..64 (nulls, a short
  last block, negative references), ALP floats with patches, linear
  blocks and byte-view blocks (raw and FSST dictionaries, nulls,
  fingerprints) equals the reference's byte for byte;
- each package's `deserialize` reads the other's bytes back to the same
  arrow array;
- the decimal, fixed-length and delta ids raise NotImplementedError in
  the port, naming the module that is missing;
- `PyBlockStore` behaves as the reference's (put, get, read_range,
  remove, compact, range_of, live and file bytes), and `NativeBlockStore`
  as `PyBlockStore`."""
import shutil

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
import pyarrow as pa  # noqa: E402

from liquid_tpu.arrays import byteview as jbv  # noqa: E402
from liquid_tpu.arrays import float_alp as jfa  # noqa: E402
from liquid_tpu.arrays import ipc as jipc  # noqa: E402
from liquid_tpu.arrays import linear as jlin  # noqa: E402
from liquid_tpu.arrays import primitive as jprim  # noqa: E402
from liquid_tpu.cache import store as jstore  # noqa: E402
from liquid_tpu_torch.arrays import byteview as tbv  # noqa: E402
from liquid_tpu_torch.arrays import float_alp as tfa  # noqa: E402
from liquid_tpu_torch.arrays import ipc as tipc  # noqa: E402
from liquid_tpu_torch.arrays import linear as tlin  # noqa: E402
from liquid_tpu_torch.arrays import primitive as tprim  # noqa: E402
from liquid_tpu_torch.cache import store as tstore  # noqa: E402


def _width_block(width: int, seed: int) -> pa.Array:
    """int64 values spanning exactly `width` bits around a negative
    reference, with nulls and a short length."""
    rng = np.random.default_rng(seed)
    n = 8192 - 37 * (width % 3)
    if width == 0:
        vals = np.full(n, -5, np.int64)
    elif width == 64:
        vals = rng.integers(-(1 << 63), (1 << 63) - 1, n, dtype=np.int64)
        vals[:2] = [-(1 << 63), (1 << 63) - 1]
    else:
        ref = -(1 << (width - 1)) - 3
        vals = ref + rng.integers(0, 1 << width, n, dtype=np.uint64
                                  ).astype(np.int64)
        vals[:2] = [ref, ref + (1 << width) - 1]
    mask = rng.random(n) < 0.05
    mask[:2] = False
    return pa.array(vals, pa.int64(), mask=mask if width % 2 else None)


def _urls(n, dict_size, seed, nulls):
    rng = np.random.default_rng(seed)
    words = [f"https://site{i % 97}.example/{'path/' * (i % 5)}{i}"
             for i in range(dict_size)]
    vals = [words[i] for i in rng.integers(0, dict_size, n)]
    if nulls:
        vals = [None if i % 11 == 0 else v for i, v in enumerate(vals)]
    return pa.array(vals, pa.string())


def _floats(seed):
    rng = np.random.default_rng(seed)
    v = np.round(rng.uniform(-50, 900, 8192), 2)
    v[::97] = rng.normal(size=v[::97].size)  # patches: no short decimal
    v[5] = np.nan
    v[6] = np.inf
    return pa.array(v, mask=rng.random(8192) < 0.02)


def _blocks():
    """(name, reference block, port block) per encoding case."""
    out = []
    for w in range(65):
        arr = _width_block(w, w)
        out.append((f"prim_w{w}", jprim.LiquidPrimitiveArray.from_arrow(arr),
                    tprim.LiquidPrimitiveArray.from_arrow(arr)))
    dates = pa.array(np.arange(19000, 19000 + 5000).astype("datetime64[D]"))
    out.append(("date32", jprim.LiquidPrimitiveArray.from_arrow(dates),
                tprim.LiquidPrimitiveArray.from_arrow(dates)))
    f = _floats(1)
    out.append(("alp_f64", jfa.LiquidFloatArray.from_arrow(f),
                tfa.LiquidFloatArray.from_arrow(f)))
    f32 = pa.array(np.round(np.random.default_rng(2).uniform(0, 10, 3000),
                            1).astype(np.float32))
    out.append(("alp_f32", jfa.LiquidFloatArray.from_arrow(f32),
                tfa.LiquidFloatArray.from_arrow(f32)))
    lin = pa.array(np.arange(8192, dtype=np.int64) * 7 + 1000
                   + np.random.default_rng(3).integers(0, 4, 8192),
                   mask=np.arange(8192) % 501 == 0)
    out.append(("linear", jlin.LiquidLinearArray.from_arrow(lin),
                tlin.LiquidLinearArray.from_arrow(lin)))
    for name, arr, fp in (
            ("bv_raw", _urls(8192, 30, 4, True), False),
            ("bv_raw_fp", _urls(500, 20, 5, False), True),
            ("bv_fsst", _urls(8192, 3000, 6, True), False),
            ("bv_fsst_fp", _urls(7000, 2000, 7, False), True)):
        out.append((name, jbv.LiquidByteViewArray.from_arrow(
            arr, with_fingerprints=fp),
            tbv.LiquidByteViewArray.from_arrow(arr, with_fingerprints=fp)))
    return out


def _same(a: pa.Array, b: pa.Array) -> bool:
    """Equal arrays; a NaN equals a NaN."""
    if a.equals(b):
        return True
    if not (a.type.equals(b.type) and pa.types.is_floating(a.type)):
        return False
    va, vb = (np.asarray(x.fill_null(0), dtype=np.float64) for x in (a, b))
    return (np.array_equal(np.asarray(a.is_valid()), np.asarray(b.is_valid()))
            and np.array_equal(va, vb, equal_nan=True))


BLOCKS = _blocks()
IDS = [b[0] for b in BLOCKS]


@pytest.mark.parametrize("case", BLOCKS, ids=IDS)
def test_bytes_equal_the_reference(case):
    _name, j, t = case
    assert t.to_bytes() == j.to_bytes()


@pytest.mark.parametrize("case", BLOCKS, ids=IDS)
def test_each_package_reads_the_others_bytes(case):
    _name, j, t = case
    want = j.to_arrow()
    from_ref = tipc.deserialize(j.to_bytes())
    assert type(from_ref) is type(t)
    assert _same(from_ref.to_arrow(), want)
    assert from_ref.to_bytes() == j.to_bytes()
    from_port = jipc.deserialize(t.to_bytes())
    assert type(from_port) is type(j)
    assert _same(from_port.to_arrow(), t.to_arrow())


def test_fsst_blocks_serialize_their_symbol_table():
    j = jbv.LiquidByteViewArray.from_arrow(_urls(4000, 900, 8, False))
    t = tipc.deserialize(j.to_bytes())
    assert t.is_fsst
    assert t.fsst.to_bytes() == j.fsst.to_bytes()
    assert t.dictionary.equals(j.dictionary)


def _ref_bytes_of(kind):
    from liquid_tpu.arrays import decimal as jdec
    if kind == "decimal":
        arr = pa.array([1, 2, None, 12345], pa.decimal128(10, 2))
        return jdec.LiquidDecimalArray.from_arrow(arr).to_bytes()
    if kind == "fixedlen":
        arr = pa.array([10 ** 30, -5, None], pa.decimal128(38, 0))
        return jdec.LiquidFixedLenByteArray.from_arrow(arr).to_bytes()
    arr = pa.array(np.cumsum(np.arange(100, dtype=np.int64)))
    return jlin.LiquidPrimitiveDeltaArray.from_arrow(arr).to_bytes()


@pytest.mark.parametrize("kind,module", [
    ("decimal", "arrays/decimal.py"), ("fixedlen", "arrays/decimal.py"),
    ("delta", "arrays/linear.py")])
def test_unported_encodings_raise_naming_their_module(kind, module):
    data = _ref_bytes_of(kind)
    with pytest.raises(NotImplementedError, match=module):
        tipc.deserialize(data)


def test_bad_header_raises():
    data = bytearray(BLOCKS[5][2].to_bytes())
    data[:4] = b"NOPE"
    with pytest.raises(ValueError, match="magic"):
        tipc.deserialize(bytes(data))


def _store_script(store, rng):
    """A put / replace / remove / compact workload -> what it observed."""
    seen = []
    blobs = {k: rng.bytes(int(rng.integers(1, 5000))) for k in range(12)}
    for k, b in blobs.items():
        seen.append(("put", store.put(k, b)))
    seen.append(("replace", store.put(3, b"x" * 777)))
    blobs[3] = b"x" * 777
    for k in (1, 5, 9, 99):
        seen.append(("remove", k, store.remove(k)))
        blobs.pop(k, None)
    seen.append(("bytes", store.live_bytes, store.file_bytes))
    for k in range(13):
        got = store.get(k)
        seen.append(("get", k, got == blobs.get(k)))
        rng_k = store.range_of(k)
        seen.append(("range", k, rng_k))
        if rng_k is not None:
            seen.append(("read_range", store.read_range(rng_k) == blobs[k]))
        assert store.contains(k) == (k in blobs)
    store.compact()
    seen.append(("compacted", store.live_bytes, store.file_bytes))
    for k in blobs:
        seen.append(("after", k, store.range_of(k), store.get(k) == blobs[k]))
    return seen


def test_py_block_store_matches_the_reference(tmp_path):
    a = tstore.PyBlockStore(str(tmp_path / "t" / "s.bin"))
    b = jstore.PyBlockStore(str(tmp_path / "j" / "s.bin"))
    got = _store_script(a, np.random.default_rng(0))
    want = _store_script(b, np.random.default_rng(0))
    assert got == want
    assert all(x[-1] for x in got if x[0] in ("get", "read_range", "after"))
    a.close()
    b.close()


def test_native_block_store_matches_the_python_store(tmp_path):
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this host: the native store cannot be built")
    a = tstore.NativeBlockStore(str(tmp_path / "n" / "s.bin"))
    b = tstore.PyBlockStore(str(tmp_path / "p" / "s.bin"))
    assert _store_script(a, np.random.default_rng(1)) == _store_script(
        b, np.random.default_rng(1))
    assert isinstance(tstore.BlockStore(str(tmp_path / "d.bin")),
                      tstore.NativeBlockStore)
    a.close()
    b.close()
