"""The class members, parameters and constants the port gained to match the
JAX package, held against it on the CPU on the same seeded inputs:

- `LiquidArray.filter(selection)` on primitive, date, float, byte-view,
  linear, delta, decimal and fixed-length blocks, with nulls, for a
  random, an all-true and an all-false selection;
- the base `try_eval_predicate`, which answers None;
- `SqueezedFloatArray.filter(selection, io)`: the same rows and the same
  backing reads, counted through the cache's squeeze IO;
- `BoolMask.from_bools` at lengths on and off a multiple of 32, and the
  Kleene cases of `tests/test_mask.py`;
- `RuntimeStats.reset`, `out_dtype` of `unpack_bitplanes_host` and
  `unpack_bitplanes_many`, `make_mesh(n_devices=...)` and the constants
  `BLOCK_ROWS`, `CMP_OPS` and `RADIX`;
- an arrow block read from a row group of several blocks is charged the
  bytes its slice references (`nbytes` + 64), not its row group's
  buffers as the reference charges it."""
import itertools
from decimal import Decimal

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pyarrow as pa  # noqa: E402
import pyarrow.parquet as pq  # noqa: E402

import liquid_tpu  # noqa: E402,F401  (x64, as the reference runs)
import liquid_tpu.arrays as jarrays  # noqa: E402
from liquid_tpu.arrays import byteview as jbv  # noqa: E402
from liquid_tpu.arrays import decimal as jdec  # noqa: E402
from liquid_tpu.arrays import float_alp as jfa  # noqa: E402
from liquid_tpu.arrays import linear as jlin  # noqa: E402
from liquid_tpu.arrays import primitive as jprim  # noqa: E402
from liquid_tpu.cache import core as jcore  # noqa: E402
from liquid_tpu.cache import observer as jobs  # noqa: E402
from liquid_tpu.ops import bitpack as jbp  # noqa: E402
from liquid_tpu.ops import mask as jm  # noqa: E402
from liquid_tpu.ops import sort as jsort  # noqa: E402
from liquid_tpu.parallel import dist as jdist  # noqa: E402
import liquid_tpu_torch.arrays as tarrays  # noqa: E402
from liquid_tpu_torch import LiquidCacheLocalBuilder  # noqa: E402
from liquid_tpu_torch.arrays import byteview as tbv  # noqa: E402
from liquid_tpu_torch.arrays import decimal as tdec  # noqa: E402
from liquid_tpu_torch.arrays import float_alp as tfa  # noqa: E402
from liquid_tpu_torch.arrays import linear as tlin  # noqa: E402
from liquid_tpu_torch.arrays import primitive as tprim  # noqa: E402
from liquid_tpu_torch.arrays.base import LiquidArray  # noqa: E402
from liquid_tpu_torch.arrays.base import Predicate as TPred  # noqa: E402
from liquid_tpu_torch.cache import core as tcore  # noqa: E402
from liquid_tpu_torch.cache import observer as tobs  # noqa: E402
from liquid_tpu_torch.device import words_to_numpy, words_to_tensor  # noqa: E402
from liquid_tpu_torch.ops import bitpack as tbp  # noqa: E402
from liquid_tpu_torch.ops import mask as tm  # noqa: E402
from liquid_tpu_torch.ops import sort as tsort  # noqa: E402
from liquid_tpu_torch.parallel import dist as tdist  # noqa: E402

N = 8192


def _same(a: pa.Array, b: pa.Array) -> bool:
    """Equal arrays; a NaN equals a NaN."""
    if a.equals(b):
        return True
    if not (a.type.equals(b.type) and pa.types.is_floating(a.type)):
        return False
    va, vb = (np.asarray(x.fill_null(0), dtype=np.float64) for x in (a, b))
    return (np.array_equal(np.asarray(a.is_valid()), np.asarray(b.is_valid()))
            and np.array_equal(va, vb, equal_nan=True))


def _arrow_cases():
    """name -> (arrow block, reference class, port class)."""
    rng = np.random.default_rng(11)
    nulls = rng.random(N) < 0.07
    ints = pa.array(rng.integers(-3000, 90_000, N), mask=nulls)
    dates = pa.array((19000 + rng.integers(0, 4000, 5000)).astype(
        "datetime64[D]"))
    floats = np.round(rng.uniform(-50, 900, N), 2)
    floats[::97] = rng.normal(size=floats[::97].size)  # patches
    floats[5] = np.nan
    words = [f"https://site{i % 31}.example/{'p/' * (i % 4)}{i}"
             for i in range(400)]
    strings = pa.array([None if i % 13 == 0 else words[k] for i, k in
                        enumerate(rng.integers(0, 400, N))], pa.string())
    linear = pa.array(np.arange(N, dtype=np.int64) * 7 + 1000
                      + rng.integers(0, 4, N), mask=np.arange(N) % 501 == 0)
    delta = pa.array(np.cumsum(rng.integers(-3, 9, N)).astype(np.int64))
    dec = pa.array([None if i % 17 == 0 else Decimal(int(v)).scaleb(-2)
                    for i, v in enumerate(
                        rng.integers(-10 ** 6, 10 ** 6, 3000))],
                   pa.decimal128(12, 2))
    wide = pa.array([None if i % 9 == 0 else (10 ** 30) * (i % 5) - i
                     for i in range(2000)], pa.decimal128(38, 0))
    return {
        "primitive": (ints, jprim.LiquidPrimitiveArray,
                      tprim.LiquidPrimitiveArray),
        "date32": (dates, jprim.LiquidPrimitiveArray,
                   tprim.LiquidPrimitiveArray),
        "float": (pa.array(floats, mask=rng.random(N) < 0.03),
                  jfa.LiquidFloatArray, tfa.LiquidFloatArray),
        "byteview": (strings, jbv.LiquidByteViewArray,
                     tbv.LiquidByteViewArray),
        "linear": (linear, jlin.LiquidLinearArray, tlin.LiquidLinearArray),
        "delta": (delta, jlin.LiquidPrimitiveDeltaArray,
                  tlin.LiquidPrimitiveDeltaArray),
        "decimal": (dec, jdec.LiquidDecimalArray, tdec.LiquidDecimalArray),
        "fixedlen": (wide, jdec.LiquidFixedLenByteArray,
                     tdec.LiquidFixedLenByteArray),
    }


CASES = _arrow_cases()


def _selection(kind, seed=5):
    """Packed uint32 words over BLOCK_ROWS."""
    if kind == "none":
        bools = np.zeros(N, bool)
    elif kind == "all":
        bools = np.ones(N, bool)
    else:
        bools = np.random.default_rng(seed).random(N) < 0.3
    return jm.pack_bools_host(bools)


@pytest.mark.parametrize("sel", ["random", "all", "none"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_filter_equals_the_reference(case, sel):
    arr, jcls, tcls = CASES[case]
    j, t = jcls.from_arrow(arr), tcls.from_arrow(arr)
    words = _selection(sel)
    want = j.filter(jnp.asarray(words))
    got = t.filter(words_to_tensor(words, "cpu"))
    assert got.type.equals(want.type)
    assert _same(got, want)
    kept = np.flatnonzero(jm.unpack_bits_host(words)[: len(arr)])
    if pa.types.is_dictionary(got.type):  # a byte-view block's arrow form
        got = got.cast(got.type.value_type)
    assert _same(got, arr.take(pa.array(kept, pa.int64())))


def test_the_base_predicate_default_is_none():
    class Plain(LiquidArray):
        length = 0
        arrow_type = pa.int64()

        def memory_bytes(self):
            return 0

        def to_arrow(self):
            return pa.array([], pa.int64())

        def to_device(self, device):
            return None, None

        def to_bytes(self):
            return b""

    assert Plain().try_eval_predicate(TPred("eq", 1), "cpu") is None


class _CountingIo:
    def __init__(self, backing: bytes):
        self.backing, self.reads = backing, 0

    def read(self, rng):
        self.reads += 1
        return self.backing if rng is None else \
            self.backing[rng[0]: rng[0] + rng[1]]


@pytest.mark.parametrize("sel", ["random", "none"])
def test_squeezed_float_filter_equals_the_reference(sel):
    arr = CASES["float"][0]
    (jsq, jback), (tsq, tback) = (
        jfa.squeeze_float(jfa.LiquidFloatArray.from_arrow(arr)),
        tfa.squeeze_float(tfa.LiquidFloatArray.from_arrow(arr)))
    assert jback == tback
    jsq._disk_range = tsq._disk_range = (0, len(tback))
    jio, tio = _CountingIo(jback), _CountingIo(tback)
    words = _selection(sel)
    want = jsq.filter(jnp.asarray(words), jio)
    got = tsq.filter(words_to_tensor(words, "cpu"), tio)
    assert _same(got, want)
    assert tio.reads == jio.reads == 1


def _squeezed_float_cache(side, tmp_path):
    rng = np.random.default_rng(6)
    arr = pa.array(np.round(rng.uniform(0, 100, N), 2))
    b = (jcore.LiquidCacheBuilder() if side == "j"
         else tcore.LiquidCacheBuilder().with_device("cpu"))
    cache = (b.with_max_memory_bytes(1 << 24)
             .with_disk_path(str(tmp_path / side / "s.bin")).build())
    cache.insert(3, arr)  # transcoded on insert: a liquid float block
    cache._squeeze_victim(3)
    return cache, arr


def test_squeezed_float_filter_counts_its_read_in_the_cache(tmp_path):
    words = _selection("random", seed=9)
    outs = []
    for side, core, sel in (("j", jcore, jnp.asarray(words)),
                            ("t", tcore, words_to_tensor(words, "cpu"))):
        cache, arr = _squeezed_float_cache(side, tmp_path)
        e = cache._entries[3]
        assert e.state == core.MEMORY_SQUEEZED
        before = cache.stats()["squeeze_io_reads"]
        out = e.payload.filter(sel, core._SqueezeIo(cache, 3))
        outs.append((out, cache.stats()["squeeze_io_reads"] - before))
    (jout, jreads), (tout, treads) = outs
    assert _same(tout, jout) and treads == jreads == 1
    kept = np.flatnonzero(jm.unpack_bits_host(words))
    assert _same(tout, arr.take(pa.array(kept, pa.int64())))


def _mask_words(mask_obj, port):
    if port:
        return words_to_numpy(mask_obj.bits), words_to_numpy(mask_obj.valid)
    return np.asarray(mask_obj.bits), np.asarray(mask_obj.valid)


@pytest.mark.parametrize("with_valid", [False, True])
@pytest.mark.parametrize("n", [32, 64, 8192, 1, 33, 100, 8191])
def test_from_bools_equals_the_reference(n, with_valid):
    rng = np.random.default_rng(n)
    bools = rng.random(n) < 0.5
    valid = rng.random(n) < 0.8 if with_valid else None
    pad = -n % 32  # the reference takes whole words only
    jb = np.concatenate([bools, np.zeros(pad, bool)])
    jv = None if valid is None else np.concatenate(
        [valid, np.zeros(pad, bool)])
    want = jm.BoolMask.from_bools(
        jnp.asarray(jb), None if jv is None else jnp.asarray(jv))
    got = tm.BoolMask.from_bools(
        torch.from_numpy(bools), None if valid is None
        else torch.from_numpy(valid))
    for w, g in zip(_mask_words(want, False), _mask_words(got, True)):
        np.testing.assert_array_equal(g, w)


def _kleene_table():
    """(a bits, a valid, b bits, b valid) over every pair of T, F, NULL."""
    vals = [(True, True), (False, True), (False, False)]
    rows = list(itertools.product(vals, vals))
    return [np.array([r[i][k] for r in rows])
            for i, k in ((0, 0), (0, 1), (1, 0), (1, 1))]


@pytest.mark.parametrize("op", ["or_kleene", "and_kleene"])
def test_from_bools_kleene_cases_equal_the_reference(op):
    a_bits, a_valid, b_bits, b_valid = _kleene_table()
    pad = np.zeros(32 - len(a_bits), bool)
    ja, jb = (jm.BoolMask.from_bools(jnp.asarray(np.concatenate([x, pad])),
                                     jnp.asarray(np.concatenate([v, pad])))
              for x, v in ((a_bits, a_valid), (b_bits, b_valid)))
    ta, tb = (tm.BoolMask.from_bools(torch.from_numpy(x),
                                     torch.from_numpy(v))
              for x, v in ((a_bits, a_valid), (b_bits, b_valid)))
    want, got = getattr(ja, op)(jb), getattr(ta, op)(tb)
    np.testing.assert_array_equal(words_to_numpy(got.to_selection()),
                                  np.asarray(want.to_selection()))
    np.testing.assert_array_equal(words_to_numpy(got.valid),
                                  np.asarray(want.valid))
    # test_mask.py's AND case: false AND null = false, true AND null = null
    if op == "and_kleene":
        v = tm.unpack_bits(got.valid)
        assert bool(v[5]) and not bool(v[2])


def test_runtime_stats_reset_equals_the_reference():
    j, t = jobs.RuntimeStats(), tobs.RuntimeStats()
    for s in (j, t):
        s.bump("gets", 3)
        s.bump("disk_reads")
    assert t.snapshot() == j.snapshot()
    j.reset()
    t.reset()
    assert t.snapshot() == j.snapshot()
    assert set(t.snapshot().values()) == {0}


DTYPES = ["bool", "uint8", "int8", "uint16", "int16", "uint32", "int32",
          "uint64", "int64", "float16", "float32", "float64"]


def _planes(width, seed):
    rng = np.random.default_rng(seed)
    if width == 64:
        v = rng.integers(0, 1 << 63, 2 * N, dtype=np.uint64) * np.uint64(2) \
            + rng.integers(0, 2, 2 * N).astype(np.uint64)
    else:
        v = rng.integers(0, 1 << width, 2 * N, dtype=np.uint64)
    return np.stack([jbp.pack_bitplanes_host(v[:N], width),
                     jbp.pack_bitplanes_host(v[N:], width)])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("width", [0, 5, 20, 33, 64])
def test_unpack_out_dtype_equals_the_reference(width, dtype):
    stack = _planes(width, width)
    want_h = jbp.unpack_bitplanes_host(stack[0], np.dtype(dtype))
    got_h = tbp.unpack_bitplanes_host(stack[0], np.dtype(dtype))
    assert got_h.dtype == want_h.dtype
    np.testing.assert_array_equal(got_h, want_h)
    want = np.asarray(jbp.unpack_bitplanes_many(jnp.asarray(stack),
                                                getattr(jnp, dtype)))
    got = tbp.unpack_bitplanes_many(words_to_tensor(stack, "cpu"),
                                    getattr(jnp, dtype)).numpy()
    # the wide unsigned types come back as their signed bit images
    assert got.dtype.itemsize == want.dtype.itemsize
    np.testing.assert_array_equal(got.view(want.dtype), want)
    one = tbp.unpack_bitplanes(words_to_tensor(stack[0], "cpu"),
                               np.dtype(dtype)).numpy()
    np.testing.assert_array_equal(one.view(want.dtype), want[0])


@pytest.mark.parametrize("dtype", DTYPES)
def test_unpack_wide_values_with_zero_low_words(dtype):
    """Values of 41 bits whose low 32 bits are zero: the reference's
    narrow types see only the low word, its 8-byte types all of it."""
    rng = np.random.default_rng(41)
    v = rng.integers(0, 1 << 41, N, dtype=np.uint64)
    v[::3] &= np.uint64(0xFFFFFF00000000)
    v[1::7] = np.uint64(1 << 40)
    stack = jbp.pack_bitplanes_host(v, 41)[None]
    want = np.asarray(jbp.unpack_bitplanes_many(jnp.asarray(stack),
                                                getattr(jnp, dtype)))
    got = tbp.unpack_bitplanes_many(words_to_tensor(stack, "cpu"),
                                    getattr(jnp, dtype)).numpy()
    assert got.dtype.itemsize == want.dtype.itemsize
    np.testing.assert_array_equal(got.view(want.dtype), want)


def test_unpack_default_is_the_u64_image():
    stack = _planes(33, 1)
    got = tbp.unpack_bitplanes_many(words_to_tensor(stack, "cpu"))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(
        got.numpy().view(np.uint64),
        np.asarray(jbp.unpack_bitplanes_many(jnp.asarray(stack),
                                             jnp.uint64)))


def test_make_mesh_takes_n_devices():
    want = jdist.make_mesh(n_devices=1)
    got = tdist.make_mesh(n_devices=1, devices=["cpu"])
    assert got.n == want.devices.size == 1
    assert tdist.make_mesh(n_devices=4, devices=["cpu"] * 4).n == 4
    with pytest.raises(ValueError):
        tdist.make_mesh(n=2, n_devices=3, devices=["cpu"] * 3)
    with pytest.raises(ValueError):
        jdist.make_mesh(n_devices=len(jdist.jax.devices()) + 1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tdist.make_mesh(n_devices=1)


def test_constants_equal_the_reference():
    assert tarrays.BLOCK_ROWS == jarrays.BLOCK_ROWS
    assert tarrays.CMP_OPS == jarrays.CMP_OPS
    assert tsort.RADIX == jsort.RADIX


# -- arrow blocks charged their own bytes ----------------------------------

def _json_docs(n, seed):
    rng = np.random.default_rng(seed)
    kinds = ["commit", "identity", "account"]
    return pa.array([
        None if i % 41 == 0 else
        f'{{"did":"did:plc:{rng.integers(1 << 40):x}","kind":'
        f'"{kinds[i % 3]}","time_us":{1_700_000_000_000_000 + i * 977},'
        f'"commit":{{"collection":"app.bsky.feed.post","rev":"{i:08x}"}}}}'
        for i in range(n)], pa.string())


def test_arrow_blocks_are_charged_their_slice(tmp_path):
    """One row group of four blocks (three whole, one short): each arrow
    block is charged its slice's `nbytes` + 64, and the four together
    about the column once; the reference charges each the row group's
    buffers."""
    n = 3 * N + 1234
    path = str(tmp_path / "events.parquet")
    pq.write_table(pa.table({"event": _json_docs(n, 8)}), path,
                   row_group_size=n)
    ctx, cache = (LiquidCacheLocalBuilder(device="cpu")
                  .with_max_memory_bytes(1 << 30)
                  .with_transcode_on_insert(False)
                  .with_cache_dir(str(tmp_path / "c")).build())
    ctx.register_parquet("events", path)
    table = ctx._tables["events"]
    ids = table.ensure_cached(0, "event")
    assert len(ids) == 4
    st = cache.stats()
    assert st["by_state"] == {tcore.MEMORY_ARROW: 4}
    column = pq.read_table(path).column("event").combine_chunks()
    blocks = [column.slice(b * N, N) for b in range(4)]
    assert st["memory_used"] == sum(b.nbytes + 64 for b in blocks)
    for eid, b in zip(ids, blocks):
        assert cache._entries[eid].mem_bytes == b.nbytes + 64
    # the reference's count: every block the whole row group
    whole = sum(x.size for x in column.buffers() if x is not None)
    assert [jcore._arrow_memory_bytes(b) for b in blocks] == [whole + 64] * 4
    assert st["memory_used"] < whole + 4 * 64 + 64
    # answers are unchanged: the blocks read back as the column
    got = pa.concat_arrays([cache.get(eid) for eid in ids])
    assert got.equals(column)


def test_whole_arrays_keep_the_reference_count():
    rng = np.random.default_rng(4)
    for arr in (pa.array(rng.integers(0, 9, 5000)),
                pa.array(rng.random(N), mask=rng.random(N) < 0.1),
                _json_docs(3000, 2),
                pa.array(rng.random(777) < 0.5),
                pa.array(["a", "b", "a"] * 50).dictionary_encode(),
                pa.StructArray.from_arrays(
                    [pa.array([1, 2, 3]), pa.array(["x", "y", None])],
                    ["i", "s"]),
                pa.array([[1, 2], None, [3]] * 40),
                pa.array([{"k": [1, 2]}, {"k": None}, None] * 40)):
        assert tcore._arrow_memory_bytes(arr) == \
            jcore._arrow_memory_bytes(arr)
        part = arr.slice(len(arr) // 3, len(arr) // 3)
        assert tcore._arrow_memory_bytes(part) == part.nbytes + 64
        # a leading slice has no offset, yet references part of its buffers
        head = arr.slice(0, len(arr) // 3)
        assert tcore._arrow_memory_bytes(head) == head.nbytes + 64
