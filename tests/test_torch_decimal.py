"""The port's decimal, fixed-length and delta blocks against the JAX
package's and pyarrow, on the CPU.

- Blocks: decimal128 at precision <= 18 and at 38 (values inside and
  outside i64) and decimal256, with nulls and negatives: the same block
  class, planes, width, reference, validity and codes as the reference's
  (bit for bit), and `to_arrow` equal to the input.
- Masks: every operator with literals the scale can and cannot
  represent, NaN, infinities, Decimals and out-of-range literals, equal
  to pyarrow's compare on the decoded column (exact), on the single-block
  path and through `LiquidCache.eval_predicate_many` with several blocks
  in one width bucket; there the reference's cache compares raw literals
  against the unscaled values (its known defect: `l_quantity < 24`
  counts 0), and its batched decode returns unscaled values.
- Squeezes: a decimal block takes no squeezed integer form (clamped or
  quantized) in the port and answers like pyarrow after a squeeze; the
  reference's quantized form answers raw literals (its defect).
- IPC: bytes equal to the reference's and read across both packages,
  for decimal, fixed-length and delta blocks; delta decode on the device
  (cumsum) and its masks equal pyarrow.
- SQL on SF 0.01 TPC-H with the specification's DECIMAL(15,2) columns:
  q6, q14, q19, `sum(l_quantity) GROUP BY l_returnflag` and
  `count(*) WHERE l_quantity < 24` equal pyarrow on the decimal file
  (decimals exact, q14's float to rtol 1e-9) and, cast to float64, the
  same queries on the float file to rtol 1e-9, on the classic route
  (`fused_agg.STATS` names "decimal column"); q1, q8 and q9 raise
  pyarrow's decimal precision error in both packages.
"""
import decimal as pydec
import math

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402
import pyarrow as pa  # noqa: E402
import pyarrow.compute as pc  # noqa: E402
import pyarrow.parquet as pq  # noqa: E402

from liquid_tpu.arrays import ipc as jipc  # noqa: E402
from liquid_tpu.arrays import linear as jlin  # noqa: E402
from liquid_tpu.arrays.base import Predicate as JPred  # noqa: E402
from liquid_tpu.cache import LiquidCacheBuilder as JCacheBuilder  # noqa: E402
from liquid_tpu.cache import transcode as jtc  # noqa: E402
from liquid_tpu.ops import mask as jmops  # noqa: E402
from liquid_tpu.sql.session import LiquidCacheLocalBuilder as JBuilder  # noqa: E402
from liquid_tpu_torch.arrays import decimal as tdec  # noqa: E402
from liquid_tpu_torch.arrays import ipc as tipc  # noqa: E402
from liquid_tpu_torch.arrays import linear as tlin  # noqa: E402
from liquid_tpu_torch.arrays.base import Predicate as TPred  # noqa: E402
from liquid_tpu_torch.bench import oracle  # noqa: E402
from liquid_tpu_torch.bench import tpch_data  # noqa: E402
from liquid_tpu_torch.bench.tpch_queries import QUERIES  # noqa: E402
from liquid_tpu_torch.cache import transcode as ttc  # noqa: E402
from liquid_tpu_torch.cache.core import LiquidCacheBuilder  # noqa: E402
from liquid_tpu_torch.device import words_to_numpy  # noqa: E402
from liquid_tpu_torch.ops import mask as tmops  # noqa: E402
from liquid_tpu_torch.sql import fused_agg  # noqa: E402
from liquid_tpu_torch.sql.session import LiquidCacheLocalBuilder  # noqa: E402

D = pydec.Decimal


def _dec_array(unscaled, t, seed, nulls=True):
    """A decimal array of type t from python ints (unscaled), with nulls."""
    rng = np.random.default_rng(seed)
    vals = [D(int(v)).scaleb(-t.scale) for v in unscaled]
    if nulls:
        vals = [None if rng.random() < 0.05 else v for v in vals]
    return pa.array(vals, type=t)


def _cases():
    rng = np.random.default_rng(0)
    small = rng.integers(-500_000, 900_000, 8192)
    small[:3] = [-999_999_999_999, 0, 999_999_999_999]  # 15 digits
    fit38 = rng.integers(-(1 << 62), 1 << 62, 5000)
    big = [int(v) * (10 ** 20) + 7 for v in rng.integers(-99, 99, 3000)]
    return [
        ("d15_2", _dec_array(small, pa.decimal128(15, 2), 1)),
        ("d15_2_short", _dec_array(small[:1000], pa.decimal128(15, 2), 2,
                                   nulls=False)),
        ("d38_4_fits", _dec_array(fit38, pa.decimal128(38, 4), 3)),
        ("d38_0_big", _dec_array(big, pa.decimal128(38, 0), 4)),
        ("d256_fits", _dec_array(small[:4000], pa.decimal256(40, 3), 5)),
        ("d256_big", _dec_array([int(v) * 10 ** 30 for v in small[:2000]],
                                pa.decimal256(60, 6), 6)),
    ]


CASES = _cases()
IDS = [c[0] for c in CASES]


@pytest.mark.parametrize("name,arr", CASES, ids=IDS)
def test_blocks_equal_the_reference(name, arr):
    t, j = ttc.transcode(arr), jtc.transcode(arr)
    assert type(t).__name__ == type(j).__name__
    assert ("big" in name) == isinstance(t, tdec.LiquidFixedLenByteArray)
    if isinstance(t, tdec.LiquidDecimalArray):
        np.testing.assert_array_equal(t.planes_np, np.asarray(j._planes))
        assert (t.width, t.reference_value) == (j.width, j.reference_value)
        jv = j._validity
        assert (t.validity_np is None) == (jv is None)
        if jv is not None:
            np.testing.assert_array_equal(t.validity_np, np.asarray(jv))
    else:
        np.testing.assert_array_equal(t.codes_np, np.asarray(j.codes))
        assert t.fsst.to_bytes() == j.fsst.to_bytes()
        assert t.memory_bytes() == j.memory_bytes()
    assert t.to_arrow().equals(arr)
    assert t.to_arrow().equals(j.to_arrow())
    vals, _valid = t.to_device("cpu")
    assert vals.shape[0] == 8192


def _literals(arr):
    """Literals around the column: its own values, half-steps the scale
    cannot represent, ints, floats, Decimals, NaN, infinities and values
    beyond i64 and the block's range."""
    scale = arr.type.scale
    live = [v for v in arr.to_pylist() if v is not None]
    lo, hi, mid = min(live), max(live), live[len(live) // 2]
    step = D(1).scaleb(-scale)
    out = [mid, lo, hi, mid + step / 2, lo - step / 2, hi + step / 2,
           float(mid), float(mid + step / 2), int(mid), 0, -1,
           float("nan"), float("inf"), float("-inf"), 10 ** 30, -(10 ** 30),
           1e300]
    return out


def _oracle_mask(arr, op, lit):
    fn = {"eq": pc.equal, "ne": pc.not_equal, "lt": pc.less,
          "lt_eq": pc.less_equal, "gt": pc.greater,
          "gt_eq": pc.greater_equal}[op]
    if isinstance(lit, float) and not math.isfinite(lit):
        return np.asarray(fn(arr.cast(pa.float64()), pa.scalar(lit))
                          .fill_null(False))
    d = D(repr(lit)) if isinstance(lit, float) else D(lit)
    try:
        return np.asarray(fn(arr, pa.scalar(d)).fill_null(False))
    except pa.ArrowInvalid:  # wider than decimal256: compare in Python
        py = {"eq": "__eq__", "ne": "__ne__", "lt": "__lt__",
              "lt_eq": "__le__", "gt": "__gt__", "gt_eq": "__ge__"}[op]
        return np.array([v is not None and getattr(v, py)(d)
                         for v in arr.to_pylist()], dtype=bool)


OPS = ("eq", "ne", "lt", "lt_eq", "gt", "gt_eq")


def _selection(mask, n):
    return tmops.unpack_bits_host(words_to_numpy(mask.to_selection()))[:n]


@pytest.mark.parametrize("name,arr", CASES, ids=IDS)
def test_single_block_masks_equal_pyarrow(name, arr):
    t = ttc.transcode(arr)
    j = jtc.transcode(arr)
    for op in OPS:
        for lit in _literals(arr):
            want = _oracle_mask(arr, op, lit)
            m = t.try_eval_predicate(TPred(op, lit), "cpu")
            if m is None:  # no verdict form: the caller decodes
                assert isinstance(t, tdec.LiquidFixedLenByteArray)
                continue
            np.testing.assert_array_equal(_selection(m, len(arr)), want,
                                          err_msg=f"{op} {lit!r}")
            if isinstance(t, tdec.LiquidDecimalArray) and not (
                    isinstance(lit, float) and math.isinf(lit)):
                jm = j.try_eval_predicate(JPred(op, lit))
                np.testing.assert_array_equal(
                    np.asarray(jmops.unpack_bits(jm.to_selection()))[
                        :len(arr)], want)


def _quantity_blocks(n_blocks=4):
    rng = np.random.default_rng(7)
    qty = rng.integers(1, 51, n_blocks * 8192)
    return [_dec_array(qty[i * 8192:(i + 1) * 8192] * 100,
                       pa.decimal128(15, 2), 10 + i) for i in range(n_blocks)]


def _caches(tmp_path, mode="clamp", mem=1 << 30):
    j = (JCacheBuilder().with_max_memory_bytes(mem)
         .with_disk_path(str(tmp_path / "j.bin"))
         .with_integer_squeeze_policy(mode).build())
    t = (LiquidCacheBuilder().with_device("cpu").with_max_memory_bytes(mem)
         .with_disk_path(str(tmp_path / "t.bin"))
         .with_integer_squeeze_policy(mode).build())
    return j, t


def test_batched_masks_and_decode_give_pyarrow(tmp_path, monkeypatch):
    """Four decimal blocks of one width bucket go through ONE K1 call in
    `eval_predicate_many` and one batched decode; both answer in the
    decimal's units, where the reference's cache does not."""
    from liquid_tpu_torch.ops import bitpack_cuda
    blocks = _quantity_blocks()
    jc, tc = _caches(tmp_path)
    for i, b in enumerate(blocks):
        jc.insert(i, b)
        tc.insert(i, b)
    ids = list(range(len(blocks)))
    assert len({tc._entries[i].payload.planes_np.shape for i in ids}) == 1
    calls = []
    real = bitpack_cuda.cmp_const_many

    def counted(planes, cs):
        calls.append(planes.shape[0])
        return real(planes, cs)

    monkeypatch.setattr(bitpack_cuda, "cmp_const_many", counted)
    for op in OPS:
        for lit in (24, 23.5, 0.5, 51, D("24.00"), 10 ** 20, float("nan")):
            calls.clear()
            masks = tc.eval_predicate_many(ids, TPred(op, lit))
            for b, m in zip(blocks, masks):
                np.testing.assert_array_equal(_selection(m, len(b)),
                                              _oracle_mask(b, op, lit),
                                              err_msg=f"{op} {lit!r}")
            assert calls in ([], [len(blocks)])
    got = tc.eval_predicate_many(ids, TPred("lt", 24))
    assert sum(int(_selection(m, 8192).sum()) for m in got) == sum(
        int(pc.sum(pc.less(b, pa.scalar(D(24)))).as_py()) for b in blocks)
    # the reference's batched compare takes the literal as unscaled: 0
    jm = jc.eval_predicate_many(ids, JPred("lt", 24))
    assert sum(int(np.asarray(jmops.unpack_bits(m.to_selection())).sum())
               for m in jm) == 0
    for b, arr in zip(blocks, tc.get_arrow_many(ids)):
        assert arr.equals(b)
    jarrs = jc.get_arrow_many(ids)
    assert not jarrs[0].equals(blocks[0])  # the reference: unscaled values


@pytest.mark.parametrize("mode", ["clamp", "quantize"])
def test_decimal_blocks_take_no_integer_squeeze(tmp_path, mode):
    """The squeezed integer forms compare raw literals; a decimal block
    skips them (to disk in liquid form) and still answers like pyarrow.
    The reference quantizes decimals and answers in-range literals wrong."""
    rng = np.random.default_rng(3)
    price = _dec_array(rng.integers(90_000, 10_000_000, 8192),
                       pa.decimal128(15, 2), 9)
    jc, tc = _caches(tmp_path, mode)
    jc.insert(0, price)
    tc.insert(0, price)
    jc._squeeze_victim(0)
    tc._squeeze_victim(0)
    assert tc.entry_state(0) == "disk_liquid"
    lit = 300_000  # inside the unscaled range, above the decimals
    for op in OPS:
        m = tc.eval_predicate(0, TPred(op, lit))
        np.testing.assert_array_equal(_selection(m, 8192),
                                      _oracle_mask(price, op, lit))
    assert tc.get(0).equals(price)
    if mode == "quantize":
        assert jc.entry_state(0) == "memory_squeezed"
        jm = jc.eval_predicate(0, JPred("lt", lit))
        got = np.asarray(jmops.unpack_bits(jm.to_selection()))[:8192]
        assert (got != _oracle_mask(price, "lt", lit)).any()


def _delta_arrays():
    rng = np.random.default_rng(11)
    v = np.cumsum(rng.integers(-3, 50, 8192)).astype(np.int64) - 1000
    ts = pa.array((v * 1000).astype("datetime64[ms]"))
    return [pa.array(v, mask=rng.random(8192) < 0.03), pa.array(v[:777]),
            ts, pa.array(v.astype(np.int32))]


def _ipc_blocks():
    out = []
    for name, arr in CASES:
        out.append((name, jtc.transcode(arr), ttc.transcode(arr)))
    for i, arr in enumerate(_delta_arrays()):
        out.append((f"delta{i}", jlin.LiquidPrimitiveDeltaArray.from_arrow(arr),
                    tlin.LiquidPrimitiveDeltaArray.from_arrow(arr)))
    return out


IPC = _ipc_blocks()


@pytest.mark.parametrize("case", IPC, ids=[c[0] for c in IPC])
def test_ipc_bytes_equal_and_read_across(case):
    _name, j, t = case
    assert t.to_bytes() == j.to_bytes()
    from_ref = tipc.deserialize(j.to_bytes())
    assert type(from_ref) is type(t)
    assert from_ref.to_arrow().equals(j.to_arrow())
    from_port = jipc.deserialize(t.to_bytes())
    assert type(from_port) is type(j)
    assert from_port.to_arrow().equals(t.to_arrow())


@pytest.mark.parametrize("i", range(4))
def test_delta_decode_and_masks(i):
    arr = _delta_arrays()[i]
    t = tlin.LiquidPrimitiveDeltaArray.from_arrow(arr)
    j = jlin.LiquidPrimitiveDeltaArray.from_arrow(arr)
    np.testing.assert_array_equal(t.deltas.planes_np,
                                  np.asarray(j.deltas._planes))
    assert t.to_arrow().equals(arr)
    vals, _ = t.to_device("cpu")
    jvals, _ = j.to_device()
    n = len(arr)
    np.testing.assert_array_equal(vals.numpy()[:n], np.asarray(jvals)[:n])
    assert t.memory_bytes() == j.memory_bytes()
    ints = arr.cast(pa.int64()) if not pa.types.is_timestamp(arr.type) \
        else pc.cast(arr, pa.int64())
    mid = ints.to_pylist()[n // 2] or 0
    for op in OPS:
        for lit in (mid, mid + 0.5, float("nan"), 10 ** 12):
            m = t.try_eval_predicate(TPred(op, lit), "cpu")
            fn = {"eq": pc.equal, "ne": pc.not_equal, "lt": pc.less,
                  "lt_eq": pc.less_equal, "gt": pc.greater,
                  "gt_eq": pc.greater_equal}[op]
            want = np.asarray(fn(ints.cast(pa.float64()), pa.scalar(
                float(lit))).fill_null(False))
            np.testing.assert_array_equal(_selection(m, n), want)


# -- SQL on decimal TPC-H ------------------------------------------------------

@pytest.fixture(scope="module")
def tpch_decimal(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_decimal")
    paths, fpaths = {}, {}
    for name, t in tpch_data.generate(0.01).items():
        fpaths[name] = str(d / f"f_{name}.parquet")
        pq.write_table(t, fpaths[name], row_group_size=1 << 14)
        paths[name] = str(d / f"d_{name}.parquet")
        pq.write_table(tpch_data.with_spec_decimals(t), paths[name],
                       row_group_size=1 << 14, write_page_index=True)
    sessions = {}
    for side, build in (("t", lambda: LiquidCacheLocalBuilder(
            device="cpu").build()[0]), ("j", lambda: JBuilder().build()[0])):
        for kind, ps in (("dec", paths), ("float", fpaths)):
            ctx = build()
            for name, p in ps.items():
                ctx.register_parquet(name, p)
            sessions[side, kind] = ctx
    return paths, sessions


@pytest.mark.parametrize("name", list(oracle.DECIMAL_QUERIES))
def test_decimal_sql_equals_pyarrow_and_the_float_run(tpch_decimal, name):
    paths, sessions = tpch_decimal
    sql = oracle.decimal_sql(name)
    fused_agg.STATS["last_bail"] = fused_agg.STATS["star_last_bail"] = None
    got = sessions["t", "dec"].sql(sql).to_arrow()
    assert "decimal column" in (fused_agg.STATS["last_bail"],
                                fused_agg.STATS["star_last_bail"])
    assert oracle.same_table(got, oracle.DECIMAL_ORACLES[name](paths))
    assert any(pa.types.is_decimal(c.type) for c in got.columns) == (
        name != "dec_q14" and name != "dec_qty_lt_24")
    flt = sessions["t", "float"].sql(sql).to_arrow()
    as_float = [c.cast(pa.float64()) if pa.types.is_decimal(c.type) else c
                for c in got.columns]
    assert oracle.same_table(flt, as_float)


@pytest.mark.parametrize("q", [1, 8, 9])
def test_q1_q8_q9_raise_the_precision_error(tpch_decimal, q):
    """Their products outgrow DECIMAL(38): pyarrow raises, in the
    reference as in the port (a wider product is not a feature of the
    reference)."""
    _paths, sessions = tpch_decimal
    for side in ("j", "t"):
        with pytest.raises(pa.ArrowInvalid, match="precision out of range"):
            sessions[side, "dec"].sql(QUERIES[q]).to_arrow()
