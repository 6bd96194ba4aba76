"""The port's sort-merge join (`liquid_tpu_torch/ops/join.py`,
`sql/device_join.py`) against the JAX package's, both on the CPU.

The ops compare bit for bit (sorted keys, permutation, bounds, expanded
pairs, matched flags).  `try_device_join` compares row for row, order
included, over the cases of `tests/test_device_join.py`: the four join
kinds, NULL and duplicate keys, string and two-column keys, date and
float keys, empty sides, a coalesced same-name key and a column
collision that returns None, on both sides of `HOST_JOIN_MAX` (numpy
below it, the device's sort and probe at or above it).  Further cases
hold the key packing (`_pack_keys`): offsets from the least code where
the spans fit 62 bits (negative, uint64 above 2^63, an all-NULL side, an
empty side, a pair far from 0), dense ranks where they do not (int64
and uint64 extremes, two 40-bit spans, float bits), each counted in
`STATS`, and None exactly where the reference's ranks return it."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pyarrow as pa  # noqa: E402

from liquid_tpu.ops import join as jjoin  # noqa: E402
from liquid_tpu.sql import device_join as jdj  # noqa: E402
from liquid_tpu_torch.ops import join as tjoin  # noqa: E402
from liquid_tpu_torch.sql import device_join as tdj  # noqa: E402

KINDS = ["inner", "left", "right", "full"]


@pytest.mark.parametrize("seed,n_b,n_p,card", [(0, 5000, 7000, 120),
                                                (1, 1, 300, 3),
                                                (2, 4000, 1, 1)])
def test_ops_bit_for_bit(seed, n_b, n_p, card):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, card, n_b)
    probe = rng.integers(-5, card + 20, n_p)
    js, jp = jjoin.sort_build(jnp.asarray(keys))
    ts, tp = tjoin.sort_build(torch.tensor(keys))
    assert (np.asarray(js) == ts.numpy()).all()
    assert (np.asarray(jp) == tp.numpy()).all()
    jlo, jhi = jjoin.probe_bounds(js, jnp.asarray(probe))
    tlo, thi = tjoin.probe_bounds(ts, torch.tensor(probe))
    assert (np.asarray(jlo) == tlo.numpy()).all()
    assert (np.asarray(jhi) == thi.numpy()).all()
    total = int((thi - tlo).sum())
    cap = 1 << max(0, int(np.ceil(np.log2(max(total, 1)))))
    for a, b in zip(jjoin.expand_matches(jlo, jhi - jlo, cap),
                    tjoin.expand_matches(tlo, thi - tlo, cap)):
        assert (np.asarray(a) == b.numpy()).all()
    assert (np.asarray(jjoin.matched_flags(js, jlo, jhi))
            == tjoin.matched_flags(ts, tlo, thi).numpy()).all()


def test_expand_and_flags_by_hand():
    """`tests/test_device_join.py`'s kernel cases, on the port."""
    p, b, valid = tjoin.expand_matches(torch.tensor([0, 2, 5], dtype=torch.int32),
                                       torch.tensor([2, 0, 3], dtype=torch.int32), 8)
    assert int(valid.sum()) == 5
    assert p[valid].tolist() == [0, 0, 2, 2, 2]
    assert b[valid].tolist() == [0, 1, 5, 6, 7]
    flags = tjoin.matched_flags(torch.tensor([1, 1, 2, 3, 5]),
                                torch.tensor([0, 3], dtype=torch.int32),
                                torch.tensor([2, 4], dtype=torch.int32))
    assert flags.tolist() == [True, True, False, True, False]


def _rand_tables(seed, n_l=200, n_r=150, card=20):
    rng = np.random.default_rng(seed)
    left = pa.table({
        "lkey": pa.array(rng.integers(0, card, n_l), pa.int64(),
                         mask=rng.random(n_l) < 0.1),
        "lval": pa.array(rng.normal(size=n_l))})
    right = pa.table({
        "rkey": pa.array(rng.integers(0, card, n_r), pa.int64(),
                         mask=rng.random(n_r) < 0.1),
        "rval": pa.array(rng.integers(0, 1000, n_r), pa.int64())})
    return left, right


def _words():
    rng = np.random.default_rng(3)
    words = np.array(["ab", "cd", "ef", "gh", "ijk"])
    left = pa.table({"s": pa.array(words[rng.integers(0, 5, 120)]),
                     "k": pa.array(rng.integers(0, 4, 120), pa.int32()),
                     "lv": pa.array(np.arange(120, dtype=np.int64))})
    right = pa.table({"rs": pa.array(words[rng.integers(0, 5, 90)]),
                      "rk": pa.array(rng.integers(0, 4, 90), pa.int32()),
                      "rv": pa.array(np.arange(90, dtype=np.int64))})
    return left, right, ["s", "k"], ["rs", "rk"]


def _dates():
    left = pa.table({"d": pa.array([0, 1, 2, 1, None], pa.date32()),
                     "f": pa.array([1.5, 2.5, 1.5, 2.5, 0.0]),
                     "lv": pa.array([1, 2, 3, 4, 5], pa.int64())})
    right = pa.table({"rd": pa.array([1, 2, 3, None], pa.date32()),
                      "rf": pa.array([2.5, 1.5, 9.0, -0.0]),
                      "rv": pa.array([10, 20, 30, 40], pa.int64())})
    return left, right, ["d", "f"], ["rd", "rf"]


def _empty():
    left = pa.table({"k": pa.array([], pa.int64()),
                     "lv": pa.array([], pa.float64())})
    right = pa.table({"rk": pa.array([1, 2], pa.int64()),
                      "rv": pa.array([7, 8], pa.int64())})
    return left, right, ["k"], ["rk"]


def _coalesced():
    left = pa.table({"k": pa.array([1, 2, None], pa.int64()),
                     "lv": pa.array([1, 2, 3], pa.int64())})
    right = pa.table({"k": pa.array([2, 3], pa.int64()),
                      "rv": pa.array([20, 30], pa.int64())})
    return left, right, ["k"], ["k"]


I64_MIN, I64_MAX = -(1 << 63), (1 << 63) - 1


def _ints(lvals, rvals, typ=pa.int64()):
    """One key pair of the given values (None a NULL) and a payload."""
    left = pa.table({"k": pa.array(lvals, typ),
                     "lv": pa.array(np.arange(len(lvals), dtype=np.int64))})
    right = pa.table({"rk": pa.array(rvals, typ),
                      "rv": pa.array(np.arange(len(rvals), dtype=np.int64))})
    return left, right, ["k"], ["rk"]


def _int64_extremes():
    """Keys at both ends of int64: a span over 62 bits."""
    vals = [I64_MIN, I64_MAX, -1, 0, 5, I64_MIN + 1, I64_MAX - 3]
    rng = np.random.default_rng(13)
    lv = [vals[i] for i in rng.integers(0, len(vals), 60)] + [None]
    rv = [vals[i] for i in rng.integers(0, len(vals), 40)] + [None, 17]
    return _ints(lv, rv)


def _uint64_high():
    """uint64 keys above 2^63 (negative int64 codes, a narrow span)."""
    rng = np.random.default_rng(17)
    base = (1 << 63) + 1000
    lv = [base + int(v) for v in rng.integers(0, 30, 80)] + [None]
    rv = [base + int(v) for v in rng.integers(0, 40, 50)]
    rv += [None, base + 99]
    return _ints(lv, rv, pa.uint64())


def _uint64_both_halves():
    """uint64 keys on both sides of 2^63: their codes span over 62 bits."""
    vals = [0, 1, 7, (1 << 63) - 1, 1 << 63, (1 << 64) - 1]
    rng = np.random.default_rng(19)
    return _ints([vals[i] for i in rng.integers(0, 6, 50)],
                 [vals[i] for i in rng.integers(0, 6, 30)], pa.uint64())


def _negative():
    rng = np.random.default_rng(23)
    lv = [int(v) for v in rng.integers(-500, -400, 150)] + [None, None]
    rv = [int(v) for v in rng.integers(-520, -380, 90)] + [None]
    return _ints(lv, rv)


def _two_40_bit_spans():
    """Two int64 keys spanning 2^40 each: 82 bits of span, a few ranks."""
    rng = np.random.default_rng(29)
    a = rng.integers(0, 1 << 40, 12)
    b = rng.integers(-(1 << 40), 0, 9)
    left = pa.table({"a": pa.array(a[rng.integers(0, 12, 140)]),
                     "b": pa.array(b[rng.integers(0, 9, 140)]),
                     "lv": pa.array(np.arange(140, dtype=np.int64))})
    right = pa.table({"ra": pa.array(a[rng.integers(0, 12, 70)]),
                      "rb": pa.array(b[rng.integers(0, 9, 70)]),
                      "rv": pa.array(np.arange(70, dtype=np.int64))})
    return left, right, ["a", "b"], ["ra", "rb"]


def _offset_pair():
    """An int64 and a date32 key far from 0, as a sales row's (item,
    date): each pair's offsets, not its codes, fit the widths."""
    rng = np.random.default_rng(37)

    def side(n, key, day, val):
        return pa.table({
            key: pa.array(rng.integers(-1040, -1000, n),
                          mask=rng.random(n) < 0.05),
            day: pa.array(rng.integers(10950, 10990, n).astype(np.int32),
                          pa.int32()).cast(pa.date32()),
            val: pa.array(np.arange(n, dtype=np.int64))})
    return (side(300, "i", "d", "lv"), side(200, "ri", "rd", "rv"),
            ["i", "d"], ["ri", "rd"])


def _all_null_side():
    """The right side's key is NULL on every row."""
    return _ints([3, 1, None, 3, 2], [None] * 4)


def _empty_right():
    return _ints([5, None, 5, 9], [])


CASES = {
    "int_nulls_dupes": lambda: (*_rand_tables(7), ["lkey"], ["rkey"]),
    "int_wide": lambda: (*_rand_tables(11, 300, 100, 200), ["lkey"],
                         ["rkey"]),
    "string_and_multi": _words,
    "date_and_float": _dates,
    "empty_side": _empty,
    "coalesced_key": _coalesced,
    "int64_extremes": _int64_extremes,
    "uint64_high": _uint64_high,
    "uint64_both_halves": _uint64_both_halves,
    "negative_ints": _negative,
    "two_40_bit_spans": _two_40_bit_spans,
    "all_null_side": _all_null_side,
    "empty_right": _empty_right,
    "offset_pair": _offset_pair,
}

#: how each case packs its keys: by offset from the least code where the
#: spans fit 62 bits, else by dense rank (float keys as IEEE bits, ints
#: spanning more)
PACKS = {"int_nulls_dupes": "range", "int_wide": "range",
         "string_and_multi": "range", "date_and_float": "rank",
         "empty_side": "range", "coalesced_key": "range",
         "int64_extremes": "rank", "uint64_high": "range",
         "uint64_both_halves": "rank", "negative_ints": "range",
         "two_40_bit_spans": "rank", "all_null_side": "range",
         "empty_right": "range", "offset_pair": "range"}


@pytest.mark.parametrize("on_device", [False, True],
                         ids=["host", "device"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_device_join_row_for_row(case, kind, on_device, monkeypatch):
    """The same rows in the same order as the reference's join (which
    runs its XLA sort-merge on the CPU backend)."""
    left, right, lk, rk = CASES[case]()
    if on_device:  # every size at or above HOST_JOIN_MAX
        monkeypatch.setattr(tdj, "HOST_JOIN_MAX", 0)
    before = dict(tdj.STATS)
    got = tdj.try_device_join(left, right, lk, rk, kind, "cpu")
    want = jdj.try_device_join(left, right, lk, rk, kind)
    assert got is not None and want is not None
    route = "device_joins" if on_device else "host_joins"
    assert tdj.STATS[route] == before[route] + 1
    assert got.column_names == want.column_names
    assert got.schema == want.schema
    assert got.to_pylist() == want.to_pylist()


def test_collision_returns_none():
    left = pa.table({"k": pa.array([1], pa.int64()),
                     "shared": pa.array([1], pa.int64())})
    right = pa.table({"rk": pa.array([1], pa.int64()),
                      "shared": pa.array([2], pa.int64())})
    before = tdj.STATS["fallback_joins"]
    assert tdj.try_device_join(left, right, ["k"], ["rk"], "inner") is None
    assert tdj.STATS["fallback_joins"] == before + 1
    assert jdj.try_device_join(left, right, ["k"], ["rk"], "inner") is None


def test_host_join_max_matches_the_reference():
    assert tdj.HOST_JOIN_MAX == jdj.HOST_JOIN_MAX == 1 << 16


def test_large_join_takes_the_device_route():
    """Above HOST_JOIN_MAX rows the default route is the device's."""
    rng = np.random.default_rng(9)
    n = tdj.HOST_JOIN_MAX
    left = pa.table({"a": pa.array(rng.integers(0, 5000, n)),
                     "x": pa.array(np.arange(n))})
    right = pa.table({"b": pa.array(np.arange(5000)),
                      "y": pa.array(rng.normal(size=5000))})
    before = tdj.STATS["device_joins"]
    got = tdj.try_device_join(left, right, ["a"], ["b"], "inner", "cpu")
    assert tdj.STATS["device_joins"] == before + 1
    want = jdj.try_device_join(left, right, ["a"], ["b"], "inner")
    assert got.to_pylist() == want.to_pylist()


@pytest.mark.parametrize("on_device", [False, True],
                         ids=["host", "device"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_pack_path_per_case(case, kind, on_device, monkeypatch):
    """Each case packs its keys one way, counted once per fold, and joins
    row for row as the reference (which always ranks)."""
    assert set(PACKS) == set(CASES)
    left, right, lk, rk = CASES[case]()
    if on_device:
        monkeypatch.setattr(tdj, "HOST_JOIN_MAX", 0)
    before = dict(tdj.STATS)
    got = tdj.try_device_join(left, right, lk, rk, kind, "cpu")
    moved = {k: tdj.STATS[k] - before[k] for k in ("range_packs",
                                                    "rank_packs")}
    want_pack = PACKS[case] + "_packs"
    assert moved == {k: int(k == want_pack) for k in moved}
    want = jdj.try_device_join(left, right, lk, rk, kind)
    assert got is not None and want is not None
    assert got.schema == want.schema
    assert got.to_pylist() == want.to_pylist()


def _dense_keys(n_keys, n_distinct):
    """`n_keys` int64 key columns, each holding 0 .. n_distinct - 1."""
    rng = np.random.default_rng(31)
    left = {f"k{i}": pa.array(rng.permutation(n_distinct))
            for i in range(n_keys)}
    right = {f"r{i}": pa.array(rng.integers(0, n_distinct, 50))
             for i in range(n_keys)}
    return (pa.table(left), pa.table(right), list(left), list(right))


@pytest.mark.parametrize("n_keys,n_distinct,pack,joins", [
    (4, 1 << 15, "rank", False),         # ranks of 16 bits: 64 > 62
    (4, (1 << 15) - 1, "rank", True),    # ranks of 15 bits; spans of 16
    (4, (1 << 15) - 2, "range", True),   # spans of 15 bits: 60
    (8, 300, "rank", False),             # spans and ranks of 9 bits: 72
])
def test_range_pack_returns_none_where_the_ranks_do(n_keys, n_distinct,
                                                    pack, joins):
    """A tuple whose ranks do not fit 62 bits goes to pyarrow, as in the
    reference, even where its offsets alone would fit (4 x 15 bits from
    0 .. 2^15 - 1): the range packing never answers a join that the rank
    packing hands back."""
    left, right, lk, rk = _dense_keys(n_keys, n_distinct)
    before = dict(tdj.STATS)
    got = tdj.try_device_join(left, right, lk, rk, "inner", "cpu")
    want = jdj.try_device_join(left, right, lk, rk, "inner")
    assert (got is not None) == (want is not None) == joins
    assert tdj.STATS[pack + "_packs"] == before[pack + "_packs"] + 1
    assert tdj.STATS["fallback_joins"] == before["fallback_joins"] + (
        not joins)
    if joins:
        assert got.to_pylist() == want.to_pylist()
