"""The grouped reductions on the CPU: the port's `ops/hashagg.py` and
`ops/packfetch.py` against the JAX package's, fed identical numpy inputs
(key codes, null flags, row validity, payloads).

Integer outputs, counts, key images and flags are compared exactly; f64
sums with rtol 1e-12 (the two packages add in different orders).  The
hash ladder's slots are bit-identical because `_mix` is, so its packed
groups are compared row for row as well as as a multiset."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from liquid_tpu.ops import hashagg as jha  # noqa: E402
from liquid_tpu.ops import packfetch as jpf  # noqa: E402
from liquid_tpu_torch.ops import grouphist as tgh  # noqa: E402
from liquid_tpu_torch.ops import grouphist_cuda as k2  # noqa: E402
from liquid_tpu_torch.ops import hashagg as tha  # noqa: E402
from liquid_tpu_torch.ops import packfetch as tpf  # noqa: E402

N = 6000


def test_mix_is_bit_exact():
    rng = np.random.default_rng(1)
    h = rng.integers(0, 2 ** 64, 20000, dtype=np.uint64)
    v = rng.integers(0, 2 ** 64, 20000, dtype=np.uint64)
    h[:4] = [0, 2 ** 64 - 1, 2 ** 63, 1]
    ref = np.asarray(jha._mix(jnp.asarray(h), jnp.asarray(v)))
    got = tha._mix(torch.from_numpy(h.view(np.int64)),
                   torch.from_numpy(v.view(np.int64)))
    np.testing.assert_array_equal(got.numpy().view(np.uint64), ref)


def _inputs(seed, spans, payloads):
    """Key codes inside [lo, lo + span], 5 % NULL keys, 80 % valid rows,
    and per payload (kind, dtype, magnitude) values with 10 % NULLs."""
    rng = np.random.default_rng(seed)
    los = rng.integers(-50, 50, len(spans)).astype(np.int64)
    codes = [lo + rng.integers(0, s + 1, N).astype(np.int64)
             for lo, s in zip(los, spans)]
    knulls = [rng.random(N) < 0.05 for _ in spans]
    codes = [np.where(nl, 0, c) for c, nl in zip(codes, knulls)]
    valid = rng.random(N) < 0.8
    vals, vnulls, kinds = [], [], []
    for kind, dt, mag in payloads:
        if dt == "f64":
            vals.append(rng.normal(0.0, mag, N))
        else:
            vals.append(rng.integers(-mag, mag, N).astype(np.int64))
        vnulls.append(rng.random(N) < 0.1)
        kinds.append(kind)
    return codes, knulls, valid, vals, vnulls, tuple(kinds), los


def _jax(fn, codes, knulls, valid, vals, vnulls, *rest, **kw):
    return fn(tuple(jnp.asarray(c) for c in codes),
              tuple(jnp.asarray(n) for n in knulls), jnp.asarray(valid),
              tuple(jnp.asarray(v) for v in vals),
              tuple(jnp.asarray(n) for n in vnulls), *rest, **kw)


def _torch(fn, codes, knulls, valid, vals, vnulls, *rest, **kw):
    return fn([torch.from_numpy(c) for c in codes],
              [torch.from_numpy(n) for n in knulls], torch.from_numpy(valid),
              [torch.from_numpy(v) for v in vals],
              [torch.from_numpy(n) for n in vnulls], *rest, **kw)


def _assert_rows(got, ref, f64_rows):
    """Row-wise compare of two int64 images: rows in f64_rows hold f64
    sums (rtol 1e-12), the rest compare exactly."""
    assert got.shape == ref.shape
    for r in range(ref.shape[0]):
        if r in f64_rows:
            np.testing.assert_allclose(got[r].view(np.float64),
                                       ref[r].view(np.float64), rtol=1e-12)
        else:
            np.testing.assert_array_equal(got[r], ref[r], err_msg=f"row {r}")


def _assert_same_reduction(got, ref, nk, kinds, f64_sum):
    """(mat, clean, n_groups, cols) of both packages."""
    nv = len(kinds)
    f64_rows = {1 + 2 * nk + j for j in f64_sum}
    _assert_rows(got[0].numpy(), np.asarray(ref[0]), f64_rows)
    assert bool(got[1]) == bool(ref[1])
    assert int(got[2]) == int(ref[2])
    for i, (g, r) in enumerate(zip(got[3], ref[3])):
        r = np.asarray(r)
        g = g.numpy()
        if i - 1 - 2 * nk in f64_sum and i - 1 - 2 * nk < nv:
            np.testing.assert_allclose(g, r, rtol=1e-12)
        else:
            np.testing.assert_array_equal(g, r, err_msg=f"col {i}")


#: (name, spans, payloads (kind, dtype, magnitude), having)
DIRECT = [
    ("unrolled", (5,), [("sum", "i64", 1000), ("min", "f64", 1e3),
                        ("max", "i64", 1 << 40), ("sum", "f64", 10.0)], ()),
    ("streaming", (9, 12), [("sum", "i64", 100), ("max", "f64", 1.0)], ()),
    ("scatter", (3000,), [("sum", "i64", 1 << 50), ("sum", "f64", 1e6),
                          ("min", "i64", 1 << 20)], ()),
    ("having", (3000,), [("sum", "i64", 100), ("sum", "i64", 5)],
     (0, "gt", 20.0)),
]


@pytest.mark.parametrize("name,spans,payloads,having", DIRECT,
                         ids=[d[0] for d in DIRECT])
def test_direct_reduce_matches_reference(name, spans, payloads, having):
    codes, knulls, valid, vals, vnulls, kinds, los = _inputs(
        len(name), spans, payloads)
    ref = _jax(jha.direct_reduce_packed, codes, knulls, valid, vals, vnulls,
               kinds, jnp.asarray(los), spans=spans, having=having)
    got = _torch(tha.direct_reduce_packed, codes, knulls, valid, vals,
                 vnulls, kinds, torch.from_numpy(los), spans, (), having)
    f64_sum = [j for j, (k, dt, _) in enumerate(payloads)
               if k == "sum" and dt == "f64"]
    _assert_same_reduction(got, ref, len(spans), kinds, f64_sum)


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_direct_reduce_k2_branch_matches_reference(wide):
    """The K2 branch (plain version on the CPU) against the reference's
    scatter path on the same inputs: exact integer sums.  Wide values
    ride as hi/lo i32 halves."""
    mag = (1 << 30) if wide else (1 << 14)
    spans = (4095,)
    codes, knulls, valid, vals, vnulls, kinds, los = _inputs(
        7, spans, [("sum", "i64", mag), ("sum", "i64", 3)])
    plan = tgh.plan_hilo(8192, mag)
    assert (plan[1] > 0) == wide
    pseg = (plan[0], tgh.plan_tables(4097), (wide, False))
    ref = _jax(jha.direct_reduce_packed, codes, knulls, valid, vals, vnulls,
               kinds, jnp.asarray(los), spans=spans)
    before = k2.LAUNCHES["group_accumulate"]
    got = _torch(tha.direct_reduce_packed, codes, knulls, valid, vals,
                 vnulls, kinds, torch.from_numpy(los), spans, pseg)
    assert k2.LAUNCHES["group_accumulate"] == before  # CPU: plain version
    _assert_same_reduction(got, ref, 1, kinds, [])


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_direct_reduce_k2_branch_hands_k2_columns_in_place(wide,
                                                            monkeypatch):
    """The K2 branch passes its payload as a list of contiguous int32[n]
    columns (hi/lo halves for a wide sum), with no [n, C] stack."""
    mag = (1 << 30) if wide else (1 << 14)
    spans = (4095,)
    codes, knulls, valid, vals, vnulls, kinds, los = _inputs(
        7, spans, [("sum", "i64", mag), ("sum", "i64", 3)])
    plan = tgh.plan_hilo(8192, mag)
    pseg = (plan[0], tgh.plan_tables(4097), (wide, False))
    seen = []
    real = k2.group_accumulate

    def spy(slot, cols, m, **kw):
        seen.append((slot, cols, m))
        return real(slot, cols, m, **kw)

    monkeypatch.setattr(k2, "group_accumulate", spy)
    _torch(tha.direct_reduce_packed, codes, knulls, valid, vals, vnulls,
           kinds, torch.from_numpy(los), spans, pseg)
    (slot, cols, m), = seen
    assert isinstance(cols, list) and m == 4097
    # occupancy, two (acc, cnt) pairs; the wide sum rides as hi and lo
    assert len(cols) == 5 + int(wide)
    for c in cols:
        assert c.dtype == torch.int32 and c.dim() == 1
        assert c.is_contiguous() and c.shape == slot.shape


@pytest.mark.parametrize("spans,k2_route,tier",
                         [((9, 12), False, "stream"),
                          ((3000,), False, "scatter"),
                          ((4095,), True, "k2"), (None, False, "hash")],
                         ids=["stream", "scatter", "k2", "hash"])
def test_reduction_counts_the_tier_it_takes(spans, k2_route, tier):
    """`TIERS` counts the tier a reduction takes where it is chosen: one
    integer sum batch streams at 154 slots, scatters at 3,002, runs K2
    when the planner passes `pallas_seg`; the hash ladder counts once."""
    before = dict(tha.TIERS)
    if spans is None:
        _torch(tha.hash_rounds_reduce_packed, *_hash_inputs(5, 300), 8192,
               0xC2B2AE3D27D4EB4F, 2)
    else:
        codes, knulls, valid, vals, vnulls, kinds, los = _inputs(
            11, spans, [("sum", "i64", 100)])
        pseg = ((tgh.plan_hilo(8192, 100)[0], tgh.plan_tables(4097),
                 (False,)) if k2_route else ())
        _torch(tha.direct_reduce_packed, codes, knulls, valid, vals, vnulls,
               kinds, torch.from_numpy(los), spans, pseg)
    moved = {k: v - before[k] for k, v in tha.TIERS.items() if v != before[k]}
    assert moved == {tier: 1}


def _hash_inputs(seed, n_keys_distinct):
    rng = np.random.default_rng(seed)
    pool = rng.integers(-(1 << 62), 1 << 62, n_keys_distinct)
    k0 = pool[rng.integers(0, n_keys_distinct, N)].astype(np.int64)
    k1 = np.float64(rng.integers(0, 7, N) * 0.5).view(np.int64)
    knulls = [rng.random(N) < 0.03, rng.random(N) < 0.03]
    codes = [np.where(nl, 0, c) for c, nl in zip((k0, k1), knulls)]
    valid = rng.random(N) < 0.9
    vals = [rng.integers(-1000, 1000, N).astype(np.int64),
            rng.normal(0.0, 1e3, N), rng.integers(0, 1 << 30, N)]
    vnulls = [rng.random(N) < 0.1 for _ in vals]
    return codes, knulls, valid, vals, vnulls, ("sum", "sum", "max")


def _groups(mat, nk, nv):
    """The packed groups as a sorted list of row tuples."""
    g = int(mat[0, 1])
    rows = mat[1:1 + 2 * nk + 2 * nv, :g].T
    return sorted(map(tuple, rows.tolist()))


@pytest.mark.parametrize("n_slots,rounds,distinct",
                         [(8192, 3, 900), (1 << 17, 1, 300),
                          (8192, 1, 5000)],
                         ids=["three_rounds", "one_round", "dirty"])
def test_hash_rounds_matches_reference(n_slots, rounds, distinct):
    inputs = _hash_inputs(n_slots + rounds, distinct)
    salt = 0xC2B2AE3D27D4EB4F
    ref = _jax(jha.hash_rounds_reduce_packed, *inputs, n_slots=n_slots,
               salt=salt, rounds=rounds)
    got = _torch(tha.hash_rounds_reduce_packed, *inputs, n_slots, salt,
                 rounds)
    assert bool(got[1]) == bool(ref[1])
    assert int(got[2]) == int(ref[2])
    if distinct == 5000:
        assert not bool(got[1])  # one round cannot resolve this table
        return
    gm, rm = got[0].numpy().copy(), np.array(ref[0])
    nk, nv = 2, 3
    f64 = 1 + 2 * nk + 1
    for m in (gm, rm):
        m[f64] = 0  # f64 sums compared below with a tolerance
    assert _groups(gm, nk, nv) == _groups(rm, nk, nv)
    _assert_same_reduction(got, ref, nk, inputs[-1], [1])


def test_repack_and_packed_fetch_match_reference():
    inputs = _hash_inputs(3, 900)
    ref = _jax(jha.hash_rounds_reduce_packed, *inputs, n_slots=8192,
               salt=0x9E3779B97F4A7C15, rounds=3)
    got = _torch(tha.hash_rounds_reduce_packed, *inputs, 8192,
                 0x9E3779B97F4A7C15, 3)
    nk, nv = 2, 3
    jcols = jha.repack_groups(tuple(ref[3]), nk, nv, 1024)
    tcols = tha.repack_groups(got[3], nk, nv, 1024)
    for jpart, tpart in zip(jcols, tcols):
        for j, t in zip(jpart, tpart):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-12)
    # the bit-packed fetch: narrow, bool, f64, full-width and constant
    rng = np.random.default_rng(4)
    w2, g = 1 << 16, 50_000
    cols = [rng.integers(-500, 500, w2).astype(np.int64),
            rng.random(w2) < 0.5, rng.normal(size=w2),
            rng.integers(-(1 << 62), 1 << 62, w2).astype(np.int64),
            np.full(w2, 7, np.int64)]
    ref = jpf.fetch_columns([jnp.asarray(c) for c in cols], g)
    out = tpf.fetch_columns([torch.from_numpy(c) for c in cols], g)
    assert tpf.STATS["packed_fetches"] >= 1
    for o, r, c in zip(out, ref, cols):
        assert o.dtype == np.asarray(r).dtype
        np.testing.assert_array_equal(o[:g], np.asarray(r)[:g])
        np.testing.assert_array_equal(o[:g], c[:g])


def _mostly_dead(seed, spans):
    """Inputs with about 0.5 % live rows (a selective filter or join)."""
    codes, knulls, _valid, vals, vnulls, kinds, los = _inputs(
        seed, spans, [("sum", "i64", 1 << 40), ("min", "i64", 1000),
                      ("max", "f64", 1e3), ("sum", "f64", 1.0)])
    valid = np.random.default_rng(seed + 100).random(N) < 0.005
    assert 0 < valid.sum() < N // 100
    return codes, knulls, valid, vals, vnulls, kinds, los


@pytest.mark.parametrize("tier", ["scatter", "hash"])
def test_dropping_scatter_with_almost_every_row_dead(tier, monkeypatch):
    """The trash band (`_dropped`): with more than 99 % of the rows dead,
    every output is bit for bit the one the single trash row gave, and
    matches the reference's `mode="drop"` scatter; no dead row lands in a
    kept slot, and the dead rows spread over the whole band."""
    codes, knulls, valid, vals, vnulls, kinds, los = _mostly_dead(
        17, (3000,) if tier == "scatter" else (40, 70))

    def run():
        before = dict(tha.TIERS)
        if tier == "scatter":
            out = _torch(tha.direct_reduce_packed, codes, knulls, valid, vals,
                         vnulls, kinds, torch.from_numpy(los), (3000,))
        else:
            out = _torch(tha.hash_rounds_reduce_packed, codes, knulls, valid,
                         vals, vnulls, kinds, 8192, 0xC2B2AE3D27D4EB4F, 3)
        assert tha.TIERS[tier] > before[tier]
        return out

    real = tha._dropped
    seen = []

    def checked(slot, live, m):
        out = real(slot, live, m)
        dead = ~live
        assert (out[live] == slot[live].to(torch.int64)).all()
        assert bool((out[live] < m).all())
        assert bool((out[dead] >= m).all()) and bool(
            (out[dead] < m + tha.TRASH).all())
        seen.append(int(out[dead].unique().numel()))
        return out

    monkeypatch.setattr(tha, "_dropped", checked)
    got = run()
    # the dead rows use nearly every row of the band, not one address
    assert seen and min(seen) > 0.99 * tha.TRASH
    # before: every dead row in the one trash row m
    monkeypatch.setattr(tha, "_dropped", lambda slot, live, m: torch.where(
        live, slot.to(torch.int64), torch.full_like(slot, m, dtype=torch.int64)))
    old = run()
    np.testing.assert_array_equal(got[0].numpy(), old[0].numpy())
    assert int(got[2]) == int(old[2]) and bool(got[1]) == bool(old[1])
    for g, o in zip(got[3], old[3]):
        np.testing.assert_array_equal(g.numpy(), o.numpy())
    if tier == "scatter":
        ref = _jax(jha.direct_reduce_packed, codes, knulls, valid, vals,
                   vnulls, kinds, jnp.asarray(los), spans=(3000,))
    else:
        ref = _jax(jha.hash_rounds_reduce_packed, codes, knulls, valid, vals,
                   vnulls, kinds, n_slots=8192, salt=0xC2B2AE3D27D4EB4F,
                   rounds=3)
    _assert_same_reduction(got, ref, len(codes), kinds, [3])
