"""K2 (`group_accumulate`) on the CPU: the port's plain version and its
wrapper, which take the payload as a list of int32[n] columns, against
the TPU kernel's own Pallas body run in interpret mode and against
`np.add.at`; the wrapper's launch plan (pure Python); the planner's gates
against the reference's.  Integer sums and plans are compared exactly
(tolerance 0).  The CUDA kernel itself is held against the same plain
version on the card by `chip_smoke.py`."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from functools import partial  # noqa: E402

import jax  # noqa: E402
import jax.experimental.pallas as pl  # noqa: E402
import jax.experimental.pallas.tpu as pltpu  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from liquid_tpu.ops import grouphist_pallas as jgh  # noqa: E402
from liquid_tpu_torch.ops import grouphist as tgh  # noqa: E402
from liquid_tpu_torch.ops import grouphist_cuda as k2  # noqa: E402


def _pallas_interpret(slot, vals, m, seg, ntab):
    """`grouphist_pallas.group_accumulate` as the reference builds it, with
    the kernel body run by the Pallas interpreter."""
    n, c = vals.shape
    n_tiles = n // jgh.TILE
    nseg = -(-n_tiles // seg)
    mp = ((m + 1 + 7) // 8) * 8
    slot = jnp.clip(jnp.where(slot < 0, jnp.int32(m), slot), 0,
                    jnp.int32(mp - 1))
    with jax.enable_x64(False):
        segs = pl.pallas_call(
            partial(jgh._kernel, seg, ntab),
            grid=(n_tiles,),
            in_specs=[pl.BlockSpec((jgh.TILE, 1), lambda i: (i, 0)),
                      pl.BlockSpec((jgh.TILE, c), lambda i: (i, 0))],
            out_specs=pl.BlockSpec((1, mp, c), lambda i: (i // seg, 0, 0)),
            out_shape=jax.ShapeDtypeStruct((nseg, mp, c), jnp.int32),
            scratch_shapes=[pltpu.VMEM((mp, c), jnp.int32)
                            for _ in range(ntab - 1)],
            interpret=True,
        )(slot.reshape(-1, 1), vals)
    return np.asarray(segs.astype(jnp.int64).sum(axis=0)[: m + 1])


def _np_ref(slot, vals, m):
    """np.add.at with the reference's clamp: negatives to row m, clip to
    mp - 1, rows beyond m dropped."""
    mp = ((m + 1 + 7) // 8) * 8
    s = np.clip(np.where(slot < 0, m, slot), 0, mp - 1)
    out = np.zeros((mp, vals.shape[1]), np.int64)
    np.add.at(out, s, vals.astype(np.int64))
    return out[: m + 1]


def _case(n, c, m, seed, vmax=2 ** 31):
    rng = np.random.default_rng(seed)
    slot = rng.integers(-3, m + 12, n).astype(np.int32)
    vals = rng.integers(-vmax, vmax, (n, c)).astype(np.int32)
    return slot, vals


def _cols(vals):
    """[n, C] numpy -> C contiguous int32[n] tensors (the kernel's input)."""
    return [torch.from_numpy(np.ascontiguousarray(vals[:, c]))
            for c in range(vals.shape[1])]


def test_plain_version_matches_the_pallas_kernel_body():
    # values small enough that the TPU kernel's i32 segments stay exact
    slot, vals = _case(4096, 3, 37, seed=3, vmax=1000)
    seg = jgh.plan_segments(4096, 1000)[1]
    ref = _pallas_interpret(jnp.asarray(slot), jnp.asarray(vals), 37, seg, 2)
    for fn in (tgh.group_accumulate_ref, k2.group_accumulate):
        got = fn(torch.from_numpy(slot), _cols(vals), 37)
        assert got.dtype == torch.int64 and got.shape == (38, 3)
        np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(ref, _np_ref(slot, vals, 37))


@pytest.mark.parametrize("m", [1, 7, 8, 37, 4095])
@pytest.mark.parametrize("c", [1, 7, 16])
def test_plain_version_and_wrapper_match_add_at(m, c):
    """Full-range i32 values, negative and too-large slots; m = 7 and 8
    pin the mp - 1 clip edge (mp = 8 and 16)."""
    slot, vals = _case(3000, c, m, seed=m * 31 + c)
    want = _np_ref(slot, vals, m)
    ts, tv = torch.from_numpy(slot), _cols(vals)
    np.testing.assert_array_equal(
        tgh.group_accumulate_ref(ts, tv, m).numpy(), want)
    before = k2.LAUNCHES["group_accumulate"]
    np.testing.assert_array_equal(k2.group_accumulate(ts, tv, m).numpy(),
                                  want)
    assert k2.LAUNCHES["group_accumulate"] == before  # CPU: no kernel


@pytest.mark.parametrize("n", [1, 3, 4097])
@pytest.mark.parametrize("m", [63, 65535])
def test_ragged_rows_and_sixteen_columns_match_add_at(n, m):
    """n not a multiple of the kernel's 4-row loads, C = 16, and m =
    65535, whose table the card splits into slot ranges."""
    slot, vals = _case(n, 16, m, seed=n + m)
    want = _np_ref(slot, vals, m)
    got = k2.group_accumulate(torch.from_numpy(slot), _cols(vals), m)
    assert got.shape == (m + 1, 16)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("m", [1, 63, 8889, 16385, 65535])
@pytest.mark.parametrize("c", [1, 7, 16])
def test_launch_plan_fits_shared_memory_and_covers_every_slot(m, c):
    """Every CTA's table fits a Hopper block's 232,448 shared bytes, the
    slot ranges cover [0, mp) exactly once, the grid stays within one
    CTA per SM, and the row chunks cover every 4-row group."""
    mp = tgh.padded_slots(m)
    for n in (0, 3, 2048, 4097, 4_005_888, 6_001_215):
        p = k2.plan(n, c, m, sms=132)
        assert p.smem == p.range_len * 8 <= 232_448
        # range r covers [r * range_len, min((r + 1) * range_len, mp))
        spans = [(r * p.range_len, min((r + 1) * p.range_len, mp))
                 for r in range(p.ranges)]
        assert spans[0][0] == 0 and spans[-1][1] == mp
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
        assert all(lo < hi for lo, hi in spans)
        assert c * p.ranges * p.chunks <= max(132, c * p.ranges)
        assert p.chunks * p.quads_per_chunk >= n // 4
        assert (p.chunks - 1) * p.quads_per_chunk < max(n // 4, 1)
    assert k2.plan(4_005_888, c, m, sms=132).ranges == (3 if m == 65535
                                                        else 1)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    s = torch.zeros(8, dtype=torch.int32)
    v = [torch.zeros(8, dtype=torch.int32), torch.zeros(8, dtype=torch.int32)]
    with pytest.raises(TypeError):
        k2.group_accumulate(s.long(), v, 4)
    with pytest.raises(TypeError):
        k2.group_accumulate(s, [v[0].long(), v[1]], 4)
    with pytest.raises(TypeError):  # one [n, C] tensor, not a list
        k2.group_accumulate(s, torch.zeros((8, 2), dtype=torch.int32), 4)
    with pytest.raises(ValueError):
        k2.group_accumulate(s, v * 9, 4)  # 18 columns
    with pytest.raises(ValueError):
        k2.group_accumulate(s, [], 4)
    with pytest.raises(ValueError):
        k2.group_accumulate(s, v, tgh.MAX_SLOTS)
    with pytest.raises(ValueError):
        k2.group_accumulate(s[:4], v, 4)
    with pytest.raises(ValueError):
        k2.group_accumulate(s, [v[0], torch.zeros((8, 2), dtype=torch.int32
                                                  )[:, 0]], 4)
    with pytest.raises(ValueError):
        k2.group_accumulate(s.to("meta"), [c.to("meta") for c in v], 4)


def test_kernel_source_names_the_tpu_kernel_and_reads_columns():
    with open(k2.SOURCE) as f:
        src = f.read()
    assert "grouphist_pallas.py" in src and "`group_accumulate`" in src
    assert 'extern "C" int group_accumulate_launch' in src
    assert "const int32_t* p[kMaxCols]" in src  # column pointers by value
    assert f"kThreads = {k2.THREADS}" in src
    assert f"kMaxSmem = {k2.MAX_SMEM}" in src


def test_constants_match_reference():
    assert (tgh.TILE, tgh.MAX_SLOTS, tgh.MAX_COLS, tgh.MAX_SEGS,
            tgh.SPLIT) == (jgh.TILE, jgh.MAX_SLOTS, jgh.MAX_COLS,
                           jgh.MAX_SEGS, jgh.SPLIT)


_ROWS = [2048, 65536, 4_005_888, 6_004_736, 2048 * 600_000, 1000]
_BOUNDS = [1, 13, 4095, 32767, 1 << 24, 1_940_000_000, 1 << 40, 1 << 62]


@pytest.mark.parametrize("n_rows", _ROWS)
def test_plans_match_reference(n_rows):
    for b in _BOUNDS:
        assert tgh.plan_segments(n_rows, b) == jgh.plan_segments(n_rows, b)
        assert tgh.plan_hilo(n_rows, b) == jgh.plan_hilo(n_rows, b)
    for m in (1, 64, 8889, 16385, 19000, 36000, 65535, 100_000):
        assert tgh.plan_tables(m) == jgh.plan_tables(m)


def test_single_tile_overflow_case_splits():
    """The round-5 overflow case: one tile of a scaled revenue sum
    overflows the i32 window, so the plan must split hi/lo."""
    assert tgh.plan_segments(1 << 16, 1_940_000_000) is None
    got = tgh.plan_hilo(1 << 16, 1_940_000_000)
    assert got == jgh.plan_hilo(1 << 16, 1_940_000_000)
    assert got is not None and got[1] == tgh.SPLIT
    assert tgh.plan_segments(1 << 16, 4095) is not None


def test_split_hilo_matches_reference():
    rng = np.random.default_rng(9)
    v = np.concatenate([rng.integers(-(1 << 45), 1 << 45, 5000),
                        [0, -1, 1, (1 << 15) - 1, 1 << 15, -(1 << 15),
                         (1 << 46) - 1, -(1 << 46)]]).astype(np.int64)
    jhi, jlo = jgh.split_hilo(jnp.asarray(v))
    thi, tlo = tgh.split_hilo(torch.from_numpy(v))
    assert thi.dtype == tlo.dtype == torch.int32
    np.testing.assert_array_equal(thi.numpy(), np.asarray(jhi))
    np.testing.assert_array_equal(tlo.numpy(), np.asarray(jlo))
    assert (tlo.numpy() >= 0).all()
    np.testing.assert_array_equal(
        thi.numpy().astype(np.int64) * (1 << tgh.SPLIT) + tlo.numpy(), v)
