"""K1 (`cmp_const_many`) on the CPU: the port's plain version and its
wrapper against the TPU kernel run in Pallas interpret mode and against
`jax.vmap(bitpack.cmp_const)`; K1's interval form (`in_interval_many`)
and its plain version against the reference's
`sql/fused_agg.py::_in_interval_many`.  Bit-exact (tolerance 0).  The
CUDA kernel itself is held against the same plain versions on the card
by `chip_smoke.py`."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from liquid_tpu.ops import bitpack as jbp  # noqa: E402
from liquid_tpu.ops import bitpack_pallas as jbpp  # noqa: E402
from liquid_tpu.sql import fused_agg as jfa  # noqa: E402
from liquid_tpu_torch.device import (  # noqa: E402
    u64_to_i64, words_to_numpy, words_to_tensor,
)
from liquid_tpu_torch.ops import bitpack as tbp  # noqa: E402
from liquid_tpu_torch.ops import bitpack_cuda as k1  # noqa: E402

OPS = ("eq", "ne", "lt", "lt_eq", "gt", "gt_eq")


def _case(width: int, bsz: int, seed: int):
    """Random planes plus constants of every class: 0, 1, random
    in-range, bits at or above the width, and 2^64-1."""
    rng = np.random.default_rng(seed)
    planes = rng.integers(0, 2 ** 32, (bsz, width, 256), dtype=np.uint64
                          ).astype(np.uint32)
    top = (1 << width) - 1
    pool = [0, 1, top, int(rng.integers(0, min(top, 1 << 62) + 1)),
            (1 << 64) - 1]
    if width < 64:
        pool += [1 << width, top + 1 + int(rng.integers(0, 1 << 20)),
                 (1 << 63) | int(rng.integers(0, min(top, 1 << 62) + 1))]
    cs = np.array([pool[i % len(pool)] if i < len(pool)
                   else pool[int(rng.integers(len(pool)))] for i in range(bsz)],
                  np.uint64)
    if bsz == 1:
        cs = np.array([pool[seed % len(pool)]], np.uint64)
    return planes, cs


def _vmap_ref(planes, cs):
    lt, eq = jax.vmap(jbp.cmp_const)(jnp.asarray(planes), jnp.asarray(cs))
    return np.asarray(lt), np.asarray(eq)


def _port(fn, planes, cs):
    lt, eq = fn(words_to_tensor(planes), torch.from_numpy(u64_to_i64(cs)))
    return words_to_numpy(lt), words_to_numpy(eq)


#: widths whose B = 1 and B = 3 cases also run the Pallas interpreter
#: (each interpreted shape costs about a second to trace on the CPU; every
#: (width, B) case is held against the vmapped reference)
_INTERPRET_SMALL_B = (1, 12, 56)


@pytest.mark.parametrize("width", [w for w in tbp.WIDTH_BUCKETS
                                   if w not in (0, 64)])
def test_plain_version_matches_pallas_interpret(width):
    for bsz in (1, 3, 17):
        planes, cs = _case(width, bsz, seed=width * 31 + bsz)
        vlt, veq = _vmap_ref(planes, cs)
        if bsz == 17 or width in _INTERPRET_SMALL_B:
            jlt, jeq = jbpp.cmp_const_many_pallas(
                jnp.asarray(planes), jnp.asarray(cs), interpret=True)
            np.testing.assert_array_equal(np.asarray(jlt), vlt)
            np.testing.assert_array_equal(np.asarray(jeq), veq)
        for fn in (k1.cmp_const_many_ref, k1.cmp_const_many):
            lt, eq = _port(fn, planes, cs)
            np.testing.assert_array_equal(lt, vlt)
            np.testing.assert_array_equal(eq, veq)


@pytest.mark.parametrize("width", [0, 1, 12, 64])
def test_cmp_const_op_many_matches_reference(width):
    planes, cs = _case(width, 5, seed=width + 100)
    t_planes = words_to_tensor(planes)
    t_cs = torch.from_numpy(u64_to_i64(cs))
    for op in OPS:
        ref = np.asarray(jbp.cmp_const_op_many(
            jnp.asarray(planes), jnp.asarray(cs), op))
        got = words_to_numpy(tbp.cmp_const_op_many(t_planes, t_cs, op))
        np.testing.assert_array_equal(got, ref)


def test_cpu_wrapper_never_counts_a_launch():
    before = k1.LAUNCHES["cmp_const_many"]
    planes, cs = _case(8, 3, seed=7)
    _port(k1.cmp_const_many, planes, cs)
    assert k1.LAUNCHES["cmp_const_many"] == before


def test_wrapper_rejects_bad_inputs():
    p = torch.zeros((2, 4, 256), dtype=torch.int32)
    c = torch.zeros(2, dtype=torch.int64)
    with pytest.raises(TypeError):
        k1.cmp_const_many(p.to(torch.int64), c)
    with pytest.raises(TypeError):
        k1.cmp_const_many(p, c.to(torch.int32))
    with pytest.raises(ValueError):
        k1.cmp_const_many(torch.zeros((2, 4, 128), dtype=torch.int32), c)
    with pytest.raises(ValueError):
        k1.cmp_const_many(p, torch.zeros(3, dtype=torch.int64))
    with pytest.raises(ValueError):
        k1.cmp_const_many(p.transpose(0, 1).contiguous().transpose(0, 1), c)
    with pytest.raises(ValueError):
        k1.cmp_const_many(torch.zeros((2, 65, 256), dtype=torch.int32), c)
    with pytest.raises(ValueError):
        k1.cmp_const_many(p.to("meta"), c.to("meta"))


def test_kernel_source_and_build_key():
    with open(k1.SOURCE) as f:
        src = f.read()
    assert "cmp_const_many_pallas" in src  # names the TPU kernel it replaces
    assert 'extern "C" int cmp_const_many_launch' in src
    assert k1.library_path().startswith(k1.BUILD_DIR)
    assert "arch=compute_90a,code=sm_90a" in k1.NVCC_FLAGS


@pytest.mark.parametrize("width", range(1, 65))
def test_interval_form_matches_reference_in_interval_many(width):
    """Masks of [lo, hi] per block: constants at, above and beyond the
    width (both bounds), lo > hi, and lo == hi."""
    planes, lo = _case(width, 9, seed=width + 500)
    hi = np.roll(lo, 3)  # every pairing of the pool, lo > hi included
    hi[0], hi[1] = lo[0], lo[1] >> np.uint64(1)
    ref = np.asarray(jfa._in_interval_many(
        jnp.asarray(planes), jnp.asarray(lo), jnp.asarray(hi)))
    t_planes = words_to_tensor(planes)
    t_lo, t_hi = (torch.from_numpy(u64_to_i64(x)) for x in (lo, hi))
    before = k1.LAUNCHES["cmp_const_many"]
    for fn in (k1.in_interval_many_ref, k1.in_interval_many):
        got = fn(t_planes, t_lo, t_hi)
        assert got.dtype == torch.int32 and got.shape == (9, 256)
        np.testing.assert_array_equal(words_to_numpy(got), ref)
    assert k1.LAUNCHES["cmp_const_many"] == before  # CPU: plain version


def test_interval_form_without_planes_follows_the_bounds():
    """w = 0: every stored value is 0, so a block's mask is full iff
    lo == 0 (the reference's lt/eq of a constant alone)."""
    lo = np.array([0, 0, 1, 5], np.uint64)
    hi = np.array([0, 7, 0, 9], np.uint64)
    planes = np.zeros((4, 0, 256), np.uint32)
    ref = np.asarray(jfa._in_interval_many(
        jnp.asarray(planes), jnp.asarray(lo), jnp.asarray(hi)))
    got = k1.in_interval_many(words_to_tensor(planes),
                              torch.from_numpy(u64_to_i64(lo)),
                              torch.from_numpy(u64_to_i64(hi)))
    np.testing.assert_array_equal(words_to_numpy(got), ref)


def test_interval_wrapper_rejects_bad_inputs():
    p = torch.zeros((2, 4, 256), dtype=torch.int32)
    c = torch.zeros(2, dtype=torch.int64)
    with pytest.raises(TypeError):
        k1.in_interval_many(p.to(torch.int64), c, c)
    with pytest.raises(TypeError):
        k1.in_interval_many(p, c, c.to(torch.int32))
    with pytest.raises(ValueError):
        k1.in_interval_many(torch.zeros((2, 4, 128), dtype=torch.int32), c, c)
    with pytest.raises(ValueError):
        k1.in_interval_many(p, c, torch.zeros(3, dtype=torch.int64))
    with pytest.raises(ValueError):
        k1.in_interval_many(p.transpose(0, 1).contiguous().transpose(0, 1),
                            c, c)
    with pytest.raises(ValueError):
        k1.in_interval_many(p, c, torch.zeros(4, dtype=torch.int64)[::2])
    with pytest.raises(ValueError):
        k1.in_interval_many(torch.zeros((2, 65, 256), dtype=torch.int32), c, c)
    with pytest.raises(ValueError):
        k1.in_interval_many(p.to("meta"), c.to("meta"), c.to("meta"))


def test_kernel_source_has_both_forms():
    with open(k1.SOURCE) as f:
        src = f.read()
    assert 'extern "C" int in_interval_many_launch' in src
    assert "_in_interval_many" in src  # names the reference pair it fuses
