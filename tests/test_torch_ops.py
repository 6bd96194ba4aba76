"""Port ops against the JAX package: masks, float bit images, bit-plane
pack/unpack and single-constant compares.  Every comparison is
bit-exact (tolerance 0): these are integer bit manipulations."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from liquid_tpu.ops import bitpack as jbp  # noqa: E402
from liquid_tpu.ops import floatbits as jfb  # noqa: E402
from liquid_tpu.ops import mask as jm  # noqa: E402
from liquid_tpu_torch.device import (  # noqa: E402
    popcount32, srl, words_to_numpy, words_to_tensor,
)
from liquid_tpu_torch.ops import bitpack as tbp  # noqa: E402
from liquid_tpu_torch.ops import floatbits as tfb  # noqa: E402
from liquid_tpu_torch.ops import mask as tm  # noqa: E402


def _rng(seed=0):
    return np.random.default_rng(seed)


def test_pack_unpack_bools_match_reference():
    bools = _rng(1).random(8192) < 0.3
    ref = np.asarray(jm.pack_bools(jnp.asarray(bools)))
    got = tm.pack_bools(torch.from_numpy(bools))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(words_to_numpy(got), ref)
    np.testing.assert_array_equal(tm.pack_bools_host(bools), ref)
    back = tm.unpack_bits(got).numpy()
    np.testing.assert_array_equal(back, np.asarray(jm.unpack_bits(
        jnp.asarray(ref))))
    np.testing.assert_array_equal(back, bools)
    np.testing.assert_array_equal(tm.unpack_bits_host(ref), bools)
    # batched form over [B, W]
    stack = _rng(2).random((3, 8192)) < 0.5
    np.testing.assert_array_equal(
        words_to_numpy(tm.pack_bools(torch.from_numpy(stack))),
        np.stack([np.asarray(jm.pack_bools(jnp.asarray(s))) for s in stack]))


def test_count_and_popcount_match_reference():
    words = _rng(3).integers(0, 2 ** 32, 256, dtype=np.uint64).astype(
        np.uint32)
    words[:4] = [0, 0xFFFFFFFF, 0x80000000, 1]
    t = words_to_tensor(words)
    assert int(tm.count(t)) == int(jm.count(jnp.asarray(words)))
    assert tm.count_host(words) == int(jm.count(jnp.asarray(words)))
    np.testing.assert_array_equal(
        popcount32(t).numpy(),
        [bin(int(w)).count("1") for w in words])


def test_logical_shift():
    x = torch.tensor([-1, -2 ** 31, 5], dtype=torch.int32)
    assert srl(x, 1).tolist() == [0x7FFFFFFF, 0x40000000, 2]
    y = torch.tensor([-1], dtype=torch.int64)
    assert srl(y, 60).tolist() == [0xF]
    assert srl(y, 64).tolist() == [0]


@pytest.mark.parametrize("length", [0, 1, 31, 32, 8191, 8192])
def test_all_set_matches_reference(length):
    np.testing.assert_array_equal(tm.all_set_host(8192, length),
                                  jm.all_set_host(8192, length))


def test_kleene_logic_matches_reference():
    rng = _rng(4)
    a_b, a_v, b_b, b_v = (rng.integers(0, 2 ** 32, 256, dtype=np.uint64)
                          .astype(np.uint32) for _ in range(4))
    ja = jm.BoolMask(jnp.asarray(a_b), jnp.asarray(a_v))
    jb = jm.BoolMask(jnp.asarray(b_b), jnp.asarray(b_v))
    ta = tm.BoolMask(words_to_tensor(a_b), words_to_tensor(a_v))
    tb = tm.BoolMask(words_to_tensor(b_b), words_to_tensor(b_v))
    for jr, tr in ((ja.and_kleene(jb), ta.and_kleene(tb)),
                   (ja.or_kleene(jb), ta.or_kleene(tb)),
                   (ja.not_(), ta.not_())):
        np.testing.assert_array_equal(words_to_numpy(tr.bits),
                                      np.asarray(jr.bits))
        np.testing.assert_array_equal(words_to_numpy(tr.valid),
                                      np.asarray(jr.valid))
        np.testing.assert_array_equal(words_to_numpy(tr.to_selection()),
                                      np.asarray(jr.to_selection()))


def test_f64_bits_adversarial_match_reference():
    tiny = np.finfo(np.float64).tiny
    vals = np.array([
        0.0, -0.0, 1.0, -1.0, np.inf, -np.inf, np.nan, -np.nan,
        np.float64(np.uint64(0x7FF0000000000123).view(np.float64)),  # sNaN
        tiny, -tiny, tiny / 2, -tiny / 2, 5e-324, -5e-324,  # subnormals
        np.finfo(np.float64).max, -np.finfo(np.float64).max,
        0.1, 1e300, 1e-300, 2.0 ** 1023, 2.0 ** -1022, 123456.789,
    ], np.float64)
    vals = np.concatenate([vals, _rng(5).standard_normal(64) * 1e6])
    ref = np.asarray(jfb.f64_bits(jnp.asarray(vals)))
    got = tfb.f64_bits(torch.from_numpy(vals)).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("width", tbp.WIDTH_BUCKETS)
def test_pack_unpack_planes_every_bucket(width):
    assert tbp.WIDTH_BUCKETS == jbp.WIDTH_BUCKETS
    assert tbp.bucket_for(width) == jbp.bucket_for(width)
    rng = _rng(10 + width)
    n = 8192
    if width == 0:
        vals = np.zeros(n, np.uint64)
    else:
        vals = rng.integers(0, 2 ** 63, n, dtype=np.uint64)
        if width == 64:
            vals |= (rng.random(n) < 0.5).astype(np.uint64) << np.uint64(63)
        else:
            vals &= np.uint64((1 << width) - 1)
    planes = tbp.pack_bitplanes_host(vals, width)
    np.testing.assert_array_equal(planes, jbp.pack_bitplanes_host(vals, width))
    np.testing.assert_array_equal(
        planes, np.asarray(jbp.pack_bitplanes(jnp.asarray(vals), width)))
    np.testing.assert_array_equal(tbp.unpack_bitplanes_host(planes), vals)
    # device decode: int64 bit images of the reference's u64 values
    stack = np.stack([planes, planes[:, ::-1]])
    got = tbp.unpack_bitplanes_many(words_to_tensor(stack)).numpy()
    ref = np.asarray(jbp.unpack_bitplanes_many(jnp.asarray(stack),
                                               jnp.uint64))
    np.testing.assert_array_equal(got.view(np.uint64), ref)


@pytest.mark.parametrize("width", [0, 1, 7, 12, 33, 64])
def test_cmp_const_single_matches_reference(width):
    rng = _rng(20 + width)
    bucket = tbp.bucket_for(width)
    planes = rng.integers(0, 2 ** 32, (bucket, 256), dtype=np.uint64
                          ).astype(np.uint32)
    consts = [0, 1, (1 << 64) - 1, int(rng.integers(0, 2 ** 62))]
    if bucket < 64:
        consts += [1 << bucket, (1 << bucket) - 1]
    t = words_to_tensor(planes)
    for c in consts:
        lt, eq = tbp.cmp_const(t, c)
        jlt, jeq = jbp.cmp_const(jnp.asarray(planes), np.uint64(c))
        np.testing.assert_array_equal(words_to_numpy(lt), np.asarray(jlt))
        np.testing.assert_array_equal(words_to_numpy(eq), np.asarray(jeq))
        for op in ("eq", "ne", "lt", "lt_eq", "gt", "gt_eq"):
            np.testing.assert_array_equal(
                words_to_numpy(tbp.cmp_const_op(t, c, op)),
                np.asarray(jbp.cmp_const_op(jnp.asarray(planes),
                                            np.uint64(c), op)))
