"""K3 (`count_gt`) and K4 (`cmp_const_planes`) on the CPU: the port's
plain versions and wrappers against the TPU kernels run in Pallas
interpret mode, on widths 0, 1, 10, 33 and 64, flat and prepped planes,
and constants 0, 1, random, 2^w-1, with bits at or above the width, and
2^64-1.  Bit-exact (tolerance 0): masks and counts are integers.  The
CUDA kernels themselves are held against the same plain versions on the
card by `chip_smoke.py`."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from liquid_tpu.ops import bitpack_pallas as jbpp  # noqa: E402
from liquid_tpu_torch.device import words_to_numpy, words_to_tensor  # noqa: E402
from liquid_tpu_torch.ops import bitpack_cuda as k  # noqa: E402


def _constants(width: int, rng) -> list:
    top = (1 << width) - 1
    out = [0, 1, top, int(rng.integers(0, top + 1, dtype=np.uint64)),
           (1 << 64) - 1]
    if width < 64:
        out += [1 << width, (1 << 63) | top]
    return sorted(set(out))


#: (width, W words): one Pallas tile (W 16384) is the interpreter's unit;
#: W 4096 pads inside the reference
CASES = [(0, 256), (1, 4096), (10, 16384), (33, 4096), (64, 256)]


@pytest.mark.parametrize("width,n_words", CASES,
                         ids=[f"w{w}-W{n}" for w, n in CASES])
def test_plain_versions_match_pallas_interpret(width, n_words):
    rng = np.random.default_rng(width * 7 + n_words)
    planes = rng.integers(0, 1 << 32, (width, n_words), dtype=np.uint64
                          ).astype(np.uint32)
    tplanes = words_to_tensor(planes)
    for c in _constants(width, rng):
        jc = jnp.uint64(c)
        want_n = int(jbpp.count_gt(jnp.asarray(planes), jc, interpret=True))
        jlt, jeq = jbpp.cmp_const_planes(jnp.asarray(planes), jc,
                                         interpret=True)
        for form in (tplanes, k.prep(tplanes)):
            for count in (k.count_gt_ref, k.count_gt):
                got = count(form, c)
                assert got.dtype == torch.int32 and got.dim() == 0
                assert int(got) == want_n, (width, c)
            for cmp in (k.cmp_const_planes_ref, k.cmp_const_planes):
                lt, eq = cmp(form, c)
                np.testing.assert_array_equal(words_to_numpy(lt),
                                              np.asarray(jlt))
                np.testing.assert_array_equal(words_to_numpy(eq),
                                              np.asarray(jeq))


def test_numpy_constants_and_count_against_numpy():
    """The count equals numpy's on the decoded values, for numpy and
    Python integer constants alike."""
    from liquid_tpu_torch.ops import bitpack as bp
    rng = np.random.default_rng(5)
    vals = rng.integers(0, 1 << 10, 1 << 14).astype(np.uint64)
    planes = words_to_tensor(bp.pack_bitplanes_host(vals, 10))
    for c in (np.uint64(0), np.int64(511), 1023, np.uint32(700)):
        assert int(k.count_gt(k.prep(planes), c)) == int((vals > int(c)).sum())


def test_wrapper_rejects_bad_inputs():
    p = torch.zeros((4, 256), dtype=torch.int32)
    for fn in (k.count_gt, k.cmp_const_planes):
        with pytest.raises(TypeError):
            fn(p.to(torch.int64), 1)
        with pytest.raises(TypeError):
            fn(p, torch.tensor(1))          # a tensor constant would sync
        with pytest.raises(TypeError):
            fn(p, 1.5)
        with pytest.raises(ValueError):
            fn(p, -1)
        with pytest.raises(ValueError):
            fn(p, 1 << 64)
        with pytest.raises(ValueError):
            fn(torch.zeros((65, 256), dtype=torch.int32), 1)
        with pytest.raises(ValueError):
            fn(torch.zeros((2, 4, 256), dtype=torch.int32), 1)
        with pytest.raises(ValueError):
            fn(torch.zeros((256, 4), dtype=torch.int32).t(), 1)
        with pytest.raises(ValueError, match="contiguous"):
            # a strided prepped form would be copied by a reshape
            fn(torch.zeros((4, 2, 128), dtype=torch.int32).transpose(0, 1), 1)
        with pytest.raises(ValueError):
            fn(p.to("meta"), 1)
    with pytest.raises(ValueError):
        k.prep(torch.zeros((4, 100), dtype=torch.int32))


def test_count_refuses_an_int32_overflow():
    """2^26 words is 2^31 rows: the int32 count could overflow."""
    with pytest.raises(ValueError, match="overflow"):
        k.count_gt(torch.empty((0, 1 << 26), dtype=torch.int32), 1)


def test_prep_is_a_view():
    p = torch.zeros((3, 512), dtype=torch.int32)
    t = k.prep(p)
    assert t.shape == (3, 4, 128) and t.data_ptr() == p.data_ptr()


def test_cpu_wrapper_never_counts_a_launch():
    before = dict(k.LAUNCHES)
    p = torch.randint(-2 ** 31, 2 ** 31, (10, 4096), dtype=torch.int32)
    k.count_gt(p, 100)
    k.cmp_const_planes(k.prep(p), 100)
    k.count_gt(p, 1 << 10)          # over-width: decided on the host
    assert k.LAUNCHES == before


def test_kernel_source_names_the_tpu_kernels():
    with open(k.PLANES_SOURCE) as f:
        src = f.read()
    assert "count_gt" in src and "_cmp_count_kernel" in src
    assert "cmp_const_planes" in src and "_cmp_kernel" in src
    assert 'extern "C" int count_gt_launch' in src
    assert 'extern "C" int cmp_const_planes_launch' in src
    assert "arch=compute_90a,code=sm_90a" in k.NVCC_FLAGS
