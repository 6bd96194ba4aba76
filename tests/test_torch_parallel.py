"""The port's mesh primitives (`liquid_tpu_torch/parallel/dist.py`) against
the reference's on its 8-device virtual mesh, on the CPU.

The port's mesh is eight CPU shards (`make_mesh(devices=["cpu"] * 8)`);
the reference's is `dist.make_mesh(8)` over the virtual devices of
`tests/conftest.py`.  Inputs are numpy arrays from a seed, at most 4,096
rows per call.  Masks, counts, sums, keys and destinations are integers:
every comparison is exact (tolerance 0).  A shuffle is compared per
destination as multisets (the two packages pack a bucket in the same row
order, but the test does not rely on it)."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from liquid_tpu.ops import bitpack as jbp  # noqa: E402
from liquid_tpu.parallel import dist as jdist  # noqa: E402
from liquid_tpu_torch.device import words_to_numpy, words_to_tensor  # noqa: E402
from liquid_tpu_torch.ops import bitpack as tbp  # noqa: E402
from liquid_tpu_torch.ops import mask as tmops  # noqa: E402
from liquid_tpu_torch.parallel import dist  # noqa: E402

N_DEV = 8


@pytest.fixture(scope="module")
def meshes():
    assert len(jax.devices()) >= N_DEV, jax.devices()
    return dist.make_mesh(devices=["cpu"] * N_DEV), jdist.make_mesh(N_DEV)


def _ref_planes(jmesh, planes: np.ndarray):
    return jax.device_put(jnp.asarray(planes),
                          NamedSharding(jmesh, P(None, jdist.DATA_AXIS)))


def _shard_words(mesh, words: np.ndarray, axis: int = 0):
    return dist.shard_rows(mesh, words_to_tensor(words), axis)


# -- the mesh --------------------------------------------------------------------

def test_make_mesh_repeats_devices():
    mesh = dist.make_mesh(devices=["cpu"] * 8)
    assert mesh.n == 8
    assert all(d == torch.device("cpu") for d in mesh.devices)
    parts = dist.shard_rows(mesh, np.arange(64))
    assert [p.tolist() for p in parts] == [list(range(8 * i, 8 * i + 8))
                                           for i in range(8)]
    cols = dist.shard_rows(mesh, np.arange(32).reshape(2, 16), axis=1)
    assert [p.tolist() for p in cols] == [[[2 * i, 2 * i + 1],
                                           [16 + 2 * i, 17 + 2 * i]]
                                          for i in range(8)]
    assert [p.tolist() for p in dist.replicate(mesh, [1, 2])] == [[1, 2]] * 8


def test_make_mesh_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dist.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dist.make_mesh(devices=["cuda:0"] * 4)
    with pytest.raises(ValueError, match="does not split"):
        dist.shard_rows(dist.make_mesh(devices=["cpu"] * 3), np.arange(10))


# -- the hash and the destinations -------------------------------------------------

def test_hash_and_destinations_match_reference():
    rng = np.random.default_rng(40)
    keys = rng.integers(0, 1 << 64, 4096, dtype=np.uint64)
    keys[:4] = [0, 1, (1 << 63), (1 << 64) - 1]
    want_h = np.asarray(jdist._hash64(jnp.asarray(keys)))
    got_h = dist._hash64(torch.from_numpy(keys.view(np.int64))).numpy()
    np.testing.assert_array_equal(got_h.view(np.uint64), want_h)
    for n in (1, 3, 4, 8):
        want = np.asarray((jdist._hash64(jnp.asarray(keys)) % jnp.uint64(n))
                          .astype(jnp.int32))
        got = dist.dest_of(torch.from_numpy(keys.view(np.int64)), n).numpy()
        np.testing.assert_array_equal(got, want)
        if n == 3:  # a signed % disagrees on the negative images
            assert (np.mod(got_h, n) != want).any()


# -- the shard-local predicate: K4's plain version vs bp.cmp_const_op -------------

OPS = ("eq", "ne", "lt", "lt_eq", "gt", "gt_eq")


@pytest.mark.parametrize("width", [0, 1, 7, 12, 33, 64])
def test_cmp_planes_op_matches_reference(width):
    rng = np.random.default_rng(width + 11)
    n = 4096
    top = (1 << width) - 1
    vals = (rng.integers(0, 1 << 63, n, dtype=np.uint64)
            | rng.integers(0, 2, n, dtype=np.uint64) << np.uint64(63))
    vals &= np.uint64(top)
    planes = tbp.pack_bitplanes_host(vals, width)
    jplanes = jbp.pack_bitplanes(jnp.asarray(vals), width)
    np.testing.assert_array_equal(np.asarray(jplanes), planes)
    bucket = planes.shape[0]
    consts = {0, 1, top, int(vals[5]), (1 << 64) - 1}
    if bucket < 64:  # beyond the bucket, and beyond the logical width
        consts |= {1 << bucket, (1 << 63) | top}
    if width < 64:
        consts.add(top + 1)
    tplanes = words_to_tensor(planes)
    for c in sorted(consts):
        for op in OPS:
            want = np.asarray(jbp.cmp_const_op(jplanes, jnp.uint64(c), op))
            got = words_to_numpy(dist.cmp_planes_op(tplanes, c, op))
            np.testing.assert_array_equal(got, want, err_msg=f"{c} {op}")
    # the mesh's plan: this stack's predicate is one launch of K4's fused
    # form, w = 0 included (decided in the kernel)
    sel = torch.full((tplanes.shape[1],), -1, dtype=torch.int32)
    assert dist.k4_launches(sel, [(tplanes, 0, "eq", None)]) == 1


# -- the primitives ------------------------------------------------------------------

def test_dist_filter_count(meshes):
    mesh, jmesh = meshes
    rng = np.random.default_rng(0)
    n = 4096
    real = n - 100  # trailing rows are padding and must not count
    vals = rng.integers(0, 1000, n).astype(np.uint64)
    vals[real:] = 0
    valid = np.zeros(n, bool)
    valid[:real] = True
    planes = tbp.pack_bitplanes_host(vals, 10)
    vmask = tmops.pack_bools_host(valid)
    want = jax.jit(jdist.dist_filter_count(jmesh))(
        _ref_planes(jmesh, planes),
        jdist.shard_rows(jmesh, jnp.asarray(vmask)), jnp.uint64(500))
    got = dist.dist_filter_count(mesh)(
        _shard_words(mesh, planes, 1), _shard_words(mesh, vmask), 500)
    assert got.tolist() == np.asarray(want).tolist() \
        == [int((vals[:real] != 500).sum())]


def test_dist_filter_agg(meshes):
    mesh, jmesh = meshes
    rng = np.random.default_rng(1)
    n = 4096
    vals = rng.integers(0, 1024, n).astype(np.uint64)
    codes = rng.integers(0, 64, n).astype(np.int32)
    weights = rng.integers(0, 100, n).astype(np.int64)
    planes = tbp.pack_bitplanes_host(vals, 10)
    wc, ws = jax.jit(jdist.dist_filter_agg(jmesh, 64))(
        _ref_planes(jmesh, planes),
        jdist.shard_rows(jmesh, jnp.asarray(codes)),
        jdist.shard_rows(jmesh, jnp.asarray(weights)), jnp.uint64(512))
    gc, gs = dist.dist_filter_agg(mesh, 64)(
        _shard_words(mesh, planes, 1), dist.shard_rows(mesh, codes),
        dist.shard_rows(mesh, weights), 512)
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    m = vals > 512
    np.testing.assert_array_equal(gs.numpy(), np.bincount(
        codes[m], weights=weights[m], minlength=64).astype(np.int64))


def _per_dest(n: int, arrays, mask):
    """Global [n * n * cap] arrays (the reference's layout) -> per
    destination, the sorted tuples of its masked rows."""
    per = len(mask) // n
    out = []
    for d in range(n):
        m = np.asarray(mask[d * per:(d + 1) * per])
        out.append(sorted(zip(*[np.asarray(a[d * per:(d + 1) * per])[m]
                                .tolist() for a in arrays])))
    return out


def _host(parts):
    """A sharded value, concatenated on the host."""
    return np.concatenate([p.numpy() for p in parts])


@pytest.mark.parametrize("skewed", [False, True], ids=["uniform", "skewed"])
def test_dist_shuffle_by_key(meshes, skewed):
    mesh, jmesh = meshes
    rng = np.random.default_rng(2)
    n = 4096
    keys = rng.integers(0, 1 << 40, n).astype(np.uint64)
    if skewed:  # every row one key: 2x the fair share must overflow
        keys[:] = 0
    values = np.arange(n, dtype=np.int64)
    rk, rv, rm, ovf = jax.jit(jdist.dist_shuffle_by_key(jmesh, n // N_DEV))(
        jdist.shard_rows(jmesh, jnp.asarray(keys)),
        jdist.shard_rows(jmesh, jnp.asarray(values)))
    gk, gv, gm, govf = dist.dist_shuffle_by_key(mesh, n // N_DEV)(
        dist.shard_rows(mesh, keys.view(np.int64)),
        dist.shard_rows(mesh, values))
    want = _per_dest(N_DEV, [np.asarray(rk).view(np.int64), rv], rm)
    got = _per_dest(N_DEV, [_host(gk), _host(gv)], _host(gm))
    assert got == want
    assert _host(govf).tolist() == np.asarray(ovf).tolist()
    lost = int(_host(govf).sum())
    assert lost + int(_host(gm).sum()) == n
    assert (lost > 0) == skewed
    for d, rows in enumerate(got):  # each key on its hash's device
        dests = dist.dest_of(torch.tensor([k for k, _v in rows],
                                          dtype=torch.int64), N_DEV)
        assert (dests == d).all()


def test_dist_lookup_join(meshes):
    mesh, jmesh = meshes
    rng = np.random.default_rng(5)
    n_probe, n_build = 1024, 256
    build_keys = np.arange(1, n_build + 1).astype(np.int64)
    build_vals = build_keys * 10
    probe_keys = rng.choice(build_keys, n_probe).astype(np.int64)
    probe_vals = rng.integers(0, 100, n_probe).astype(np.int64)
    probe_keys[:32] = 10_000 + np.arange(32)  # misses
    args = (probe_keys, probe_vals, build_keys, build_vals)
    want = jdist.dist_lookup_join(jmesh, n_probe // 8, n_build // 8)(
        *[jdist.shard_rows(jmesh, jnp.asarray(a)) for a in args])
    got = dist.dist_lookup_join(mesh, n_probe // 8, n_build // 8)(
        *[dist.shard_rows(mesh, a) for a in args])
    assert int(np.asarray(want[4]).sum()) == int(_host(got[4]).sum()) == 0
    w = _per_dest(N_DEV, [want[0], want[1], want[2], want[3]],
                  np.ones(len(want[0]), bool))
    g = _per_dest(N_DEV, [_host(got[0]), _host(got[1]), _host(got[2]),
                          _host(got[3])], np.ones(len(want[0]), bool))
    assert g == w
    hit = _host(got[3])
    assert hit.sum() == (probe_keys <= n_build).sum()
    pk, joined = _host(got[0]), _host(got[2])
    assert (joined[hit] == pk[hit] * 10).all()


def test_dist_agg_by_key_skewed(meshes):
    mesh, jmesh = meshes
    rng = np.random.default_rng(6)
    n = 2048
    keys = rng.integers(0, 50, n).astype(np.int64)
    keys[: n // 2] = 7  # half the rows carry one key
    values = rng.integers(0, 1000, n).astype(np.int64)
    wk, ws, wv, wovf = jdist.dist_agg_by_key(jmesh, n // 8)(
        jdist.shard_rows(jmesh, jnp.asarray(keys)),
        jdist.shard_rows(jmesh, jnp.asarray(values)))
    gk, gs, gv, govf = dist.dist_agg_by_key(mesh, n // 8)(
        dist.shard_rows(mesh, keys), dist.shard_rows(mesh, values))
    assert int(_host(govf).sum()) == int(np.asarray(wovf).sum()) == 0
    assert _per_dest(N_DEV, [_host(gk), _host(gs)], _host(gv)) == \
        _per_dest(N_DEV, [wk, ws], wv)
    got = {int(k): int(s) for k, s, v in zip(_host(gk), _host(gs),
                                             _host(gv)) if v}
    want = {}
    for k, v in zip(keys.tolist(), values.tolist()):
        want[k] = want.get(k, 0) + v
    assert got == want


def test_collectives_count_into_diag():
    dist.reset_diag()
    parts = [torch.arange(4, dtype=torch.int64) + i for i in range(3)]
    assert dist.psum(parts).tolist() == [3, 6, 9, 12]
    assert dist.pmin(parts).tolist() == [0, 1, 2, 3]
    assert dist.pmax(parts).tolist() == [2, 3, 4, 5]
    assert dist.DIAG["collectives"] == 3
    assert dist.DIAG["collective_bytes"] == 3 * 4 * 8
    dist.reset_diag()
    assert dist.DIAG["collectives"] == 0 and dist.DIAG["k4_planned"] == 0
