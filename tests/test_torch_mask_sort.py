"""The port's mask, bit-plane and sort primitives against the JAX
package's, bit for bit, on the CPU.

- `ops/mask.py`: `tail_mask` (int and tensor lengths), `all_set`,
  `none_set`, `unpack_many`, `and_`, `or_`, `not_`, `and_then` and
  `compact_indices` over empty, full, ragged-tail and random selections.
- `ops/bitpack.py`: `pack_bitplanes` / `unpack_bitplanes` on tensors
  against the reference's and the host twins, every width bucket; and
  `in_range` (K1's interval form) against the reference's, bounds inside,
  at and beyond the width and crossed.
- `ops/sort.py`: `sort_pairs`, `radix_sort_pairs` (stable, partial key
  widths, u64 keys past 2^63) and `argsort_selected` (stable, descending
  on unsigned keys and int64's minimum).
- `cache/expressions.parse_hint`, `PredicateColumn` and the cache
  package's exports; `io/parquet.unpack_id`; `bench/tpch_data.write_parquet`.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from liquid_tpu.cache import expressions as jexpr  # noqa: E402
from liquid_tpu.io import parquet as jparquet  # noqa: E402
from liquid_tpu.ops import bitpack as jbp  # noqa: E402
from liquid_tpu.ops import mask as jmask  # noqa: E402
from liquid_tpu.ops import sort as jsort  # noqa: E402
from liquid_tpu_torch import cache as tcache  # noqa: E402
from liquid_tpu_torch.cache import expressions as texpr  # noqa: E402
from liquid_tpu_torch.device import words_to_numpy, words_to_tensor  # noqa: E402
from liquid_tpu_torch.io import parquet as tparquet  # noqa: E402
from liquid_tpu_torch.ops import bitpack as tbp  # noqa: E402
from liquid_tpu_torch.ops import bitpack_cuda  # noqa: E402
from liquid_tpu_torch.ops import mask as tmask  # noqa: E402
from liquid_tpu_torch.ops import sort as tsort  # noqa: E402

CPU = torch.device("cpu")
N = 8192
#: selection densities: empty, full, ragged tails, random
KINDS = ("empty", "full", "tail_1", "tail_8191", "tail_100", "random_0.5",
         "random_0.01")


def _bools(kind, n=N, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "empty":
        return np.zeros(n, bool)
    if kind == "full":
        return np.ones(n, bool)
    if kind.startswith("tail_"):
        b = np.zeros(n, bool)
        b[:int(kind[5:])] = True
        return b
    return rng.random(n) < float(kind.split("_")[1])


def _jwords(bools):
    return np.asarray(jmask.pack_bools(jnp.asarray(bools)))


def _twords(bools):
    return words_to_tensor(tmask.pack_bools_host(bools))


def _same(t, j):
    assert np.array_equal(words_to_numpy(t), np.asarray(j, np.uint32))


@pytest.mark.parametrize("n_rows", [1, 32, 100, N, N + 5])
@pytest.mark.parametrize("length", [0, 1, 31, 32, 33, 100, N, N + 7])
def test_tail_mask_and_all_set(n_rows, length):
    length = min(length, n_rows)
    want = np.asarray(jmask.tail_mask(length, n_rows))
    _same(tmask.tail_mask(length, n_rows, device=CPU), want)
    _same(tmask.tail_mask(torch.tensor(length), n_rows, device=CPU), want)
    # a traced length takes the reference's arithmetic branch
    _same(tmask.tail_mask(length, n_rows, device=CPU),
          np.asarray(jmask.tail_mask(jnp.asarray(length), n_rows)))
    _same(tmask.all_set(n_rows, length, device=CPU),
          np.asarray(jmask.all_set(n_rows, length)))
    _same(tmask.all_set(n_rows, device=CPU), np.asarray(jmask.all_set(n_rows)))
    _same(tmask.none_set(n_rows, device=CPU), np.asarray(jmask.none_set(n_rows)))


@pytest.mark.parametrize("kind", KINDS)
def test_algebra_and_unpack_many(kind):
    a, b = _bools(kind, seed=1), _bools("random_0.5", seed=2)
    ja, jb, ta, tb = _jwords(a), _jwords(b), _twords(a), _twords(b)
    _same(tmask.and_(ta, tb), jmask.and_(ja, jb))
    _same(tmask.or_(ta, tb), jmask.or_(ja, jb))
    _same(tmask.not_(ta), jmask.not_(jnp.asarray(ja)))
    stacked = np.stack([ja, jb])
    got = tmask.unpack_many(words_to_tensor(stacked)).numpy()
    assert np.array_equal(got, np.asarray(jmask.unpack_many(
        jnp.asarray(stacked))))


@pytest.mark.parametrize("filt_kind", ("empty", "full", "random_0.5"))
@pytest.mark.parametrize("kind", KINDS)
def test_and_then(kind, filt_kind):
    sel = _bools(kind, seed=3)
    k = int(sel.sum())
    filt = np.zeros(N, bool)
    filt[:k] = _bools(filt_kind, n=k, seed=4)
    want = np.asarray(jmask.and_then(jnp.asarray(_jwords(sel)),
                                     jnp.asarray(_jwords(filt))))
    got = tmask.and_then(_twords(sel), _twords(filt))
    _same(got, want)
    # the meaning: the selected rows, in order, kept where filt says so
    rows = np.flatnonzero(sel)
    expect = np.zeros(N, bool)
    expect[rows[filt[:k]]] = True
    assert np.array_equal(tmask.unpack_bits(got).numpy(), expect)


@pytest.mark.parametrize("n_rows", [N, 8000, 37])
@pytest.mark.parametrize("kind", KINDS)
def test_compact_indices(kind, n_rows):
    sel = _bools(kind, seed=5)
    if n_rows < N:
        sel[n_rows:] = False
    jidx, jk = jmask.compact_indices(jnp.asarray(_jwords(sel)), n_rows)
    tidx, tk = tmask.compact_indices(_twords(sel), n_rows)
    assert tidx.dtype == torch.int32
    assert int(tk) == int(jk) == int(sel[:n_rows].sum())
    assert np.array_equal(tidx.numpy(), np.asarray(jidx))


@pytest.mark.parametrize("width", [0, 1, 5, 7, 10, 17, 31, 32, 33, 48, 63, 64])
def test_pack_unpack_bitplanes(width):
    rng = np.random.default_rng(width)
    n = 4096
    hi = (1 << width) - 1 if width else 0
    vals = rng.integers(0, hi, n, dtype=np.uint64, endpoint=True)
    vals[:3] = [0, hi, hi >> 1]
    jplanes = np.asarray(jbp.pack_bitplanes(jnp.asarray(vals), width))
    tplanes = tbp.pack_bitplanes(torch.from_numpy(vals.view(np.int64)),
                                 width)
    assert tplanes.dtype == torch.int32
    assert np.array_equal(words_to_numpy(tplanes), jplanes)
    assert np.array_equal(jplanes, tbp.pack_bitplanes_host(vals, width))
    got = tbp.unpack_bitplanes(tplanes).numpy().view(np.uint64)
    assert np.array_equal(got, vals)
    assert np.array_equal(got, np.asarray(jbp.unpack_bitplanes(
        jnp.asarray(jplanes), jnp.uint64)))
    assert tbp.unpack_bitplanes(tplanes, torch.int32).dtype == torch.int32


@pytest.mark.parametrize("n", [32, 8192, 8192 * 3 + 96])
@pytest.mark.parametrize("width", [0, 1, 10, 33, 64])
def test_in_range(width, n, monkeypatch):
    rng = np.random.default_rng(n + width)
    top = (1 << width) - 1 if width else 0
    vals = rng.integers(0, top, n, dtype=np.uint64, endpoint=True)
    jplanes = jbp.pack_bitplanes(jnp.asarray(vals), width)
    tplanes = words_to_tensor(np.asarray(jplanes))
    launches = []
    real = bitpack_cuda.in_interval_many
    monkeypatch.setattr(bitpack_cuda, "in_interval_many",
                        lambda *a: launches.append(1) or real(*a))
    mid = int(vals[n // 2])
    for lo, hi in ((0, top), (mid, mid), (top // 3, top // 2), (mid, 0),
                   (0, 1 << 64 - 1), (top + 1, (1 << 64) - 1)):
        if width == 64 and lo > top:
            continue
        want = np.asarray(jbp.in_range(jplanes, (jnp.uint64(lo),
                                                 jnp.uint64(hi))))
        _same(tbp.in_range(tplanes, (lo, hi)), want)
        inside = (vals >= np.uint64(lo)) & (vals <= np.uint64(hi))
        assert np.array_equal(tmask.unpack_bits_host(want)[:n], inside)
    assert len(launches) >= 5  # one K1 interval launch per call


@pytest.mark.parametrize("seed", range(3))
def test_sort_pairs(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 5000))
    k = rng.integers(0, 1 << 40, n).astype(np.int64)
    k[: n // 3] = k[0]  # ties keep row order
    v = rng.integers(0, 1000, n).astype(np.int64)
    jk, jv = jsort.sort_pairs(jnp.asarray(k), jnp.asarray(v))
    tk, tv = tsort.sort_pairs(torch.from_numpy(k), torch.from_numpy(v))
    assert np.array_equal(tk.numpy(), np.asarray(jk))
    assert np.array_equal(tv.numpy(), np.asarray(jv))


def test_sort_pairs_unsigned_past_the_sign_bit():
    k = np.array([2**64 - 1, 5, 2**63, 0, 5], dtype=np.uint64)
    v = np.arange(5, dtype=np.int64)
    jk, jv = jsort.sort_pairs(jnp.asarray(k), jnp.asarray(v))
    tk, tv = tsort.sort_pairs(torch.from_numpy(k.view(np.int64)).view(
        torch.uint64), torch.from_numpy(v))
    assert np.array_equal(tk.view(torch.int64).numpy().view(np.uint64),
                          np.asarray(jk))
    assert tv.tolist() == np.asarray(jv).tolist() == [3, 1, 4, 2, 0]


@pytest.mark.parametrize("dtype,bits", [(np.uint32, 32), (np.uint32, 16),
                                        (np.uint64, 64), (np.uint64, 24)])
def test_radix_sort_pairs(dtype, bits):
    rng = np.random.default_rng(7)
    n = 4096
    hi = (1 << bits) - 1
    k = rng.integers(0, hi, n, dtype=np.uint64).astype(dtype)
    k[:40] = k[40]
    v = np.arange(n, dtype=np.int64)
    jk, jv = jsort.radix_sort_pairs(jnp.asarray(k), jnp.asarray(v), bits)
    signed = np.int32 if dtype == np.uint32 else np.int64
    tk, tv = tsort.radix_sort_pairs(torch.from_numpy(k.view(signed)),
                                    torch.from_numpy(v), bits)
    assert np.array_equal(tk.numpy().view(dtype), np.asarray(jk))
    assert np.array_equal(tv.numpy(), np.asarray(jv))
    order = np.argsort(k, kind="stable")
    assert np.array_equal(tv.numpy(), v[order])


@pytest.mark.parametrize("dtype,bits", [(np.uint32, 12), (np.uint64, 20),
                                        (np.uint64, 57)])
def test_radix_sort_pairs_partial_key(dtype, bits):
    """Keys wider than `key_bits`: the reference sorts by the digits its
    passes cover, the low 8 * ceil(key_bits / 8) bits."""
    rng = np.random.default_rng(11)
    n = 2048
    k = rng.integers(0, np.iinfo(dtype).max, n, dtype=dtype, endpoint=True)
    v = np.arange(n, dtype=np.int64)
    jk, jv = jsort.radix_sort_pairs(jnp.asarray(k), jnp.asarray(v), bits)
    signed = np.int32 if dtype == np.uint32 else np.int64
    tk, tv = tsort.radix_sort_pairs(torch.from_numpy(k.view(signed)),
                                    torch.from_numpy(v), bits)
    assert np.array_equal(tk.numpy().view(dtype), np.asarray(jk))
    assert np.array_equal(tv.numpy(), np.asarray(jv))


def test_radix_sort_stability_and_unsigned_dtypes():
    k = np.array([3, 1, 3, 1, 3], dtype=np.uint32)
    v = np.arange(5, dtype=np.int64)
    _, jv = jsort.radix_sort_pairs(jnp.asarray(k), jnp.asarray(v), 8)
    _, tv = tsort.radix_sort_pairs(torch.from_numpy(k.view(np.int32)),
                                   torch.from_numpy(v), 8)
    assert tv.tolist() == np.asarray(jv).tolist() == [1, 3, 0, 2, 4]
    big = torch.tensor([2**64 - 1, 5, 2**63], dtype=torch.uint64)
    tk, tv = tsort.radix_sort_pairs(big, torch.arange(3))
    assert tk.dtype == torch.uint64 and tv.tolist() == [1, 2, 0]


@pytest.mark.parametrize("keys", [
    np.array([5, 2, 5, 2], dtype=np.int64),
    np.array([0, -2**63, 7, 7, -1], dtype=np.int64),
    np.array([1.5, -0.0, 1.5, -3.25], dtype=np.float64),
    np.random.default_rng(0).integers(-50, 50, 3000).astype(np.int32)])
@pytest.mark.parametrize("descending", [False, True])
def test_argsort_selected(keys, descending):
    want = np.asarray(jsort.argsort_selected(jnp.asarray(keys), descending))
    got = tsort.argsort_selected(torch.from_numpy(keys), descending)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


def test_argsort_selected_unsigned_descending():
    k = np.array([5, 0, 3, 2**64 - 1], dtype=np.uint64)
    want = np.asarray(jsort.argsort_selected(jnp.asarray(k), True))
    got = tsort.argsort_selected(torch.from_numpy(k.view(np.int64)).view(
        torch.uint64), True)
    assert got.tolist() == want.tolist() == [3, 0, 2, 1]


@pytest.mark.parametrize("text", [
    "extract_date32:year", "extract_date32:dow", "substring_search",
    "predicate_column", "variant_get:a.b@int64,c", "variant_get:x@utf8",
    "nonsense", ""])
def test_parse_hint(text):
    want = jexpr.parse_hint(text)
    got = texpr.parse_hint(text)
    if want is None:
        assert got is None
    else:
        assert type(got).__name__ == type(want).__name__
        assert got.__dict__ == want.__dict__


def test_cache_package_exports_the_reference_names():
    from liquid_tpu import cache as jcache
    names = {n for n in dir(jcache) if not n.startswith("_")
             and n[0].isupper()}
    assert names <= set(dir(tcache)), names - set(dir(tcache))
    assert tcache.PredicateColumn() == texpr.PredicateColumn()
    assert texpr.PredicateColumn() in {texpr.PredicateColumn()}


@pytest.mark.parametrize("parts", [(0, 0, 0, 0), (1, 2, 3, 4),
                                   (65535, 65535, 65535, 65535),
                                   (7, 0, 300, 65000)])
def test_unpack_id(parts):
    eid = tparquet.pack_id(*parts)
    assert eid == jparquet.pack_id(*parts)
    assert tparquet.unpack_id(eid) == jparquet.unpack_id(eid) == parts


def test_tpch_write_parquet(tmp_path):
    import pyarrow.parquet as pq
    from liquid_tpu_torch.bench import tpch_data
    tables = tpch_data.generate(0.001)
    paths = tpch_data.write_parquet(tables, str(tmp_path))
    assert sorted(paths) == sorted(tables)
    for name, p in paths.items():
        assert p == str(tmp_path / f"{name}.parquet")
        assert pq.read_table(p).equals(tables[name])
