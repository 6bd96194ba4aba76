"""The cache's squeezed and disk tiers: the port's `LiquidCache` against
the JAX package's, both on the CPU.

- The scripts of `tests/test_snapshots.py` (insert and transcode, the
  eviction pipeline at 60,000 bytes, `TranscodeEvict`, the string and
  float squeezes, flush-all, LRU) give the same event trace in both
  packages, equal to the stored `tests/snapshots/*.snap` (read only).
- The cases of `tests/test_cache.py` on the lower tiers (the squeeze
  pipeline, a squeezed predicate with no IO, the date32 component read,
  flush and read back, hydration, disk-budget eviction, the quantized
  squeeze) give the reference's states and `stats()`.
- `eval_predicate_many` and `get_arrow_many` over a row group whose
  blocks sit in every state (liquid, squeezed, disk-liquid, arrow,
  disk-arrow) give the reference's masks and arrays.
- The budget's disk half, the FIFO policy, the access tracer's parquet
  flush, and a VariantGet hint keeping the block arrow until a squeeze
  shreds it."""
import os

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402
import pyarrow as pa  # noqa: E402
import pyarrow.parquet as pq  # noqa: E402

from liquid_tpu import cache as jcache  # noqa: E402
from liquid_tpu.arrays.base import Predicate as JPred  # noqa: E402
from liquid_tpu.cache import policies as jpol  # noqa: E402
from liquid_tpu_torch.arrays.base import Predicate as TPred  # noqa: E402
from liquid_tpu_torch.cache import core as tcore  # noqa: E402
from liquid_tpu_torch.cache import policies as tpol  # noqa: E402
from liquid_tpu_torch.cache.budget import BudgetAccounting  # noqa: E402
from liquid_tpu_torch.cache.expressions import (  # noqa: E402
    ExtractDate32, VariantGet)
from liquid_tpu_torch.device import words_to_numpy  # noqa: E402
from liquid_tpu_torch.ops import mask as tmops  # noqa: E402

SNAP_DIR = os.path.join(os.path.dirname(__file__), "snapshots")


class _Pkg:
    """One package's cache surface, so a script runs in both."""

    def __init__(self, side):
        self.side = side
        self.pol = jpol if side == "j" else tpol
        self.Pred = JPred if side == "j" else TPred

    def builder(self, tmp_path, mem):
        if self.side == "j":
            b = jcache.LiquidCacheBuilder()
        else:
            b = tcore.LiquidCacheBuilder().with_device("cpu")
        return (b.with_max_memory_bytes(mem)
                .with_disk_path(str(tmp_path / self.side / "s.bin")))


PKGS = (_Pkg("j"), _Pkg("t"))


def _events_text(cache) -> str:
    return "\n".join(f"{e.kind} {e.entry_id}"
                     + (f" {e.detail}" if e.detail else "")
                     for e in cache.observer.consume_event_trace())


def _ints(n=8192, lo=0, hi=1000, seed=0):
    rng = np.random.default_rng(seed)
    return pa.array(rng.integers(lo, hi, n).astype(np.int64))


def _strings(n=8192, seed=0):
    rng = np.random.default_rng(seed)
    return pa.array(rng.choice(["alpha", "beta", "gamma", "delta"], n))


def _insert_transcode(pkg, tmp_path):
    cache = pkg.builder(tmp_path, 1 << 24).with_trace_events(True).build()
    for i in range(3):
        cache.insert(i, _ints(seed=i))
    return cache


def _eviction_pipeline(pkg, tmp_path):
    cache = pkg.builder(tmp_path, 60_000).with_trace_events(True).build()
    for i in range(8):
        cache.insert(i, _ints(seed=i))
    cache.get(0)
    cache.get(7)
    return cache


def _transcode_evict(pkg, tmp_path):
    cache = (pkg.builder(tmp_path, 60_000).with_trace_events(True)
             .with_squeeze_policy(pkg.pol.TranscodeEvict()).build())
    for i in range(8):
        cache.insert(i, _ints(seed=i))
    return cache


def _string_squeeze(pkg, tmp_path):
    cache = pkg.builder(tmp_path, 1 << 24).with_trace_events(True).build()
    cache.insert(1, _strings())
    cache._squeeze_victim(1)
    cache._squeeze_victim(1)
    cache.get(1)
    return cache


def _float_squeeze(pkg, tmp_path):
    cache = pkg.builder(tmp_path, 1 << 24).with_trace_events(True).build()
    rng = np.random.default_rng(6)
    cache.insert(3, pa.array(np.round(rng.uniform(0, 100, 8192), 2)))
    cache._squeeze_victim(3)
    cache._squeeze_victim(3)
    cache.get(3)
    return cache


def _flush_all(pkg, tmp_path):
    cache = pkg.builder(tmp_path, 1 << 24).with_trace_events(True).build()
    cache.insert(1, _ints(seed=1))
    cache.insert(2, _strings(seed=2))
    cache.flush_all_to_disk()
    return cache


def _lru(pkg, tmp_path):
    cache = (pkg.builder(tmp_path, 60_000).with_trace_events(True)
             .with_cache_policy(pkg.pol.LruPolicy()).build())
    for i in range(4):
        cache.insert(i, _ints(seed=i))
    cache.get(0)
    for i in range(4, 8):
        cache.insert(i, _ints(seed=i))
    return cache


SNAPSHOTS = [("insert_transcode", _insert_transcode),
             ("eviction_squeeze_pipeline", _eviction_pipeline),
             ("transcode_evict_policy", _transcode_evict),
             ("string_squeeze", _string_squeeze),
             ("float_squeeze", _float_squeeze),
             ("flush_all", _flush_all),
             ("lru_access_order", _lru)]


@pytest.mark.parametrize("name,script", SNAPSHOTS,
                         ids=[s[0] for s in SNAPSHOTS])
def test_event_trace_equals_the_reference_and_the_snapshot(name, script,
                                                          tmp_path):
    jc, tc = (script(pkg, tmp_path) for pkg in PKGS)
    got = _events_text(tc)
    assert got == _events_text(jc)
    with open(os.path.join(SNAP_DIR, name + ".snap")) as f:
        assert got == f.read()
    js, ts = jc.stats(), tc.stats()
    for k in ("squeezes", "disk_writes", "disk_reads", "hydrations",
              "squeeze_io_reads", "removes", "by_state", "memory_used",
              "disk_used", "entries"):
        assert ts[k] == js[k], k


# -- the reference's cache cases ------------------------------------------------

def _both(tmp_path, mem, **opts):
    out = []
    for pkg in PKGS:
        b = pkg.builder(tmp_path, mem)
        for k, v in opts.items():
            b = getattr(b, k)(v)
        out.append(b.build())
    return out


def _sel_np(mask, n):
    return tmops.unpack_bits_host(words_to_numpy(mask.to_selection()))[:n]


def test_eviction_pipeline_keeps_every_entry_exact(tmp_path):
    jc, tc = _both(tmp_path, 30_000)
    arrays = {i: _ints(8192, seed=i, hi=100_000) for i in range(6)}
    for i, arr in arrays.items():
        assert tc.insert(i, arr) == jc.insert(i, arr)
    assert tc.stats()["squeezes"] == jc.stats()["squeezes"] > 0
    for i, arr in arrays.items():
        out = tc.get(i)
        assert out is not None and out.equals(arr), i
        jc.get(i)
    assert tc.stats() == {**jc.stats(), "dynamic_filter_prunes": 0}


def test_squeezed_predicate_reads_nothing(tmp_path):
    jc, tc = _both(tmp_path, 1 << 30)
    arr = _ints(8192, hi=1 << 20)
    for c in (jc, tc):
        c.insert(1, arr)
        c._squeeze_victim(1)
        assert c.entry_state(1) == tcore.MEMORY_SQUEEZED
    bm = tc.eval_predicate(1, TPred("ne", -5))
    assert _sel_np(bm, 8192).all()
    jc.eval_predicate(1, JPred("ne", -5))
    for k in ("squeeze_io_reads", "squeeze_io_saved",
              "predicate_evals_on_encoded"):
        assert tc.stats()[k] == jc.stats()[k], k
    assert tc.stats()["squeeze_io_reads"] == 0
    assert tc.stats()["squeeze_io_saved"] == 1
    # an undecidable literal reads the backing once
    bm = tc.eval_predicate(1, TPred("gt", 900_000))
    np.testing.assert_array_equal(_sel_np(bm, 8192),
                                  np.asarray(arr) > 900_000)
    assert tc.stats()["squeeze_io_reads"] == 1


def test_date32_component_read_with_no_io(tmp_path):
    import datetime
    days = pa.array(np.arange(19000, 19600).astype("datetime64[D]"))
    jc, tc = _both(tmp_path, 1 << 30)
    for c, hint in ((jc, jcache.ExtractDate32("year")),
                    (tc, ExtractDate32("year"))):
        c.insert(1, days, hint=hint)
        c._squeeze_victim(1)
        assert c.entry_state(1) == tcore.MEMORY_SQUEEZED
    vals, valid = tc.get_component(1, "year")
    jvals, _ = jc.get_component(1, "year")
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))
    want = [(datetime.date(1970, 1, 1) + datetime.timedelta(days=d)).year
            for d in range(19000, 19600)]
    np.testing.assert_array_equal(vals.numpy()[:600], want)
    assert tc.get_component(1, "month") is None
    assert tc.stats()["squeeze_io_saved"] == 1
    assert tc.stats()["squeeze_io_reads"] == 0


def test_flush_all_to_disk_and_read_back(tmp_path):
    jc, tc = _both(tmp_path, 1 << 30)
    arrays = {i: _ints(500, seed=i) for i in range(4)}
    for c in (jc, tc):
        for i, a in arrays.items():
            c.insert(i, a)
        c.flush_all_to_disk()
    for i in range(4):
        assert tc.entry_state(i) == jc.entry_state(i) == tcore.DISK_LIQUID
    assert tc.budget.memory_used == 0
    assert tc.budget.disk_used == jc.budget.disk_used > 0
    for i, a in arrays.items():
        assert tc.get(i).equals(a)
        jc.get(i)
    assert tc.stats() == {**jc.stats(), "dynamic_filter_prunes": 0}


@pytest.mark.parametrize("policy", ["AlwaysHydrate", "NoHydration"])
def test_hydration_follows_the_policy(tmp_path, policy):
    jc, tc = (pkg.builder(tmp_path, 1 << 30).with_hydration_policy(
        getattr(pkg.pol, policy)()).build() for pkg in PKGS)
    arr = _ints(100)
    for c in (jc, tc):
        c.insert(1, arr)
        c.flush_all_to_disk()
        assert c.entry_state(1) == tcore.DISK_LIQUID
        assert c.get(1).equals(arr)
    want = (tcore.MEMORY_LIQUID if policy == "AlwaysHydrate"
            else tcore.DISK_LIQUID)
    assert tc.entry_state(1) == jc.entry_state(1) == want
    assert tc.stats()["hydrations"] == jc.stats()["hydrations"]


def test_disk_budget_removes_disk_victims(tmp_path):
    jc, tc = _both(tmp_path, 10_000, with_max_disk_bytes=100_000)
    for c in (jc, tc):
        for i in range(30):
            c.insert(i, _ints(8192, seed=i, hi=1 << 30))
    assert tc.budget.disk_used <= 100_000
    assert tc.stats()["removes"] > 0
    assert tc.stats() == {**jc.stats(), "dynamic_filter_prunes": 0}
    assert {i: tc.entry_state(i) for i in range(30)} == {
        i: jc.entry_state(i) for i in range(30)}


def test_quantized_integer_squeeze(tmp_path):
    from liquid_tpu_torch.arrays.hybrid import SqueezedQuantizedArray
    jc, tc = _both(tmp_path, 1 << 24,
                   with_integer_squeeze_policy="quantize")
    vals = np.random.default_rng(0).integers(0, 100_000, 8192)
    for c in (jc, tc):
        c.insert(1, pa.array(vals))
        c._squeeze_victim(1)
    assert isinstance(tc._entries[1].payload, SqueezedQuantizedArray)
    for op, lit, np_op in [("gt", 50_000, np.greater),
                           ("lt", 30_000, np.less),
                           ("lt_eq", 99_999, np.less_equal),
                           ("eq", int(vals[5]), np.equal),
                           ("ne", 12_345, np.not_equal)]:
        out = tc.eval_predicate(1, TPred(op, lit))
        np.testing.assert_array_equal(_sel_np(out, 8192), np_op(vals, lit))
        jout = jc.eval_predicate(1, JPred(op, lit))
        np.testing.assert_array_equal(words_to_numpy(out.bits),
                                      np.asarray(jout.bits))
    assert tc.stats()["squeeze_io_reads"] == jc.stats()["squeeze_io_reads"]
    assert tc.get(1).equals(pa.array(vals))


def test_get_with_a_selection(tmp_path):
    _, tc = _both(tmp_path, 1 << 30)
    arr = _ints(100)
    tc.insert(1, arr)
    sel = np.zeros(8192, bool)
    sel[[5, 50]] = True
    out = tc.get(1, selection=tmops.pack_bools(torch.from_numpy(sel)))
    assert out.to_pylist() == [arr[5].as_py(), arr[50].as_py()]


# -- batched reads over mixed states ---------------------------------------------

STATES = ("memory_liquid", "memory_squeezed", "disk_liquid", "memory_arrow",
          "disk_arrow")


def _mixed(pkg, tmp_path):
    """Ten blocks of one column: each state twice (arrow blocks inserted
    with transcode off), the squeezed and disk ones walked down."""
    cache = (pkg.builder(tmp_path, 1 << 30).with_hydration_policy(
        pkg.pol.NoHydration()).build())
    for i in range(10):
        state = STATES[i % 5]
        arr = _ints(8192 - 100 * i, lo=-300, hi=50_000 + 1000 * i, seed=i)
        cache.transcode_on_insert = "arrow" not in state
        cache.insert(i, arr)
        steps = {"memory_squeezed": 1, "disk_liquid": 2,
                 "disk_arrow": 1}.get(state, 0)
        if state == "disk_arrow":
            cache.squeeze_policy = pkg.pol.Evict()
        for _ in range(steps):
            cache._squeeze_victim(i)
        cache.squeeze_policy = pkg.pol.TranscodeSqueezeEvict()
        assert cache.entry_state(i) == state, (i, state)
    return cache


@pytest.mark.parametrize("op,lit", [("gt", 20_000), ("lt_eq", 100),
                                    ("eq", 7), ("ne", -300),
                                    ("lt", 10.5), ("gt_eq", 80_000)])
def test_batched_masks_over_mixed_states(tmp_path, op, lit):
    jc, tc = (_mixed(pkg, tmp_path) for pkg in PKGS)
    ids = list(range(10))
    jm = jc.eval_predicate_many(ids, JPred(op, lit))
    tm = tc.eval_predicate_many(ids, TPred(op, lit))
    for i in ids:
        assert (jm[i] is None) == (tm[i] is None), i
        if tm[i] is not None:
            np.testing.assert_array_equal(words_to_numpy(tm[i].bits),
                                          np.asarray(jm[i].bits))
            np.testing.assert_array_equal(words_to_numpy(tm[i].valid),
                                          np.asarray(jm[i].valid))
    assert [tm[i] is None for i in ids] == [STATES[i % 5].endswith("arrow")
                                          for i in ids]
    for k in ("predicate_evals", "predicate_evals_on_encoded", "disk_reads",
              "squeeze_io_reads", "squeeze_io_saved"):
        assert tc.stats()[k] == jc.stats()[k], k


def test_batched_decode_over_mixed_states(tmp_path):
    jc, tc = (_mixed(pkg, tmp_path) for pkg in PKGS)
    ids = list(range(10)) + [99]
    ja, ta = jc.get_arrow_many(ids), tc.get_arrow_many(ids)
    assert ta[-1] is None and ja[-1] is None
    for i in range(10):
        assert ta[i].equals(ja[i]), i
    for k in ("gets", "cache_hits", "cache_misses", "disk_reads",
              "squeeze_io_reads"):
        assert tc.stats()[k] == jc.stats()[k], k


# -- budget, policies, tracer, hints ----------------------------------------------

def test_disk_budget_accounting():
    b = BudgetAccounting(100, max_disk_bytes=50)
    assert b.try_reserve_disk(30) and not b.try_reserve_disk(30)
    b.release_disk(30)
    assert b.disk_used == 0 and b.try_reserve_disk(50)
    assert b.try_reserve_memory(60)
    assert not b.try_update_memory_usage(60, 120)
    assert b.try_update_memory_usage(60, 90) and b.memory_used == 90
    b.force_update_memory_usage(90, 150)
    assert b.memory_used == 150
    with pytest.raises(RuntimeError, match="underflow"):
        b.release_disk(51)
    assert BudgetAccounting(1).try_reserve_disk(1 << 40)  # unbounded


def test_fifo_and_lru_policies_match_the_reference():
    for name in ("FifoPolicy", "LruPolicy", "LiquidPolicy"):
        j, t = getattr(jpol, name)(), getattr(tpol, name)()
        script = [("ins", 1, "liquid"), ("ins", 2, "arrow"),
                  ("ins", 3, "disk"), ("ins", 4, "squeezed"),
                  ("chg", 1, "squeezed"), ("acc", 2), ("rm", 4),
                  ("mem", 2), ("disk", 5), ("ins", 6, "liquid"),
                  ("mem", 8)]
        got = {}
        for side, p in (("j", j), ("t", t)):
            out = []
            for step in script:
                if step[0] == "ins":
                    p.notify_inserted(step[1], step[2])
                elif step[0] == "chg":
                    p.notify_state_changed(step[1], step[2])
                elif step[0] == "acc":
                    if hasattr(p, "notify_accessed"):
                        p.notify_accessed(step[1])
                elif step[0] == "rm":
                    p.notify_removed(step[1])
                elif step[0] == "mem":
                    out.append(p.find_memory_victims(step[1]))
                else:
                    out.append(p.find_disk_victims(step[1]))
            got[side] = out
        assert got["t"] == got["j"], name


def test_access_trace_flushes_to_parquet(tmp_path):
    _, tc = _both(tmp_path, 1 << 30)
    tc.observer.start_trace()
    tc.insert(1, _ints(100))
    tc.get(1)
    tc.eval_predicate(1, TPred("gt", 5))
    n = tc.observer.flush_trace_parquet(str(tmp_path / "trace.parquet"))
    t = pq.read_table(str(tmp_path / "trace.parquet"))
    assert n == t.num_rows == 3
    assert t.column("op").to_pylist() == ["insert", "get", "eval_predicate"]
    assert t.column("entry_id").to_pylist() == [1, 1, 1]
    assert tc.observer.stop_trace() == []


def test_variant_hints_raise_naming_the_module(tmp_path):
    """A VariantGet hint no longer raises: as in the reference, the JSON
    block stays arrow on insert and a squeeze shreds its requested path
    (tests/test_torch_variant.py covers the variant tier in depth).  The
    name is kept from when the hint raised, so that the test stays
    comparable across the port's history."""
    from liquid_tpu.cache.expressions import VariantGet as JVariantGet
    arr = pa.array(['{"a": 1}', '{"a": 2}', None])
    for c, cls in zip(_both(tmp_path, 1 << 30), (JVariantGet, VariantGet)):
        hint = cls((("a", "int64"),))
        assert c.insert(1, arr, hint=hint)
        assert c.entry_state(1) == "memory_arrow"
        c._squeeze_victim(1)
        assert c.entry_state(1) == "memory_squeezed"
        assert c.get_variant_paths(1, hint.requests).field(0).to_pylist() \
            == [1, 2, None]
        assert c.get(1).equals(arr)


def test_reset_and_remove_file_release_memory_and_disk(tmp_path):
    _, tc = _both(tmp_path, 1 << 30)
    for i in range(3):
        tc.insert((7 << 48) | i, _ints(seed=i))
    tc.insert(1, _ints(seed=9))
    tc.flush_all_to_disk()
    used = tc.budget.disk_used
    tc.remove_file(7)
    assert 0 < tc.budget.disk_used < used and tc.stats()["entries"] == 1
    tc.reset()
    assert tc.budget.disk_used == tc.budget.memory_used == 0
    assert tc.get(1) is None
