"""The port's micro-benchmark registry (`bench/micro.py`) against the JAX
package's, on the CPU.

- The same 14 names as `liquid_tpu.bench.micro.REGISTRY`, and each
  result carries the reference's result keys.
- `run_all(tiny=True, device="cpu")` and the reference test's sanity
  checks (`tests/test_micro_bench.py`): finite values >= 0, FSST and the
  primitive encoding compress, the eviction benchmark squeezes or writes
  to disk, the prefix studies report fractions.
- The results that measure no time (ratios, rates, fractions, counts)
  equal the reference's, value for value.
- `eviction`'s `disk_evictions` is the cache's disk writes; the
  reference reads a counter its cache never has and reports 0
  (`ROADMAP.md` Queue 3).
- `filter_pushdown` launches K1 once per width bucket and evaluation,
  counted by wrapping `bitpack_cuda.cmp_const_many`.
- The command line: `--cpu` runs on the CPU; without it the card is
  asked for, and there is none here.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import math  # noqa: E402
import tempfile  # noqa: E402

import numpy as np  # noqa: E402
import pyarrow as pa  # noqa: E402

from liquid_tpu.bench import micro as jmicro  # noqa: E402
from liquid_tpu.cache.core import LiquidCacheBuilder as JCacheBuilder  # noqa: E402
from liquid_tpu_torch.bench import micro  # noqa: E402
from liquid_tpu_torch.ops import bitpack as bp  # noqa: E402
from liquid_tpu_torch.ops import bitpack_cuda  # noqa: E402

CPU = torch.device("cpu")

#: per benchmark, the result keys that measure no time
EXACT_KEYS = {
    "primitive_encoding": ("ratio",),
    "linear_integer": ("ratio",),
    "fsst_view": ("ratio",),
    "string_fingerprint": ("candidate_rate",),
    "squeeze_date32": ("squeezed_ratio",),
    "eviction": ("squeezes",),
    "filter_selectivity_ambiguity": ("value", "per_point"),
    "prefix_differentiability": ("value", "dict_size"),
    "bitpacking": ("rows", "width"),
}


@pytest.fixture(scope="module")
def results():
    return {r["name"]: r for r in micro.run_all(tiny=True, device="cpu")}


def test_registry_matches_reference():
    assert list(micro.REGISTRY) == list(jmicro.REGISTRY)
    assert len(micro.REGISTRY) == 14


def test_all_benches_run_tiny(results):
    assert len(results) == 14
    for r in results.values():
        assert {"name", "value", "unit"} <= set(r), r
        assert math.isfinite(r["value"]), r
        assert r["value"] >= 0, r


@pytest.mark.parametrize("name", sorted(EXACT_KEYS))
def test_untimed_results_equal_reference(results, name):
    want = jmicro.REGISTRY[name](True)
    got = results[name]
    assert set(want) <= set(got), (set(want), set(got))
    for k in EXACT_KEYS[name]:
        assert got[k] == want[k], (k, got[k], want[k])
    assert got["unit"] == want["unit"]


def test_compression_benches_actually_compress(results):
    assert results["fsst_view"]["ratio"] < 1.0
    assert results["primitive_encoding"]["ratio"] < 1.0


def test_eviction_counts_disk_writes(results):
    """The port's `disk_evictions` is the reference cache's disk writes
    for the same inserts; the reference's benchmark reports 0."""
    r = results["eviction"]
    assert r["squeezes"] + r["disk_evictions"] > 0
    arr = pa.array(np.random.default_rng(0).integers(0, 1 << 20, 8192),
                   pa.int64())
    with tempfile.TemporaryDirectory() as d:
        cache = (JCacheBuilder().with_max_memory_bytes(96 * 1024)
                 .with_disk_path(d + "/store.bin").build())
        for i in range(16):
            cache.insert(i, arr)
        writes = cache.stats()["disk_writes"]
    assert writes > 0
    assert r["disk_evictions"] == writes
    assert jmicro.REGISTRY["eviction"](True)["disk_evictions"] == 0


def test_prefix_studies_report_fractions(results):
    amb = results["filter_selectivity_ambiguity"]
    assert 0.0 <= amb["value"] <= 1.0
    diff = results["prefix_differentiability"]
    assert 0.5 < diff["value"] <= 1.0


def test_bitpacking_unpack_is_exact():
    planes = micro.bitpacking_input(True, CPU)
    vals = np.random.default_rng(0).integers(
        0, 1 << micro.BITPACK_WIDTH, 1 << 13, dtype=np.uint32)
    assert np.array_equal(bp.unpack_bitplanes(planes).numpy(),
                          vals.astype(np.int64))


def test_filter_pushdown_launches_one_k1_per_bucket(monkeypatch):
    calls = []
    real = bitpack_cuda.cmp_const_many

    def counted(planes, cs):
        calls.append(tuple(planes.shape))
        return real(planes, cs)
    monkeypatch.setattr(bitpack_cuda, "cmp_const_many", counted)
    r = micro.REGISTRY["filter_pushdown"](True, CPU)
    # one width bucket: one launch per evaluation over all four blocks
    assert len(calls) == r["evals"] == 3
    assert {c[0] for c in calls} == {micro.FILTER_BLOCKS[True]}


def test_main_cpu_and_unknown_names(capsys):
    assert micro.main(["--tiny", "--cpu", "boolean_and_then"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1 and '"boolean_and_then"' in out[0]
    assert micro.main(["--cpu", "no_such_bench"]) == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            micro.main(["--tiny", "boolean_and_then"])
