"""The fused routes' per-table state (`sql/fused_agg.TableState`) and its
plan cache (`PlanCache`) on the CPU:
- the fused plans leave oldest first, a hit or not, and the star plans
  least recently used first;
- a row-group slice's and an aliased relation's state hold their base's
  very objects for the memos each shares, and their own for the rest,
  so a plan made over a wrapper never answers for its base.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402
import pyarrow as pa  # noqa: E402
import pyarrow.parquet as pq  # noqa: E402

from liquid_tpu_torch.server.flight import _RowGroupSlice  # noqa: E402
from liquid_tpu_torch.sql import fused_agg as tfa  # noqa: E402
from liquid_tpu_torch.sql import fused_star as tstar  # noqa: E402
from liquid_tpu_torch.sql.exec import QueryExecutor  # noqa: E402
from liquid_tpu_torch.sql.session import LiquidCacheLocalBuilder  # noqa: E402


@pytest.mark.parametrize("cap,lru,make", [
    (8, False, lambda: tfa.TableState(None).plans),
    (256, True, lambda: QueryExecutor({}, "cpu").star_plans),
], ids=["fused_fifo_8", "star_lru_256"])
def test_plan_cache_retention(cap, lru, make):
    """Full, one hit on the oldest plan, then one more plan: FIFO drops
    the plan it hit, LRU keeps it and drops the next oldest."""
    cache = make()
    assert (cache.cap, cache.lru) == (cap, lru)
    for k in range(cap):
        cache.put(k, f"plan {k}")
    assert cache.lookup(0) == "plan 0" and cache.lookup(cap) is None
    cache.put(cap, f"plan {cap}")
    assert len(cache) == cap and cap in cache
    assert (0 in cache) == lru and (1 in cache) != lru
    assert list(cache)[-2:] == ([0, cap] if lru else [cap - 1, cap])


#: each memo of a table's state: shared with its base by a row-group
#: slice, by an aliased relation
SIDES = {"preps": (True, True), "rowvalid": (True, True),
         "dim_builds": (True, True), "exist_builds": (True, False),
         "plans": (False, False), "distinct_plans": (False, False),
         "stage_hints": (False, False)}


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("state") / "t.parquet")
    n = 3 * 8192
    pq.write_table(pa.table({"k": pa.array(np.arange(n) % 97),
                             "v": pa.array(np.arange(n, dtype=np.float64))}),
                   path, row_group_size=8192)
    ctx, _ = (LiquidCacheLocalBuilder(device="cpu")
              .with_max_memory_bytes(1 << 28).build())
    ctx.register_parquet("t", path)
    return ctx._tables["t"]


@pytest.mark.parametrize("side,wrap", [
    (0, lambda t: _RowGroupSlice(t, [1])),
    (1, lambda t: tstar._AliasedTable(t, "a__")),
], ids=["slice", "alias"])
def test_wrapper_state_shares_exactly_its_block_keyed_memos(base, side,
                                                            wrap):
    its = tfa.table_state(base)
    w = wrap(base)
    mine = tfa.table_state(w)
    assert set(vars(mine)) - {"cache"} == set(SIDES)
    for memo, shares in SIDES.items():
        assert (getattr(mine, memo) is getattr(its, memo)) == shares[side], \
            memo
    mine.plans.put("k", "a plan over the wrapper")
    assert its.plans.lookup("k") is None
    # a prep made through the wrapper is the base's, under its column name
    blocks = ((1, 0),)
    prep = tfa._table_prep(w, "a__k" if side else "k", None, blocks)
    assert its.preps["k"][blocks][1] is prep
    assert tfa._rowvalid(w, blocks) is tfa._rowvalid(base, blocks)
