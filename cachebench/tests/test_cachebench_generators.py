"""The generators' shapes: the identifier columns of `hits` in the
published table's proportions, the same on every seed."""
import numpy as np
import pyarrow.compute as pc
import pytest

from cachebench.generators import hits
from cachebench.tests.conftest import SEED, tiny_config


def _distinct(t, col):
    return pc.count_distinct(t[col]).as_py()


@pytest.mark.parametrize("seed", [SEED, 7, 2 ** 33 + 1])
def test_hits_keys_follow_the_published_proportions(seed):
    # 250,000 rows: enough that every sample user's share is a clone or
    # more (the tests' usual 20,000 give each sample user one at least)
    cfg = {**tiny_config("clickbench_4m"), "rows": 250_000}
    t = hits.generate(cfg, seed)
    rows = cfg["rows"]
    assert t.num_rows == rows
    assert _distinct(t, "WatchID") == rows
    w = t["WatchID"].to_numpy()
    assert w.min() >= 1 << 62
    users = hits.distinct_share(rows, cfg, "UserID")
    assert _distinct(t, "UserID") == users
    assert _distinct(t, "ClientIP") == users
    assert _distinct(t, "SearchPhrase") == hits.distinct_share(
        rows, cfg, "SearchPhrase")
    # ids stay signed as the sample's are; users differ in their hits
    assert (t["UserID"].to_numpy() < 0).any()
    _, per_user = np.unique(t["UserID"].to_numpy(), return_counts=True)
    assert per_user.max() > 5 * np.median(per_user)


def test_every_seed_draws_the_same_ids():
    cfg = {**tiny_config("clickbench_4m"), "rows": 250_000}
    a, b = hits.generate(cfg, 11), hits.generate(cfg, 2 ** 40 + 3)
    for col in ("WatchID", "UserID", "ClientIP"):
        assert set(a[col].to_numpy()) == set(b[col].to_numpy()), col
    assert not (a["UserID"].to_numpy() == b["UserID"].to_numpy()).all()


def test_small_hits_keep_every_sample_user():
    cfg = tiny_config("clickbench_4m")
    t = hits.generate(cfg, SEED)
    assert _distinct(t, "UserID") >= hits.distinct_share(
        cfg["rows"], cfg, "UserID")
    assert _distinct(t, "WatchID") == cfg["rows"]


def test_mix_is_a_bijection():
    x = np.arange(1 << 16, dtype=np.uint64) * np.uint64(65_537)
    for mask in (hits.M32, hits.M62):
        assert len(np.unique(hits.mix(x, mask))) == len(x)
        assert (hits.mix(x, mask) <= mask).all()
