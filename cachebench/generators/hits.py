"""Seeded ClickBench `hits` rows (a copy of
`liquid_tpu_torch/bench/hits.py::prepare_hits` that takes the seed, keeps
only the configuration's columns, builds the string suffixes with pyarrow,
not row by row, and re-keys the identifier columns).

Rows are the vendored 24,586-row `nano_hits.parquet` sample, each row
repeated as often as the row count allows, in an order of the seed's.
What the sample fixes by its size is made anew, in the published table's
proportions to the rows:

- WatchID, a hit's id, is unique per row, in the sample's range
  [2^62, 2^63);
- UserID has `published_distinct["UserID"] / published_rows` distinct
  values per row.  Each of the sample's users is split into clones that
  keep its rows (its phrases, URLs, regions, models): a clone's id is the
  sample user's high 32 bits, so ids stay signed as the published ones
  are, with low 32 bits unique to the clone.  Every clone has a hit; the rest of
  a sample user's hits fall to its clones skewed towards the first;
- ClientIP is one address per user, as in the sample (1,916 addresses for
  1,885 users);
- a non-empty SearchPhrase is one of `published_distinct["SearchPhrase"]
  / published_rows` distinct phrases per row: each phrase is the sample
  phrase of the row that first draws it with its number appended, and
  every phrase has a row; the rest of the non-empty rows draw phrases
  skewed towards the first;
- URL gets a zipf-skewed suffix, so that distinct URLs scale with the
  rows (about a fifth of them), and RegionID is zipf-skewed over the
  published ~9k values.

Every seed draws the same WatchIDs, UserIDs and ClientIPs (their ids are
fixed bijections of the row and user numbers) and the same number of
distinct phrases; the seed decides which rows they fall on.  The engine's
grouping routes depend on the key values, so a seed that drew its own ids
would change the work and not only its order.
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pyarrow.parquet as pq

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

M32 = np.uint64(0xFFFFFFFF)
M62 = np.uint64((1 << 62) - 1)
#: the offsets of WatchID, UserID and ClientIP ahead of their bijections
OFFSETS = (np.uint64(0x1D8E4E27C47D124F), np.uint64(0x2545F491),
           np.uint64(0x4F6CDD1D))


def mix(x: np.ndarray, mask: np.uint64) -> np.ndarray:
    """A bijection of the integers under `mask` (all ones below some bit):
    xor-shifts and odd multipliers, each invertible modulo a power of
    two, so distinct inputs give distinct outputs."""
    x = x.astype(np.uint64) & mask
    with np.errstate(over="ignore"):
        for shift, mult in ((29, 0xBF58476D1CE4E5B9),
                            (27, 0x94D049BB133111EB), (31, 0x2545F4914F6CDD1D)):
            x ^= x >> np.uint64(shift)
            x = (x * np.uint64(mult)) & mask
    return x


def distinct_share(rows: int, config: dict, column: str) -> int:
    """The distinct values of `column` in `rows` rows, in the published
    table's proportion."""
    return max(1, round(rows * config["published_distinct"][column]
                        / config["published_rows"]))


def skewed(rng, n: int, d: np.ndarray, power: float) -> np.ndarray:
    """n draws in [0, d), skewed towards 0 (`d` per draw)."""
    return np.minimum(np.floor(d * rng.random(n) ** power).astype(np.int64),
                      d - 1)


def users(rng, template: np.ndarray, d: int) -> np.ndarray:
    """Split each sample user (`template`, one per row) into clones, `d`
    in all (more where a sample user has fewer rows than its share): the
    clone, numbered across sample users, of each row."""
    rows = len(template)
    t_n = int(template.max()) + 1
    r = np.bincount(template, minlength=t_n)
    share = r * (d / rows)
    m = np.where(r > 0, np.maximum(1, np.floor(share)), 0).astype(np.int64)
    short = d - int(m.sum())
    if short > 0:
        frac = np.where(m < r, share - m, -1.0)
        m[np.argsort(-frac, kind="stable")[:short]] += 1
    # each sample user's rows in a random order: the first m of them give
    # every clone a hit, the rest fall to clones skewed towards the first
    order = rng.permutation(rows)
    order = order[np.argsort(template[order], kind="stable")]
    t_sorted = template[order]
    pos = np.arange(rows) - (np.cumsum(r) - r)[t_sorted]
    mt = m[t_sorted]
    c_sorted = np.where(pos < mt, pos, skewed(rng, rows, mt, 2.0))
    clone = np.empty(rows, np.int64)
    clone[order] = c_sorted
    return (np.cumsum(m) - m)[template] + clone


def phrases(rng, phr: pa.Array, d: int) -> pa.Array:
    """Non-empty phrases re-drawn over `d` distinct ones; empty stay."""
    nonempty = np.flatnonzero(
        pc.not_equal(phr, "").to_numpy(zero_copy_only=False))
    if len(nonempty) == 0:
        return phr
    d = max(1, min(d, len(nonempty)))
    order = rng.permutation(nonempty)
    ids = np.empty(len(order), np.int64)
    ids[:d] = np.arange(d)
    ids[d:] = skewed(rng, len(order) - d, np.full(len(order) - d, d), 3.0)
    text = pc.binary_join_element_wise(
        phr.take(pa.array(order[:d])), pa.array(np.arange(d)).cast(
            pa.string()), " ")
    # empty rows keep their own value, the others take their phrase
    idx = np.arange(len(phr))
    idx[order] = ids + len(phr)
    return pa.concat_arrays([phr, text]).take(pa.array(idx))


def generate(config: dict, seed: int) -> pa.Table:
    rows = config["rows"]
    src = pq.read_table(os.path.join(HERE, config["sample"]),
                        columns=config["columns"])
    rng = np.random.default_rng(seed % (1 << 64))
    # each sample row rows / 24,586 times (the first rows % 24,586 once
    # more), in an order of the seed's
    pick = rng.permutation(np.resize(np.arange(src.num_rows), rows))
    big = src.take(pa.array(pick))
    cols = {n: big.column(n).combine_chunks() for n in big.column_names}

    # WatchID: unique per row, in [2^62, 2^63)
    cols["WatchID"] = pa.array((mix(np.arange(rows, dtype=np.uint64)
                                    + OFFSETS[0], M62)
                                | np.uint64(1 << 62)).view(np.int64))

    # UserID, ClientIP: the sample's users split into clones
    sample_uid = src.column("UserID").to_numpy()
    _, template = np.unique(sample_uid, return_inverse=True)
    row_t = template[pick]
    user = users(rng, row_t, distinct_share(rows, config, "UserID"))
    high = sample_uid[pick].view(np.uint64) & ~M32
    cols["UserID"] = pa.array(
        (high | mix(user.astype(np.uint64) + OFFSETS[1], M32))
        .view(np.int64))
    cols["ClientIP"] = pa.array(
        mix(user.astype(np.uint64) + OFFSETS[2], M32)
        .astype(np.uint32).view(np.int32))

    # URL: a skewed suffix id, so that distinct URLs scale with the rows
    n_url = max(rows // 5, 1)
    sfx = rng.zipf(config["url_zipf"], rows) % n_url
    cols["URL"] = pc.binary_join_element_wise(
        cols["URL"].cast(pa.string()), "?sid=",
        pa.array(sfx).cast(pa.string()), "")
    # the published count has the empty phrase among its values
    cols["SearchPhrase"] = phrases(
        rng, cols["SearchPhrase"].cast(pa.string()),
        distinct_share(rows, config, "SearchPhrase") - 1)

    # RegionID: zipf-skewed over the published ~9k cardinality
    n_reg = min(config["region_values"], max(64, rows // 450))
    cols["RegionID"] = pa.array(
        (rng.zipf(config["region_zipf"], rows) % n_reg).astype(np.int32))
    return pa.table(cols)


def write(config: dict, seed: int, out_dir: str) -> Dict[str, str]:
    """The `hits` table as `out_dir/hits.parquet` -> {"hits": path}."""
    path = os.path.join(out_dir, "hits.parquet")
    pq.write_table(generate(config, seed), path,
                   row_group_size=config["row_group_rows"])
    return {"hits": path}
