"""JSONBench-like events and queries (port's copy of the generator in
`benchmark/json_bench/generate.py`).

`generate(rows)` makes the bluesky-like events of that generator, draw
for draw (numpy Generator, seed 8): one JSON string column `event` with
`kind`, `did`, `time_us` and, for commits, `commit.operation` and
`commit.collection`.  `QUERIES` are its five `variant_get` queries;
`answers(table)` computes them independently of the engine, parsing
each event with `json` and counting with `collections.Counter`, as the
queries' result columns.
"""
from __future__ import annotations

import json
from collections import Counter
from typing import List

import numpy as np
import pyarrow as pa

KINDS = ["commit", "identity", "account"]
OPS = ["create", "update", "delete"]
COLLECTIONS = ["app.bsky.feed.post", "app.bsky.feed.like",
               "app.bsky.graph.follow", "app.bsky.actor.profile"]

QUERIES = [
    "select variant_get(event, 'kind', 'utf8') as kind, count(*) as c "
    "from events group by kind order by c desc",
    "select variant_get(event, 'commit.collection', 'utf8') as coll, "
    "count(*) as c from events "
    "where variant_get(event, 'kind', 'utf8') = 'commit' "
    "group by coll order by c desc",
    "select count(distinct variant_get(event, 'did', 'utf8')) as dids "
    "from events",
    "select variant_get(event, 'commit.operation', 'utf8') as op, "
    "count(*) as c from events "
    "where variant_get(event, 'commit.collection', 'utf8') = "
    "'app.bsky.feed.post' group by op order by op",
    "select min(variant_get(event, 'time_us', 'int64')) as lo, "
    "max(variant_get(event, 'time_us', 'int64')) as hi from events",
]

#: the paths the queries read, as (path, type) requests
PATHS = (("commit.collection", "utf8"), ("commit.operation", "utf8"),
         ("did", "utf8"), ("kind", "utf8"), ("time_us", "int64"))


def generate(rows: int, seed: int = 8) -> pa.Table:
    """`rows` events as the JSONBench generator draws them."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(rows):
        doc = {"kind": KINDS[int(rng.integers(0, 3))],
               "did": f"did:plc:{rng.integers(0, 5000):08x}",
               "time_us": int(1_700_000_000_000_000 + i * 1000)}
        if doc["kind"] == "commit":
            doc["commit"] = {"operation": OPS[int(rng.integers(0, 3))],
                             "collection": COLLECTIONS[int(
                                 rng.integers(0, 4))]}
        out.append(json.dumps(doc, separators=(",", ":")))
    return pa.table({"event": pa.array(out, pa.string())})


def _by_count(counter: Counter) -> List[tuple]:
    """(key, count) rows by count descending, ties by key (the queries
    leave the order of tied rows open: compare those as a multiset)."""
    return sorted(counter.items(), key=lambda kv: (-kv[1], str(kv[0])))


def answers(table: pa.Table) -> List[List[tuple]]:
    """Each query's rows, computed from the parsed events."""
    docs = [json.loads(s) for s in table.column("event").to_pylist()]
    commits = [d for d in docs if d.get("kind") == "commit"]
    posts = [d["commit"] for d in commits
             if d["commit"]["collection"] == "app.bsky.feed.post"]
    times = [d["time_us"] for d in docs]
    return [
        _by_count(Counter(d["kind"] for d in docs)),
        _by_count(Counter(d["commit"]["collection"] for d in commits)),
        [(len({d["did"] for d in docs}),)],
        sorted(Counter(c["operation"] for c in posts).items()),
        [(min(times), max(times))],
    ]


def same_rows(out: pa.Table, want: List[tuple], ordered_by_count: bool
              ) -> bool:
    """The engine's rows equal the oracle's; where the query orders by a
    count, rows tied on it compare as a multiset."""
    got = [tuple(r.values()) for r in out.to_pylist()]
    if not ordered_by_count:
        return got == want
    return (sorted(got, key=lambda kv: (-kv[1], str(kv[0]))) == want
            and [r[1] for r in got] == [r[1] for r in want])
