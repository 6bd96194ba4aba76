"""Deterministic StackOverflow-shaped dataset and the DBA query suite
(port of `liquid_tpu/bench/stackoverflow_data.py`; its own copy).

Users, posts, comments, votes and badges, with the string-heavy columns
(titles, tags, display names) of the real dump, and the eight DBA-style
queries (`QUERIES`, reference `:113-150`: LIKE filters, joins, NOT
EXISTS, UNION ALL, grouped counts) that the reference's CI runs at a 10 MB
memory cap to force the squeeze and eviction paths.  `generate` makes the
reference's tables value for value from the same seed; the pyarrow
oracles of the eight queries are `bench/oracle.SO_ORACLES`.

    python -m liquid_tpu_torch.bench.stackoverflow_data [--users N]
        [--posts N] [--answers] [--cpu]

writes `benchmark/stackoverflow/data/*.parquet` and
`manifest.dba.json` (with `--answers`, each query's answer from one run
on the card, or the CPU with `--cpu`, under `answers/`).
"""
from __future__ import annotations

import os
import sys
from typing import Dict, List, Optional

import numpy as np
import pyarrow as pa

from liquid_tpu_torch.bench.tpch_data import write_parquet

TAGS = ["sql-server", "postgresql", "mysql", "oracle", "performance",
        "index", "backup", "replication", "query-optimization", "t-sql",
        "security", "json", "partitioning", "deadlock", "linux"]
TITLE_WORDS = ["how", "to", "why", "does", "slow", "query", "index",
               "join", "deadlock", "backup", "restore", "log", "shrink",
               "performance", "optimize", "migrate", "replica", "vacuum",
               "lock", "timeout", "connection", "pool", "plan", "statistics"]
BADGES = ["Student", "Teacher", "Editor", "Supporter", "Commentator",
          "Nice Answer", "Good Answer", "Great Answer", "Populist",
          "Necromancer", "Fanatic"]


def generate(n_users: int = 2000, n_posts: int = 20_000,
             seed: int = 2008) -> Dict[str, pa.Table]:
    rng = np.random.default_rng(seed)

    rep = np.maximum(1, (rng.pareto(1.2, n_users) * 100).astype(np.int64))
    users = pa.table({
        "u_id": pa.array(np.arange(1, n_users + 1), pa.int64()),
        "u_display_name": pa.array([f"user_{i % 1500}"
                                    for i in range(n_users)]),
        "u_reputation": pa.array(rep),
        "u_up_votes": pa.array(rng.integers(0, 5000, n_users), pa.int64()),
        "u_down_votes": pa.array(rng.integers(0, 500, n_users), pa.int64()),
        "u_location": pa.array(rng.choice(
            ["", "Germany", "USA", "India", "UK", "France", "Remote"],
            n_users)),
    })

    kind = np.where(rng.random(n_posts) < 0.45, 1, 2)  # 1=question 2=answer
    q_ids = np.flatnonzero(kind == 1) + 1
    parent = np.where(kind == 2,
                      rng.choice(q_ids if len(q_ids) else [1], n_posts), 0)
    titles = np.where(
        kind == 1,
        [" ".join(rng.choice(TITLE_WORDS, rng.integers(4, 9)))
         for _ in range(n_posts)], "")
    tags = np.where(
        kind == 1,
        ["|".join(sorted(set(rng.choice(TAGS, rng.integers(1, 5)))))
         for _ in range(n_posts)], "")
    created = (np.datetime64("2009-01-01")
               + rng.integers(0, 5000, n_posts).astype("timedelta64[D]"))
    posts = pa.table({
        "p_id": pa.array(np.arange(1, n_posts + 1), pa.int64()),
        "p_post_type": pa.array(kind.astype(np.int64)),
        "p_parent_id": pa.array(parent.astype(np.int64)),
        "p_owner_user_id": pa.array(
            rng.integers(1, n_users + 1, n_posts), pa.int64()),
        "p_score": pa.array(
            (rng.pareto(1.5, n_posts) * 3 - 1).astype(np.int64)),
        "p_view_count": pa.array(
            (rng.pareto(1.1, n_posts) * 100).astype(np.int64)),
        "p_answer_count": pa.array(np.where(
            kind == 1, rng.integers(0, 12, n_posts), 0).astype(np.int64)),
        "p_title": pa.array(titles.tolist(), pa.string()),
        "p_tags": pa.array(tags.tolist(), pa.string()),
        "p_creation_date": pa.array(
            created.astype("datetime64[D]").astype(object)),
    })

    n_comments = n_posts * 2
    comments = pa.table({
        "c_id": pa.array(np.arange(1, n_comments + 1), pa.int64()),
        "c_post_id": pa.array(
            rng.integers(1, n_posts + 1, n_comments), pa.int64()),
        "c_user_id": pa.array(
            rng.integers(1, n_users + 1, n_comments), pa.int64()),
        "c_score": pa.array(rng.integers(0, 30, n_comments), pa.int64()),
        "c_text": pa.array([" ".join(rng.choice(TITLE_WORDS, 6))
                            for _ in range(n_comments)]),
    })

    n_votes = n_posts * 4
    votes = pa.table({
        "v_id": pa.array(np.arange(1, n_votes + 1), pa.int64()),
        "v_post_id": pa.array(
            rng.integers(1, n_posts + 1, n_votes), pa.int64()),
        "v_vote_type": pa.array(
            rng.choice([2, 2, 2, 3, 5], n_votes).astype(np.int64)),
    })

    n_badges = n_users * 3
    badges = pa.table({
        "b_id": pa.array(np.arange(1, n_badges + 1), pa.int64()),
        "b_user_id": pa.array(
            rng.integers(1, n_users + 1, n_badges), pa.int64()),
        "b_name": pa.array(rng.choice(BADGES, n_badges)),
    })

    return {"users": users, "posts": posts, "comments": comments,
            "votes": votes, "badges": badges}


#: DBA-style query set (string-heavy LIKEs, joins, unions; run at a tight
#: memory cap like the reference CI's 10MB StackOverflow-DBA job)
QUERIES = [
    # top answerers by accepted-ish score
    """select u_display_name, count(*) as answers, sum(p_score) as score
from posts, users
where p_owner_user_id = u_id and p_post_type = 2
group by u_display_name
order by score desc, u_display_name limit 20""",
    # tag LIKE filter (substring fingerprint path)
    """select count(*) as c from posts
where p_tags like '%postgresql%' and p_score > 2""",
    # questions without answers
    """select count(*) as c from posts p
where p.p_post_type = 1 and not exists (
    select * from posts a where a.p_parent_id = p.p_id)""",
    # union of high-score questions and answers
    """select p_id, p_score from posts where p_post_type = 1 and p_score > 20
union all
select p_id, p_score from posts where p_post_type = 2 and p_score > 20
order by p_score desc, p_id limit 50""",
    # comment activity per user bucket
    """select u_reputation / 1000 as rep_k, count(*) as comments
from comments, users
where c_user_id = u_id
group by rep_k order by rep_k""",
    # vote distribution
    """select v_vote_type, count(*) as c from votes
group by v_vote_type order by v_vote_type""",
    # badge leaders among high-rep users
    """select b_name, count(*) as c
from badges, users
where b_user_id = u_id and u_reputation > 1000
group by b_name order by c desc, b_name limit 10""",
    # title keyword search
    """select count(*) as c from posts
where p_title like '%deadlock%' or p_title like '%timeout%'""",
]


#: where `main` writes the benchmark by default
BENCH_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                         "..", "benchmark", "stackoverflow")


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    import json
    from liquid_tpu_torch.bench.manifest import Manifest
    p = argparse.ArgumentParser(description="Write the StackOverflow-DBA "
                                "benchmark: data, manifest, answers.")
    p.add_argument("--users", type=int, default=2000)
    p.add_argument("--posts", type=int, default=20_000)
    p.add_argument("--answers", action="store_true",
                   help="also write each query's answer from one run")
    p.add_argument("--cpu", action="store_true",
                   help="compute the answers on the CPU")
    p.add_argument("--out", default=BENCH_DIR)
    args = p.parse_args(argv)
    base = os.path.abspath(args.out)
    paths = write_parquet(generate(args.users, args.posts),
                          os.path.join(base, "data"))
    manifest = {
        "name": "StackOverflow-DBA",
        "tables": {k: os.path.relpath(v, base) for k, v in paths.items()},
        "queries": QUERIES,
    }
    if args.answers:
        manifest["answers"] = "answers"
    mp = os.path.join(base, "manifest.dba.json")
    with open(mp, "w") as f:
        json.dump(manifest, f, indent=1)
    loaded = Manifest.load(mp)
    print(f"wrote {mp}: {len(loaded.tables)} tables, "
          f"{len(loaded.queries)} queries")
    if args.answers:
        from liquid_tpu_torch.bench.runner import save_answers
        save_answers(loaded, os.path.join(base, "answers"),
                     cache_dir=os.path.join(base, "cache"),
                     device="cpu" if args.cpu else None)
        print(f"wrote {os.path.join(base, 'answers')}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
