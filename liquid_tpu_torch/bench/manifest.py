"""Benchmark manifests (host copy of `liquid_tpu/bench/manifest.py`).

Reference behavior: `benchmark/src/manifest.rs`: a JSON file `{name,
tables {name -> path}, queries [...], object_stores [...], answers}`
where a query is inline SQL, a `.sql` file's path, or a list of them run
as one statement list; relative paths resolve against the manifest's
directory.  It drives the server-mode clients (`bench/clients.py`) and
the in-process runner (`bench/runner.py`).
"""
from __future__ import annotations

import glob
import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class Manifest:
    name: str
    tables: Dict[str, str] = field(default_factory=dict)
    queries: List[object] = field(default_factory=list)  # str | [str, ...]
    object_stores: List[dict] = field(default_factory=list)
    answers: Optional[str] = None  # directory of stored answer parquet files

    @classmethod
    def load(cls, path: str) -> "Manifest":
        with open(path) as f:
            raw = json.load(f)
        base = os.path.dirname(os.path.abspath(path))

        def resolve(p: str) -> str:
            return p if os.path.isabs(p) else os.path.join(base, p)

        tables = {k: resolve(v) for k, v in raw.get("tables", {}).items()}
        queries: List[object] = []
        for q in raw.get("queries", []):
            if isinstance(q, list):
                queries.append([cls._load_query(s, resolve) for s in q])
            else:
                queries.append(cls._load_query(q, resolve))
        ans = raw.get("answers")
        return cls(name=raw["name"], tables=tables, queries=queries,
                   object_stores=raw.get("object_stores", []),
                   answers=resolve(ans) if ans else None)

    @staticmethod
    def _load_query(q: str, resolve) -> str:
        if q.endswith(".sql"):
            with open(resolve(q)) as f:
                return f.read().strip().rstrip(";")
        if q.endswith("/*.sql"):
            raise ValueError("glob queries: use query_glob")
        return q

    @classmethod
    def from_query_dir(cls, name: str, tables: Dict[str, str],
                       query_glob: str) -> "Manifest":
        files = sorted(glob.glob(query_glob),
                       key=lambda p: _natural_key(os.path.basename(p)))
        queries = [open(f).read().strip().rstrip(";") for f in files]
        return cls(name=name, tables=tables, queries=queries)


def _natural_key(s: str):
    import re
    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", s)]
