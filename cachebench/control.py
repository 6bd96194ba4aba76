"""The control of the check that decides `correct`: the plain reference put
in the program's place, one precision below the configuration's (every
float64 column read as float32, every float answer rounded to float32).
Its answers must come out wrong, or the check could not tell.

    python3 -m cachebench.control --workload tpch_sf1.fused \
        --seeds 11 12 13

prints one JSON line per seed: the numbers a run compares
(`wrong_answers`, `float_rel_gap`) for the control's answer to each query
of the cell, at the cell's own size.  It needs no card.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict

import pyarrow as pa

from cachebench import data, harness, spec
from cachebench.reference.common import Tables


def lower(cols) -> pa.Table:
    """An answer's columns as a table, floats rounded to float32."""
    return pa.table({f"c{i}": c.cast(pa.float32())
                     if pa.types.is_floating(c.type) else c
                     for i, c in enumerate(cols)})


class Control:
    """A program for `harness.run_cell` that answers by the reference in
    float32."""

    def __init__(self, config_name: str, torch, device, workload,
                 paths: Dict[str, str], sqls):
        self.config_name = config_name
        self.db = Tables(paths, pa.float32())

    def transcode(self, columns) -> None:
        pass

    def answer(self, query: str) -> pa.Table:
        mod = spec.reference(self.config_name, query)
        out = lower(mod.answer(self.db))
        cut = getattr(mod, "CUT", None)
        # a LIMIT's rows, as the query itself returns them
        return out.slice(cut[1], cut[2]) if cut else out

    def close(self) -> None:
        pass


def readings(cell_name: str, seed: int, config=None,
             data_root: str = data.DATA_DIR) -> dict:
    """The control's numbers on one seed: each query's answer judged as a
    run judges the program's."""
    config = config or spec.config(spec.cell(cell_name)["config"])
    queries = spec.workload(cell_name)["queries"]
    paths = data.prepare(config, seed, data_root)
    expect = harness.reference_answers(config, queries, paths)
    ctl = Control(config["name"], None, "cpu", None, paths, None)
    limit = config["limits"]["float_rel_gap"]
    per = {}
    for q in queries:
        wrong, gap = harness.judge([(q, ctl.answer(q))], expect, limit)
        per[q] = {"wrong": wrong, "float_rel_gap": gap}
    return {"cell": cell_name, "seed": seed,
            "wrong_answers": sum(v["wrong"] for v in per.values()),
            "float_rel_gap": max(v["float_rel_gap"] for v in per.values()),
            "per_query": per}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    for seed in args.seeds:
        t = time.perf_counter()
        r = readings(args.workload, seed)
        r["seconds"] = time.perf_counter() - t
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
