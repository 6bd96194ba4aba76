"""One run of one cell: data from the seed, set-up, the measured window, the
check against the plain reference, and the metrics.

The cell's workload file names the program under test
(`programs/<program>.py`, such as the in-process session of the port)
and the traffic that drives it in the window (`traffic/<traffic>.py`).
Set-up runs each of the workload's queries once per warm pass, so that
the window holds only warm runs.
"""
from __future__ import annotations

import gc
import re
import statistics
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from cachebench import compare, data, spec, trace
from cachebench.reference.common import Tables

#: top-level module names that may not be loaded in the measuring process
FORBIDDEN = ("jax", "jaxlib", "flax", "liquid_tpu")


@dataclass
class Run:
    """What a run recorded; the metric readers read it."""
    cell: str
    setup_s: float = 0.0
    data_s: float = 0.0
    transcode_s: float = 0.0
    reference_s: float = 0.0
    window_start: int = 0
    window_end: int = 0
    latencies_s: List[float] = field(default_factory=list)
    attempted: int = 0
    completed: int = 0
    peak_bytes: int = 0
    spans: list = field(default_factory=list)
    device_events: list = field(default_factory=list)
    host_waits: list = field(default_factory=list)
    hook_calls: Dict = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return (self.window_end - self.window_start) / 1e9

    def busy_intervals(self):
        return trace.busy(self.device_events, self.window_start,
                          self.window_end)


def table_columns(paths: Dict[str, str], sqls) -> Dict[str, List[str]]:
    """{table: the columns of its schema that the queries' texts name}."""
    import pyarrow.parquet as pq
    words = set()
    for sql in sqls:
        words |= set(re.findall(r"[A-Za-z_][A-Za-z0-9_]*", sql))
    return {t: [c for c in pq.read_schema(p).names if c in words]
            for t, p in paths.items()}


def reference_answers(config: dict, queries, paths, db=None) -> Dict:
    """{query: (reference columns, CUT or None)}."""
    db = db or Tables(paths)
    out = {}
    for q in queries:
        mod = spec.reference(config["name"], q)
        out[q] = (mod.answer(db), getattr(mod, "CUT", None))
    return out


def judge(answers, expect, rtol: float):
    """(wrong answers, the widest float gap) over every answer of the
    window; equal answers are judged once."""
    wrong, gap, seen = 0, 0.0, {}
    for q, out in answers:
        verdicts = seen.setdefault(q, [])
        hit = next((v for a, v in verdicts if a.equals(out)), None)
        if hit is None:
            want, cut = expect[q]
            hit = (not compare.agrees(out, want, cut, rtol),
                   compare.float_gap(out, want))
            verdicts.append((out, hit))
        wrong += hit[0]
        gap = max(gap, hit[1])
    return wrong, gap


def _peak(torch, device: str) -> int:
    return torch.cuda.max_memory_allocated() if device != "cpu" else 0


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def run_cell(cell_name: str, seed: int, seconds: float, traced: bool,
             t0: float, device: str = "cuda", config: Optional[dict] = None,
             workload: Optional[dict] = None,
             data_root: str = data.DATA_DIR,
             program: Optional[Callable] = None) -> dict:
    """One run -> the result line's object (without `device`'s card
    fields, which the caller adds).  `config` and `workload` replace the
    cell's files (the CPU tests run them at small sizes); `program`
    replaces the class that builds the program under test."""
    import torch
    cell = spec.cell(cell_name)
    config = config or spec.config(cell["config"])
    workload = workload or spec.workload(cell_name)
    program = program or spec.program(workload["program"]).Program
    traffic = spec.traffic(workload["traffic"])
    queries = workload["queries"]
    sqls = {q: spec.query_sql(config["name"], q) for q in queries}
    run = Run(cell_name)

    t = time.perf_counter()
    paths = data.prepare(config, seed, data_root)
    run.data_s = time.perf_counter() - t
    log(f"[cachebench] data {run.data_s:.3f} s: {paths}")

    if device != "cpu":
        torch.cuda.reset_peak_memory_stats()
    prog = program(torch, device, workload, paths, sqls)
    t = time.perf_counter()
    prog.transcode(table_columns(paths, sqls.values()))
    run.transcode_s = time.perf_counter() - t
    peaks = [("transcode", _peak(torch, device))]
    for _ in range(workload["warm_passes"]):
        for q in queries:
            prog.answer(q)
            peaks.append((q, _peak(torch, device)))
    log("[cachebench] set-up's peak device bytes after: " + ", ".join(
        f"{k} {v}" for k, v in peaks))

    hooks, tracer = {}, None
    if traced:
        from liquid_tpu_torch.utils.tracing import TRACER as tracer
        for m in spec.metrics_of(cell_name, "per_layer"):
            hooks.update(getattr(spec.metric(m["name"]), "HOOKS", {}))
    answers, unanswered, per_query = [], [], {}

    def record(q, start, end, out, error):
        run.latencies_s.append((end - start) / 1e9)
        per_query.setdefault(q, []).append((end - start) / 1e6)
        run.window_end = max(run.window_end, end)
        if error is not None:
            unanswered.append(f"{q}: {type(error).__name__}: {error}")
        else:
            answers.append((q, out))
    with trace.Hooks(hooks) as hk:
        dev = trace.DeviceTrace(torch) if traced and device != "cpu" \
            else None
        run.setup_s = time.perf_counter() - t0 - run.data_s
        if tracer is not None:
            tracer.reset()
            tracer.enable()
        if dev is not None:
            dev.__enter__()
        run.window_start = run.window_end = time.perf_counter_ns()
        traffic.drive(prog.answer, workload,
                      run.window_start + int(seconds * 1e9), record)
        if dev is not None:
            dev.__exit__(None, None, None)
            run.device_events = dev.events
            run.host_waits = dev.waits
            log(f"[cachebench] traced {len(dev.events)} device operations,"
                f" {len(dev.waits)} blocking runtime calls")
        if tracer is not None:
            tracer.disable()
            run.spans = trace.spans_of(tracer)
            tracer.reset()
    run.hook_calls = dict(hk.calls)
    run.attempted = len(run.latencies_s)
    run.completed = len(answers)
    if device != "cpu":
        run.peak_bytes = torch.cuda.max_memory_allocated()
    prog.close()
    del prog
    gc.collect()

    t = time.perf_counter()
    expect = reference_answers(config, sorted({q for q, _ in answers}),
                               paths)
    run.reference_s = time.perf_counter() - t
    limit = config["limits"]["float_rel_gap"]
    wrong, gap = judge(answers, expect, limit)
    log(f"[cachebench] reference {run.reference_s:.3f} s")
    log("[cachebench] median ms per query: " + ", ".join(
        f"{q} {statistics.median(v):.3f}" for q, v in per_query.items()))
    for u in unanswered[:5]:
        log(f"[cachebench] unanswered {u}")
    checks = {"unanswered": {"value": len(unanswered), "limit": 0},
              "wrong_answers": {"value": wrong, "limit": 0},
              "float_rel_gap": {"value": gap, "limit": limit}}
    correct = run.completed > 0 and all(
        c["value"] <= c["limit"] for c in checks.values())

    kind = "per_layer" if traced else "end_to_end"
    metrics = {}
    for m in spec.metrics_of(cell_name, kind):
        v = spec.metric(m["name"]).read(run)
        if v is None and kind == "end_to_end":
            raise RuntimeError(f"{m['name']}: nothing to read")
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {"correct": correct, "attempted": run.attempted,
              "failed": len(unanswered) + wrong, "metrics": metrics,
              "device": {"platform": "gpu" if device != "cpu" else "cpu",
                         "count": cell["chips"],
                         "memory_peak_bytes": run.peak_bytes}}
    if traced:
        busy_iv = run.busy_intervals()
        result["device"]["busy_s"] = sum(e - s for s, e in busy_iv) / 1e9
        result["device"]["window_s"] = run.window_s
        result["breakdown"] = {
            "device_ops": trace.top_ops(trace.clip_events(
                run.device_events, run.window_start, run.window_end)),
            "idle_gaps": trace.idle_gaps(busy_iv, run.spans,
                                         run.window_start, run.window_end)}
    result["checks"] = checks
    log(f"[cachebench] setup {run.setup_s:.3f} s, transcode "
        f"{run.transcode_s:.3f} s, window {run.window_s:.3f} s, "
        f"{run.completed} answers")
    return result


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
