"""Cache-trace visualization and cache-state simulation (host copy of
`liquid_tpu/devtools/trace_viz.py`).

Reference behavior: the dev-tools web app of liquid-cache
(`dev/dev-tools/src/main.rs`, `components/cache_state_view.rs`): it loads
a cache access trace and shows each entry's access timeline and the
simulated cache state over time.  Here one self-contained HTML file
(an inline SVG timeline and the state table) is written from the trace
parquet that the cache's access tracer writes
(`cache/observer.Observer.flush_trace_parquet`, the admin server's
`/stop_trace?path=`):

    python -m liquid_tpu_torch.devtools.trace_viz trace.parquet out.html
"""
from __future__ import annotations

import html
import sys
from collections import Counter, defaultdict
from typing import List, Optional

OP_COLORS = {
    "insert": "#4e79a7",
    "get": "#59a14f",
    "eval_predicate": "#f28e2b",
    "squeeze_io_read": "#e15759",
}
DEFAULT_COLOR = "#9c755f"


def load_trace(path: str):
    import pyarrow.parquet as pq
    t = pq.read_table(path)
    return list(zip(t.column("ts").to_pylist(), t.column("op").to_pylist(),
                    t.column("entry_id").to_pylist(),
                    t.column("nbytes").to_pylist()))


def simulate_state(records) -> List[dict]:
    """Replay the trace into per-entry access summaries (the reference's
    cache-state simulation: which entries are hot, how much IO each
    caused)."""
    per_entry: dict = defaultdict(lambda: {
        "inserts": 0, "gets": 0, "evals": 0, "io_reads": 0,
        "bytes": 0, "first_ts": None, "last_ts": None})
    for ts, op, eid, nbytes in records:
        e = per_entry[eid]
        key = {"insert": "inserts", "get": "gets",
               "eval_predicate": "evals",
               "squeeze_io_read": "io_reads"}.get(op)
        if key:
            e[key] += 1
        e["bytes"] += nbytes
        e["first_ts"] = ts if e["first_ts"] is None else e["first_ts"]
        e["last_ts"] = ts
    out = []
    for eid, e in sorted(per_entry.items()):
        out.append({"entry_id": eid, **e})
    return out


def render_html(records, title: str = "liquid-tpu cache trace") -> str:
    if not records:
        return f"<html><body><h1>{html.escape(title)}</h1>(empty trace)</body></html>"
    t0 = min(r[0] for r in records)
    t1 = max(r[0] for r in records) or (t0 + 1e-6)
    span = max(t1 - t0, 1e-6)
    entries = sorted({r[2] for r in records})
    lane = {e: i for i, e in enumerate(entries)}
    width, lane_h = 980, 14
    height = lane_h * len(entries) + 40
    marks = []
    for ts, op, eid, nbytes in records:
        x = 60 + (ts - t0) / span * (width - 80)
        y = 28 + lane[eid] * lane_h
        c = OP_COLORS.get(op, DEFAULT_COLOR)
        marks.append(
            f'<circle cx="{x:.1f}" cy="{y}" r="3.2" fill="{c}">'
            f'<title>{html.escape(op)} entry={eid} bytes={nbytes} '
            f't=+{(ts - t0) * 1000:.2f}ms</title></circle>')
    lanes = []
    for e, i in lane.items():
        y = 28 + i * lane_h
        lanes.append(f'<text x="4" y="{y + 4}" font-size="9" '
                     f'fill="#666">{e}</text>')
        lanes.append(f'<line x1="56" y1="{y}" x2="{width - 10}" y2="{y}" '
                     f'stroke="#eee"/>')
    legend = "".join(
        f'<span style="color:{c}">&#9679;</span> {op} &nbsp; '
        for op, c in OP_COLORS.items())
    ops = Counter(r[1] for r in records)
    stats_rows = "".join(
        f"<tr><td>{html.escape(k)}</td><td>{v}</td></tr>"
        for k, v in ops.most_common())
    sim = simulate_state(records)
    sim_rows = "".join(
        f"<tr><td>{s['entry_id']}</td><td>{s['inserts']}</td>"
        f"<td>{s['gets']}</td><td>{s['evals']}</td><td>{s['io_reads']}</td>"
        f"<td>{s['bytes']}</td></tr>" for s in sim[:200])
    return f"""<!doctype html><html><head><meta charset="utf-8">
<title>{html.escape(title)}</title>
<style>body{{font-family:sans-serif;margin:20px}}
table{{border-collapse:collapse}}td,th{{border:1px solid #ddd;
padding:3px 8px;font-size:12px}}</style></head><body>
<h2>{html.escape(title)}</h2>
<p>{len(records)} events over {span * 1000:.1f} ms across
{len(entries)} entries.&nbsp; {legend}</p>
<svg width="{width}" height="{height}">{''.join(lanes)}{''.join(marks)}</svg>
<h3>Ops</h3><table><tr><th>op</th><th>count</th></tr>{stats_rows}</table>
<h3>Per-entry state simulation</h3>
<table><tr><th>entry</th><th>inserts</th><th>gets</th><th>evals</th>
<th>io reads</th><th>bytes</th></tr>{sim_rows}</table>
</body></html>"""


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 2:
        print("usage: trace_viz <trace.parquet> <out.html>")
        return 1
    records = load_trace(argv[0])
    with open(argv[1], "w") as f:
        f.write(render_html(records, title=argv[0]))
    print(f"wrote {argv[1]} ({len(records)} events)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
