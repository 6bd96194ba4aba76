"""High-cardinality ClickBench `hits` synthesizer (host copy of
`prepare_hits` in the repository's `bench.py`).

Per-column value distributions come from the vendored 24,586-row
`benchmark/data/nano_hits.parquet` sample; string and grouping
cardinalities scale with the row count (official ClickBench: URL
distinct ~0.18x rows, RegionID ~9k) instead of staying at the sample's.
"""
from __future__ import annotations

import os

import numpy as np

NANO_HITS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "benchmark", "data", "nano_hits.parquet")


def prepare_hits(rows: int, out_dir: str, src_path: str = NANO_HITS) -> str:
    """Write `rows` synthesized hits rows (seed 7, row groups of 2^20) to
    `out_dir` once; returns the parquet path."""
    import pyarrow as pa
    import pyarrow.compute as pc
    import pyarrow.parquet as pq
    out = os.path.join(out_dir, f"liquid_bench_hits_hc_{rows}.parquet")
    if os.path.exists(out):
        return out
    src = pq.read_table(src_path)
    rng = np.random.default_rng(7)
    idx = rng.integers(0, src.num_rows, rows)
    big = src.take(pa.array(idx, pa.int64()))
    cols = {n: big.column(n) for n in big.column_names}

    # URL / SearchPhrase: append a skewed suffix id so distinct counts
    # scale with rows (~rows/5 for URL; phrases stay emptier)
    n_url = max(rows // 5, 1)
    sfx = (rng.zipf(1.4, rows) % n_url).astype(np.int64)
    cols["URL"] = pc.binary_join_element_wise(
        cols["URL"].combine_chunks().cast(pa.string()),
        pa.array([f"?sid={s}" for s in sfx], pa.string()), "")
    phr = cols["SearchPhrase"].combine_chunks().cast(pa.string())
    psfx = pa.array([f" {s % max(rows // 50, 1)}" for s in sfx], pa.string())
    cols["SearchPhrase"] = pc.if_else(
        pc.not_equal(phr, ""), pc.binary_join_element_wise(phr, psfx, ""),
        phr)

    # RegionID: zipf-skewed over the official ~9k cardinality
    n_reg = min(9000, max(64, rows // 450))
    cols["RegionID"] = pa.array(
        (rng.zipf(1.3, rows) % n_reg).astype(np.int32), pa.int32())

    os.makedirs(out_dir, exist_ok=True)
    pq.write_table(pa.table(cols), out + ".tmp", row_group_size=1 << 20)
    os.replace(out + ".tmp", out)
    return out
