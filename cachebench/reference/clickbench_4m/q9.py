"""ClickBench q9: RegionID with sums, count, average and distinct users, top
ten by count."""
from typing import List

import pyarrow as pa
import pyarrow.compute as pc

from cachebench.reference.common import EVERY


CUT = ((2,), 0, 10)


def answer(db) -> List[pa.Array]:
    h = db.read("hits", ["RegionID", "AdvEngineID", "ResolutionWidth",
                         "UserID"])
    g = h.group_by("RegionID").aggregate([
        ("AdvEngineID", "sum"), ("AdvEngineID", "count", EVERY),
        ("ResolutionWidth", "mean"),
        ("UserID", "count_distinct", pc.CountOptions(mode="only_valid"))
    ]).sort_by([("AdvEngineID_count", "descending")])
    return [g["RegionID"], g["AdvEngineID_sum"], g["AdvEngineID_count"],
            g["ResolutionWidth_mean"], g["UserID_count_distinct"]]
