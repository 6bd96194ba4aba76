"""ClickBench q17: GROUP BY UserID, SearchPhrase LIMIT 10 with no ORDER BY: any
ten groups with their true counts, so every group is returned and CUT ties
every row."""
from typing import List

import pyarrow as pa

from cachebench.reference.common import EVERY


CUT = ((), 0, 10)


def answer(db) -> List[pa.Array]:
    g = db.read("hits", ["UserID", "SearchPhrase"]).group_by(
        ["UserID", "SearchPhrase"]).aggregate([("UserID", "count", EVERY)])
    return [g["UserID"], g["SearchPhrase"], g["UserID_count"]]
