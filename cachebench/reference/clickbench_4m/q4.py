"""ClickBench q4: COUNT(DISTINCT UserID)."""
from typing import List

import pyarrow as pa
import pyarrow.compute as pc


def answer(db) -> List[pa.Array]:
    u = db.read("hits", ["UserID"])["UserID"]
    return [pa.array([pc.count_distinct(u).as_py()], pa.int64())]
