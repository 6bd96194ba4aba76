"""ClickBench q2: SUM(AdvEngineID), COUNT(*), AVG(ResolutionWidth)."""
from typing import List

import pyarrow as pa
import pyarrow.compute as pc


def answer(db) -> List[pa.Array]:
    h = db.read("hits", ["AdvEngineID", "ResolutionWidth"])
    return [pa.array([pc.sum(h["AdvEngineID"]).as_py()], pa.int64()),
            pa.array([h.num_rows], pa.int64()),
            pa.array([pc.mean(pc.cast(h["ResolutionWidth"],
                                      pa.float64())).as_py()])]
