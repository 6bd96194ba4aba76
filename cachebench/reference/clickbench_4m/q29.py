"""ClickBench q29: SUM(ResolutionWidth + k) for k in 0..89."""
from typing import List

import pyarrow as pa
import pyarrow.compute as pc


def answer(db) -> List[pa.Array]:
    w = db.read("hits", ["ResolutionWidth"])["ResolutionWidth"]
    total, n = pc.sum(pc.cast(w, pa.int64())).as_py(), len(w)
    return [pa.array([total + k * n], pa.int64()) for k in range(90)]
