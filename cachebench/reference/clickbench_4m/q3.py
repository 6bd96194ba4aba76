"""ClickBench q3: AVG(UserID)."""
from typing import List

import pyarrow as pa
import pyarrow.compute as pc


def answer(db) -> List[pa.Array]:
    u = db.read("hits", ["UserID"])["UserID"]
    return [pa.array([pc.mean(pc.cast(u, pa.float64(),
                                      safe=False)).as_py()])]
