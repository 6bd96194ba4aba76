"""ClickBench q1: COUNT(*) WHERE AdvEngineID <> 0."""
from typing import List

import pyarrow as pa
import pyarrow.compute as pc


def answer(db) -> List[pa.Array]:
    adv = db.read("hits", ["AdvEngineID"])["AdvEngineID"]
    return [pa.array([pc.sum(pc.not_equal(adv, 0)).as_py()], pa.int64())]
