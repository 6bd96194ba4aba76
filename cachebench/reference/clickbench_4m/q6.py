"""ClickBench q6: MIN and MAX of EventDate as a date."""
from typing import List

import pyarrow as pa
import pyarrow.compute as pc


def answer(db) -> List[pa.Array]:
    d = pc.cast(pc.cast(db.read("hits", ["EventDate"])["EventDate"],
                        pa.int32()), pa.date32())
    return [pa.array([pc.min(d).as_py()], pa.date32()),
            pa.array([pc.max(d).as_py()], pa.date32())]
