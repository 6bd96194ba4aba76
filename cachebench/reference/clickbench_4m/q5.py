"""ClickBench q5: COUNT(DISTINCT SearchPhrase)."""
from typing import List

import pyarrow as pa
import pyarrow.compute as pc


def answer(db) -> List[pa.Array]:
    s = db.read("hits", ["SearchPhrase"])["SearchPhrase"]
    return [pa.array([pc.count_distinct(s).as_py()], pa.int64())]
