"""ClickBench q0: COUNT(*)."""
from typing import List

import pyarrow as pa


def answer(db) -> List[pa.Array]:
    return [pa.array([db.num_rows("hits")], pa.int64())]
