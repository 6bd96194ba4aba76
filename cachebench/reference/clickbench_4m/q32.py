"""ClickBench q32: WatchID, ClientIP with count, refreshes and average width,
top ten."""
from typing import List

import pyarrow as pa

from cachebench.reference.common import wide


CUT = ((2,), 0, 10)


def answer(db) -> List[pa.Array]:
    return wide(db, ["WatchID", "ClientIP"], False)
