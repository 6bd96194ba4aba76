"""ClickBench q15: counts by UserID, top ten."""
from typing import List

import pyarrow as pa

from cachebench.reference.common import counts


CUT = ((1,), 0, 10)


def answer(db) -> List[pa.Array]:
    return counts(db, ["UserID"], False, 10)
