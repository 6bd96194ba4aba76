"""ClickBench q8: distinct users by RegionID, top ten."""
from typing import List

import pyarrow as pa

from cachebench.reference.common import distinct_users


CUT = ((1,), 0, 10)


def answer(db) -> List[pa.Array]:
    return distinct_users(db.read("hits", ["RegionID", "UserID"]),
                          ["RegionID"])
