"""ClickBench q11: distinct users by MobilePhone and MobilePhoneModel, top
ten."""
from typing import List

import pyarrow as pa
import pyarrow.compute as pc

from cachebench.reference.common import distinct_users


CUT = ((2,), 0, 10)


def answer(db) -> List[pa.Array]:
    h = db.read("hits", ["MobilePhone", "MobilePhoneModel", "UserID"])
    h = h.filter(pc.not_equal(h["MobilePhoneModel"], ""))
    return distinct_users(h, ["MobilePhone", "MobilePhoneModel"])
