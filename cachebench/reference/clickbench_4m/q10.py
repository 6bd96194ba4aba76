"""ClickBench q10: distinct users by MobilePhoneModel, top ten."""
from typing import List

import pyarrow as pa
import pyarrow.compute as pc

from cachebench.reference.common import distinct_users


CUT = ((1,), 0, 10)


def answer(db) -> List[pa.Array]:
    h = db.read("hits", ["MobilePhoneModel", "UserID"])
    h = h.filter(pc.not_equal(h["MobilePhoneModel"], ""))
    return distinct_users(h, ["MobilePhoneModel"])
