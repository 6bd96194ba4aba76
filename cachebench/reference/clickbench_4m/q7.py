"""ClickBench q7: AdvEngineID counts where it is not 0; the whole answer is
ordered by a count that may tie."""
from typing import List

import pyarrow as pa
import pyarrow.compute as pc

from cachebench.reference.common import EVERY


CUT = ((1,), 0, 1 << 40)


def answer(db) -> List[pa.Array]:
    h = db.read("hits", ["AdvEngineID"])
    h = h.filter(pc.not_equal(h["AdvEngineID"], 0))
    g = h.group_by("AdvEngineID").aggregate(
        [("AdvEngineID", "count", EVERY)]).sort_by(
            [("AdvEngineID_count", "descending")])
    return [g["AdvEngineID"], g["AdvEngineID_count"]]
