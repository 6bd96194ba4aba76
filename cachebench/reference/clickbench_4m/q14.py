"""ClickBench q14: counts by SearchEngineID and non-empty SearchPhrase, top
ten."""
from typing import List

import pyarrow as pa

from cachebench.reference.common import counts


CUT = ((2,), 0, 10)


def answer(db) -> List[pa.Array]:
    return counts(db, ["SearchEngineID", "SearchPhrase"], True, 10)
