"""Cache-aware expression hints (port of `liquid_tpu/cache/expressions.py`).

The planner tells the cache how a column is consumed: only through
EXTRACT(field) of a date, or only through LIKE '%x%'.  The cache records
the hints per entry with a majority vote.  A SubstringSearch hint makes a
string block carry substring fingerprints (kept resident when it is
squeezed); an ExtractDate32 hint squeezes a date block to that one field
(`arrays/hybrid.py::squeeze_date32`).  `VariantGet` is declared: the
variant (JSON) arrays it steers are not ported, so the cache raises on
it.
"""
from __future__ import annotations

from collections import Counter, deque
from dataclasses import dataclass

from liquid_tpu_torch.utils.dates import FIELDS


@dataclass(frozen=True)
class ExtractDate32:
    field: str  # year | month | day | dow

    def __post_init__(self):
        assert self.field in FIELDS, self.field


@dataclass(frozen=True)
class SubstringSearch:
    pass


@dataclass(frozen=True)
class VariantGet:
    """The column is read only through `variant_get(col, path [, type])`:
    a tuple of (path, type) requests."""

    requests: tuple


class HintVote:
    """Majority vote over a bounded history of hints per entry."""

    def __init__(self, window: int = 16):
        self._hist: deque = deque(maxlen=window)

    def record(self, hint) -> None:
        self._hist.append(hint)

    def majority(self):
        if not self._hist:
            return None
        [(hint, _n)] = Counter(self._hist).most_common(1)
        return hint
