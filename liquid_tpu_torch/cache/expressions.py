"""Cache-aware expression hints (port of `liquid_tpu/cache/expressions.py`).

The planner tells the cache how a column is consumed: only through
EXTRACT(field) of a date, or only through LIKE '%x%'.  The cache records
the hints per entry with a majority vote.  A SubstringSearch hint makes a
string block carry substring fingerprints (kept resident when it is
squeezed); an ExtractDate32 hint squeezes a date block to that one field
(`arrays/hybrid.py::squeeze_date32`).  A VariantGet hint (the column
is read only through `variant_get(col, path, type)`) keeps the column in
arrow form until it is squeezed, then shreds the requested paths into
typed resident blocks (`arrays/variant.py`); the vote keeps the union of
every variant path asked for.  A PredicateColumn hint (the column is
filtered) is recorded like the others; `parse_hint` reads a hint from its
metadata string (reference `:63-77`).
"""
from __future__ import annotations

from collections import Counter, deque
from dataclasses import dataclass
from typing import Optional

from liquid_tpu_torch.arrays.variant import PATH_TYPES
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
class PredicateColumn:
    pass


@dataclass(frozen=True)
class VariantGet:
    """The column is read only through `variant_get(col, path [, type])`:
    a squeeze shreds the requested (path, type) pairs into typed resident
    blocks."""

    requests: tuple  # of (path: str, type: str)

    def __post_init__(self):
        for _p, t in self.requests:
            assert t in PATH_TYPES, t

    def merged(self, other: "VariantGet") -> "VariantGet":
        want = dict.fromkeys(self.requests)
        want.update(dict.fromkeys(other.requests))
        return VariantGet(tuple(want))


def parse_hint(s: str) -> Optional[object]:
    """A hint from its metadata string: `extract_date32:FIELD`,
    `substring_search`, `predicate_column` or `variant_get:PATH[@TYPE],..`
    (a path without a type reads as `variant`); None for anything else."""
    if s.startswith("extract_date32:"):
        return ExtractDate32(s.split(":", 1)[1])
    if s == "substring_search":
        return SubstringSearch()
    if s == "predicate_column":
        return PredicateColumn()
    if s.startswith("variant_get:"):
        reqs = []
        for part in s.split(":", 1)[1].split(","):
            path, _, t = part.partition("@")
            reqs.append((path, t or "variant"))
        return VariantGet(tuple(reqs))
    return None


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
        if isinstance(hint, VariantGet):
            # variant hints accumulate: the squeeze keeps the union of
            # every path a query asked for
            for h in self._hist:
                if isinstance(h, VariantGet):
                    hint = hint.merged(h)
        return hint
