"""Civil-calendar math on date32 values (days since 1970-01-01), in numpy
(a copy of `liquid_tpu/utils/dates.py`).

Howard Hinnant's `civil_from_days` (public-domain chrono algorithms),
vectorized over int arrays.  The squeezed date32 form keeps one extracted
field resident (`arrays/hybrid.py`).
"""
from __future__ import annotations

import numpy as np

FIELDS = ("year", "month", "day", "dow")


def civil_from_days(z: np.ndarray):
    """days since the epoch -> (year, month, day) int32 arrays."""
    z = z.astype(np.int64) + 719468
    era = np.where(z >= 0, z, z - 146096) // 146097
    doe = z - era * 146097                                   # [0, 146096]
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)          # [0, 365]
    mp = (5 * doy + 2) // 153                                # [0, 11]
    d = doy - (153 * mp + 2) // 5 + 1                        # [1, 31]
    m = np.where(mp < 10, mp + 3, mp - 9)                    # [1, 12]
    y = y + (m <= 2)
    return y.astype(np.int32), m.astype(np.int32), d.astype(np.int32)


def extract_field(days: np.ndarray, field: str) -> np.ndarray:
    field = field.lower()
    if field == "dow":
        # 0 = Sunday; 1970-01-01 was a Thursday
        return ((days.astype(np.int64) + 4) % 7).astype(np.int32)
    y, m, d = civil_from_days(days)
    if field == "year":
        return y
    if field == "month":
        return m
    if field == "day":
        return d
    raise ValueError(field)
