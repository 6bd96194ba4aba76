"""TPC-DS q38: how many (last name, first name, day) of 2000 bought in all
three channels: INTERSECT of three DISTINCT joins."""
from typing import List

import pyarrow as pa

from cachebench.reference.tpcds_sf1 import channels_names_by_day

KEYS = ["c_last_name", "c_first_name", "d_date"]


def answer(db) -> List[pa.Array]:
    store, catalog, web = channels_names_by_day(db)
    both = store.join(catalog, KEYS, join_type="left semi")
    both = both.join(web, KEYS, join_type="left semi")
    return [pa.array([both.num_rows], pa.int64())]
