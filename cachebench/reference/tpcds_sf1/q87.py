"""TPC-DS q87: how many (last name, first name, day) of 2000 bought in
store and in neither other channel: EXCEPT of three DISTINCT joins."""
from typing import List

import pyarrow as pa

from cachebench.reference.tpcds_sf1 import channels_names_by_day

KEYS = ["c_last_name", "c_first_name", "d_date"]


def answer(db) -> List[pa.Array]:
    store, catalog, web = channels_names_by_day(db)
    only = store.join(catalog, KEYS, join_type="left anti")
    only = only.join(web, KEYS, join_type="left anti")
    return [pa.array([only.num_rows], pa.int64())]
