"""The generated tables of a configuration, made from the seed and kept as
parquet in `_data/<config>/` inside the benchmark's folder, one seed at a
time: a run with the seed and configuration of the files there reuses
them, any other run makes them anew.
"""
from __future__ import annotations

import hashlib
import importlib
import json
import multiprocessing
import os
import shutil
from concurrent.futures import ProcessPoolExecutor
from typing import Dict

from cachebench.spec import HERE

DATA_DIR = os.path.join(HERE, "_data")


def _stamp(config: dict, seed: int, gen) -> dict:
    with open(gen.__file__, "rb") as f:
        src = hashlib.sha256(f.read()).hexdigest()
    return {"seed": seed, "config": config, "generator": src}


def prepare(config: dict, seed: int, root: str = DATA_DIR
            ) -> Dict[str, str]:
    """{table: parquet path} of `config`'s tables drawn from `seed`."""
    gen = importlib.import_module(
        f"cachebench.generators.{config['generator']}")
    out = os.path.join(root, config["name"])
    stamp_path = os.path.join(out, "stamp.json")
    want = _stamp(config, seed, gen)
    if os.path.exists(stamp_path):
        with open(stamp_path) as f:
            have = json.load(f)
        if have["stamp"] == want:
            return {t: os.path.join(out, p) for t, p in have["files"].items()}
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    # in a process of its own, so that the generator's heap is not left to
    # the process that measures
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(1, mp_context=ctx) as pool:
        paths = pool.submit(gen.write, config, seed, out).result()
    with open(stamp_path + ".tmp", "w") as f:
        json.dump({"stamp": want, "files": {
            t: os.path.relpath(p, out) for t, p in paths.items()}}, f)
    os.replace(stamp_path + ".tmp", stamp_path)
    return paths
