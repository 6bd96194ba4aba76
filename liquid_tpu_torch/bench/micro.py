"""Micro-benchmark registry (port of `liquid_tpu/bench/micro.py`).

One named benchmark per micro benchmark of the reference (`:60-337`),
with the same names and result keys: bit-plane unpacking, the
primitive, linear and FSST encodings, byte-view compares and their
selectivity, string fingerprints, the date32 squeeze, cache insert / get
with and without memory pressure, encoded filter pushdown through the
cache's batched predicate path (K1, one launch per width bucket),
selection composition (`and_then`), and the two prefix-key studies.

    python -m liquid_tpu_torch.bench.micro               # all, on the card
    python -m liquid_tpu_torch.bench.micro bitpacking    # one
    python -m liquid_tpu_torch.bench.micro --tiny --cpu  # small inputs, CPU
    run_all(tiny=True, device="cpu")

Unlike the reference, whose `main` forces its benchmarks onto the host
CPU (`:355-370`), these run on the card by default; `--cpu` (or
`device="cpu"`) is the only way to the CPU.  The encodings, the string
fingerprints and the prefix studies are host work in the port as in the
reference; the rest runs on the device.  Each timing synchronizes the
card before it reads the clock.  Every benchmark returns a dict with at
least {"name", "value", "unit"}; times are the best of a few runs.

Where a reference key counts nothing (`eviction`'s `disk_evictions`
reads a counter the reference's cache never has, so it is always 0),
the port reports what the key names: the blocks the cache wrote to disk.
"""
from __future__ import annotations

import json
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import pyarrow as pa
import torch

from liquid_tpu_torch.device import resolve_device

REGISTRY: Dict[str, Callable[[bool, torch.device], dict]] = {}


def bench(name: str):
    def deco(fn):
        REGISTRY[name] = fn
        return fn
    return deco


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _best_of(fn, device: torch.device, iters: int = 5) -> float:
    """Best wall time of `iters` runs of `fn`, the card synchronized
    before each start and each stop."""
    best = float("inf")
    for _ in range(iters):
        _synchronize(device)
        t0 = time.perf_counter()
        fn()
        _synchronize(device)
        best = min(best, time.perf_counter() - t0)
    return best


def _words(n: int, seed: int = 0, vocab: int = 4096) -> pa.Array:
    rng = np.random.default_rng(seed)
    pool = ["".join(rng.choice(list("abcdefghij-/."), size=rng.integers(3, 24)))
            for _ in range(vocab)]
    return pa.array([pool[i] for i in rng.integers(0, vocab, n)], pa.string())


# -- 1. bitpacking: bit-plane unpack on the device ---------------------------

BITPACK_WIDTH = 10


def bitpacking_input(tiny: bool, device) -> torch.Tensor:
    """The planes `bitpacking` unpacks: 2^13 (tiny) or 2^20 values of 10
    bits, packed on `device`."""
    from liquid_tpu_torch.ops import bitpack as bp
    n = 1 << (13 if tiny else 20)
    vals = np.random.default_rng(0).integers(0, 1 << BITPACK_WIDTH, n,
                                             dtype=np.uint32)
    return bp.pack_bitplanes(torch.from_numpy(vals.astype(np.int64)).to(
        device), BITPACK_WIDTH)


@bench("bitpacking")
def bench_bitpacking(tiny: bool, device) -> dict:
    from liquid_tpu_torch.ops import bitpack as bp
    planes = bitpacking_input(tiny, device)
    n = planes.shape[1] * 32
    bp.unpack_bitplanes(planes)  # warm
    dt = _best_of(lambda: bp.unpack_bitplanes(planes), device)
    return {"name": "bitpacking", "value": n / dt / 1e9,
            "unit": "Grows/s unpack", "rows": n, "width": BITPACK_WIDTH}


# -- 2. primitive_encoding (host) ---------------------------------------------

@bench("primitive_encoding")
def bench_primitive_encoding(tiny: bool, device) -> dict:
    from liquid_tpu_torch.arrays.primitive import LiquidPrimitiveArray
    n = 8192
    arr = pa.array(np.random.default_rng(0).integers(0, 1000, n), pa.int32())
    iters = 2 if tiny else 20
    dt_enc = _best_of(lambda: LiquidPrimitiveArray.from_arrow(arr), device,
                      iters)
    liq = LiquidPrimitiveArray.from_arrow(arr)
    dt_dec = _best_of(lambda: liq.to_arrow(), device, iters)
    return {"name": "primitive_encoding", "value": n / dt_enc / 1e6,
            "unit": "Mrows/s encode", "decode_mrows_s": n / dt_dec / 1e6,
            "ratio": liq.memory_bytes() / (4 * n)}


# -- 3. linear_integer (host) -------------------------------------------------

@bench("linear_integer")
def bench_linear_integer(tiny: bool, device) -> dict:
    from liquid_tpu_torch.arrays.linear import LiquidLinearArray
    n = 8192
    base = np.arange(n, dtype=np.int64) * 7
    noise = np.random.default_rng(0).integers(-3, 4, n)
    arr = pa.array(base + noise, pa.int64())
    iters = 2 if tiny else 20
    dt = _best_of(lambda: LiquidLinearArray.from_arrow(arr), device, iters)
    liq = LiquidLinearArray.from_arrow(arr)
    return {"name": "linear_integer", "value": n / dt / 1e6,
            "unit": "Mrows/s encode", "ratio": liq.memory_bytes() / (8 * n)}


# -- 4. fsst_view: compress / decompress (host) -------------------------------

@bench("fsst_view")
def bench_fsst_view(tiny: bool, device) -> dict:
    from liquid_tpu_torch.arrays.fsst import FsstCompressor
    n = 1 << (10 if tiny else 14)
    vals = _words(n, vocab=256)
    comp = FsstCompressor.train_on_arrow(vals)
    raw = b"".join(v.encode() for v in vals.to_pylist())
    packed = comp.compress(raw)
    iters = 3 if tiny else 10
    dt_c = _best_of(lambda: comp.compress(raw), device, iters)
    dt_d = _best_of(lambda: comp.decompress(packed), device, iters)
    return {"name": "fsst_view", "value": len(raw) / dt_c / 1e6,
            "unit": "MB/s compress", "decompress_mb_s": len(raw) / dt_d / 1e6,
            "ratio": len(packed) / len(raw)}


# -- 5. byte_view_compare: three string predicates -> row masks ---------------

def _count_selected(mask) -> int:
    from liquid_tpu_torch.ops import mask as mops
    return int(mops.count(mask.to_selection()))


@bench("byte_view_compare")
def bench_byte_view_compare(tiny: bool, device) -> dict:
    from liquid_tpu_torch.arrays.base import Predicate
    from liquid_tpu_torch.arrays.byteview import LiquidByteViewArray
    n = 8192
    liq = LiquidByteViewArray.from_arrow(_words(n), with_fingerprints=True)
    needle = _words(1, seed=1).to_pylist()[0]
    preds = [Predicate("eq", needle), Predicate("lt", needle),
             Predicate("contains", needle[:2])]
    iters = 2 if tiny else 20

    def run():
        for p in preds:
            m = liq.try_eval_predicate(p, device)
            assert m is not None
            _count_selected(m)
    dt = _best_of(run, device, iters)
    return {"name": "byte_view_compare", "value": len(preds) * n / dt / 1e6,
            "unit": "Mrows/s (3 ops)"}


# -- 6. fsst_selectivity ------------------------------------------------------

@bench("fsst_selectivity")
def bench_fsst_selectivity(tiny: bool, device) -> dict:
    from liquid_tpu_torch.arrays.base import Predicate
    from liquid_tpu_torch.arrays.byteview import LiquidByteViewArray
    n = 8192
    vals = _words(n)
    liq = LiquidByteViewArray.from_arrow(vals, with_fingerprints=True)
    uniq = sorted(set(vals.to_pylist()))
    out = {}
    iters = 2 if tiny else 10
    for frac, lit in (("0.01", uniq[len(uniq) // 100]),
                      ("0.50", uniq[len(uniq) // 2]),
                      ("0.99", uniq[-1])):
        pred = Predicate("lt_eq", lit)
        dt = _best_of(lambda p=pred: _count_selected(
            liq.try_eval_predicate(p, device)), device, iters)
        out[f"sel_{frac}_mrows_s"] = n / dt / 1e6
    return {"name": "fsst_selectivity", "value": out["sel_0.50_mrows_s"],
            "unit": "Mrows/s @50%", **out}


# -- 7. string_fingerprint (host) ---------------------------------------------

@bench("string_fingerprint")
def bench_string_fingerprint(tiny: bool, device) -> dict:
    from liquid_tpu_torch.arrays.byteview import (_fingerprints,
                                                  _needle_fingerprint)
    n = 1 << (10 if tiny else 13)
    vals = _words(n, vocab=n)
    iters = 2 if tiny else 10
    dt = _best_of(lambda: _fingerprints(vals), device, iters)
    fps = _fingerprints(vals)
    need = np.uint32(_needle_fingerprint(b"zq"))  # rare: prunes nearly all
    cand = ((fps & need) == need).mean()
    return {"name": "string_fingerprint", "value": n / dt / 1e6,
            "unit": "Mstrings/s build", "candidate_rate": float(cand)}


# -- 8. squeeze_date32: squeeze on the host, read the field on the device -----

@bench("squeeze_date32")
def bench_squeeze_date32(tiny: bool, device) -> dict:
    from liquid_tpu_torch.arrays.hybrid import squeeze_date32
    from liquid_tpu_torch.arrays.primitive import LiquidPrimitiveArray
    n = 8192
    days = np.random.default_rng(0).integers(8000, 20000, n, dtype=np.int32)
    liq = LiquidPrimitiveArray.from_arrow(pa.array(days, pa.date32()))
    iters = 2 if tiny else 10
    dt = _best_of(lambda: squeeze_date32(liq, "year"), device, iters)
    sq, _ = squeeze_date32(liq, "year")
    dt_read = _best_of(lambda: sq.to_component_array("year", device), device,
                       iters)
    return {"name": "squeeze_date32", "value": n / dt / 1e6,
            "unit": "Mrows/s squeeze",
            "component_read_mrows_s": n / dt_read / 1e6,
            "squeezed_ratio": sq.memory_bytes() / (4 * n)}


# -- 9. cache_storage: insert / get loop --------------------------------------

@bench("cache_storage")
def bench_cache_storage(tiny: bool, device) -> dict:
    from liquid_tpu_torch.cache.core import LiquidCacheBuilder
    n_entries = 8 if tiny else 64
    arr = pa.array(np.random.default_rng(0).integers(0, 1000, 8192), pa.int64())
    cache = (LiquidCacheBuilder().with_max_memory_bytes(1 << 30)
             .with_device(device).build())
    _synchronize(device)
    t0 = time.perf_counter()
    for i in range(n_entries):
        cache.insert(i, arr)
    _synchronize(device)
    dt_ins = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i in range(n_entries):
        cache.get(i)
    _synchronize(device)
    dt_get = time.perf_counter() - t0
    return {"name": "cache_storage",
            "value": n_entries * 8192 / dt_ins / 1e6,
            "unit": "Mrows/s insert",
            "get_mrows_s": n_entries * 8192 / dt_get / 1e6}


# -- 10. eviction: inserts under memory pressure ------------------------------

@bench("eviction")
def bench_eviction(tiny: bool, device) -> dict:
    import tempfile
    from liquid_tpu_torch.cache.core import LiquidCacheBuilder
    n_entries = 16 if tiny else 128
    arr = pa.array(np.random.default_rng(0).integers(0, 1 << 20, 8192),
                   pa.int64())
    with tempfile.TemporaryDirectory() as d:
        cache = (LiquidCacheBuilder()
                 .with_max_memory_bytes(96 * 1024)   # forces the squeeze loop
                 .with_disk_path(d + "/store.bin")
                 .with_device(device).build())
        _synchronize(device)
        t0 = time.perf_counter()
        for i in range(n_entries):
            cache.insert(i, arr)
        _synchronize(device)
        dt = time.perf_counter() - t0
        st = cache.stats()
    return {"name": "eviction", "value": n_entries * 8192 / dt / 1e6,
            "unit": "Mrows/s insert-under-pressure",
            "squeezes": st["squeezes"], "disk_evictions": st["disk_writes"]}


# -- 11. filter_pushdown: the cache's batched encoded predicate path (K1) -----

FILTER_BLOCKS = {True: 4, False: 32}
FILTER_PRED = ("lt", 500)


def filter_pushdown_cache(tiny: bool, device):
    """The cache `filter_pushdown` evaluates: 4 (tiny) or 32 resident
    blocks of one int32 column -> (cache, entry ids)."""
    from liquid_tpu_torch.cache.core import LiquidCacheBuilder
    arr = pa.array(np.random.default_rng(0).integers(0, 1000, 8192), pa.int32())
    cache = (LiquidCacheBuilder().with_max_memory_bytes(1 << 30)
             .with_device(device).build())
    ids = list(range(FILTER_BLOCKS[tiny]))
    for i in ids:
        cache.insert(i, arr)
    return cache, ids


@bench("filter_pushdown")
def bench_filter_pushdown(tiny: bool, device) -> dict:
    from liquid_tpu_torch.arrays.base import Predicate
    cache, ids = filter_pushdown_cache(tiny, device)
    pred = Predicate(*FILTER_PRED)
    cache.eval_predicate_many(ids, pred)  # warm
    iters = 2 if tiny else 10
    dt = _best_of(lambda: [_count_selected(m) for m in
                           cache.eval_predicate_many(ids, pred)],
                  device, iters)
    return {"name": "filter_pushdown", "value": len(ids) * 8192 / dt / 1e6,
            "unit": "Mrows/s encoded eval", "evals": 1 + iters}


# -- 12. boolean_and_then: selection composition ------------------------------

@bench("boolean_and_then")
def bench_boolean_and_then(tiny: bool, device) -> dict:
    from liquid_tpu_torch.ops import mask as mops
    n = 8192
    rng = np.random.default_rng(0)
    sel_bools = rng.random(n) < 0.5
    sel = mops.pack_bools(torch.from_numpy(sel_bools).to(device))
    # `filtered` covers the k selected rows in order; bits past k are
    # ignored by and_then
    filt_bools = np.zeros(n, bool)
    k = int(sel_bools.sum())
    filt_bools[:k] = rng.random(k) < 0.5
    filt = mops.pack_bools(torch.from_numpy(filt_bools).to(device))
    int(mops.count(mops.and_then(sel, filt)))  # warm
    iters = 3 if tiny else 20
    dt = _best_of(lambda: int(mops.count(mops.and_then(sel, filt))), device,
                  iters)
    return {"name": "boolean_and_then", "value": n / dt / 1e6,
            "unit": "Mrows/s"}


# -- 13. filter_selectivity_ambiguity (host study) ----------------------------

@bench("filter_selectivity_ambiguity")
def bench_filter_ambiguity(tiny: bool, device) -> dict:
    """How often prefix keys settle a compare without decompression,
    across needle positions."""
    from liquid_tpu_torch.arrays.prefixkeys import (build_prefix_meta,
                                                    prefix_verdict)
    n = 1 << (10 if tiny else 13)
    vals = _words(n, vocab=n)
    meta = build_prefix_meta(vals)
    uniq = sorted(set(vals.to_pylist()))
    ambs = []
    for lit in (uniq[0], uniq[len(uniq) // 2], uniq[-1]):
        _verdict, amb = prefix_verdict(meta, "lt", lit.encode())
        ambs.append(float(np.mean(amb)) if amb is not None else 1.0)
    return {"name": "filter_selectivity_ambiguity",
            "value": float(np.mean(ambs)), "unit": "ambiguous fraction",
            "per_point": ambs}


# -- 14. prefix_differentiability (host study) --------------------------------

@bench("prefix_differentiability")
def bench_prefix_differentiability(tiny: bool, device) -> dict:
    """Fraction of dictionary pairs told apart by the 8-byte prefix alone:
    sorted prefixes, adjacent ties counted."""
    from liquid_tpu_torch.arrays.prefixkeys import build_prefix_meta
    n = 1 << (10 if tiny else 13)
    vals = _words(n, vocab=n)
    meta = build_prefix_meta(vals)
    p = np.sort(meta.prefixes)
    ties = float(np.mean(p[1:] == p[:-1])) if len(p) > 1 else 0.0
    return {"name": "prefix_differentiability", "value": 1.0 - ties,
            "unit": "distinguishable fraction", "dict_size": int(len(p))}


def run_all(tiny: bool = False, names: Optional[List[str]] = None,
            device=None) -> List[dict]:
    """The named benchmarks (all by default) on `device` (the card by
    default) -> one result dict each, in registry order."""
    if names:
        unknown = [n for n in names if n not in REGISTRY]
        if unknown:
            raise ValueError(f"unknown benchmark name(s) {unknown}; "
                             f"known: {sorted(REGISTRY)}")
    dev = resolve_device(device)
    return [fn(tiny, dev) for name, fn in REGISTRY.items()
            if not names or name in names]


def main(argv: List[str]) -> int:
    names = [a for a in argv if not a.startswith("-")]
    try:
        results = run_all(tiny="--tiny" in argv, names=names or None,
                          device="cpu" if "--cpu" in argv else None)
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return 2
    for r in results:
        print(json.dumps(r))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
