"""liquid-tpu on PyTorch and CUDA: the port of `liquid_tpu` to an NVIDIA GPU.

Same engine, same stored formats, same answers as the JAX package, which
stays in the repository as the reference.  Encoded columns are bit-planes
held as **int32 tensors carrying the reference's uint32 word bits** (torch
has no `~` or `>>` on uint32); u64 constants ride as int64 bit images.
Hot kernels are written by hand for Hopper (`ops/csrc/`), built with nvcc
on first use and bound with ctypes; each keeps a plain PyTorch twin that
runs only for CPU tensors.

This package imports torch, numpy and pyarrow -- never jax and never
anything of `liquid_tpu`.  Host logic (parser, planner, generators) is
copied here, not imported.

Layer map (mirrors `liquid_tpu`):
  arrays/  - liquid encodings (bit-planes, linear, ALP floats, FSST-backed
             string dictionaries)
  ops/     - masks, bit-plane compares, grouped reductions, the CUDA
             kernels and their twins
  cache/   - cache runtime (memory tiers)
  io/      - parquet tables: row-group stats and zone-map pruning
  sql/     - SQL frontend and the fused scalar and grouped device paths
  bench/   - the benchmark entry point (`python -m
             liquid_tpu_torch.bench.main`), its pyarrow oracle, and the
             data generators
  _native/ - ctypes binding of the native FSST codec (built with g++)
"""

__version__ = "0.1.0"


def __getattr__(name):  # lazy: kernel-only users skip the SQL layers
    if name == "LiquidCacheLocalBuilder":
        from liquid_tpu_torch.sql.session import LiquidCacheLocalBuilder
        return LiquidCacheLocalBuilder
    if name in ("LiquidCache", "LiquidCacheBuilder"):
        from liquid_tpu_torch.cache import core
        return getattr(core, name)
    raise AttributeError(name)
