"""K1, K3 and K4: the bit-plane compare kernels and their plain twins.

K1 replaces `liquid_tpu/ops/bitpack_pallas.py::cmp_const_many_pallas`.
`cmp_const_many(planes_stack, cs) -> (lt, eq)` takes planes int32[B, w,
256] (the reference's uint32 words, one 8192-row block per b) and
per-block constants int64[B] (u64 bit images).

- A CUDA tensor launches the hand-written kernel
  (`csrc/cmp_const_many.cu`), for every B >= 1 and 1 <= w <= 64.  The
  source is compiled with nvcc on first use into `_build/` next to this
  package, keyed by a hash of the source, and loaded with ctypes.
- A CPU tensor takes `cmp_const_many_ref`, the plain PyTorch version.
- w = 0 has no planes to read: the result follows the constant alone and
  no kernel runs (as in the reference, `bitpack.py:171-177`).

`in_interval_many(planes_stack, lo, hi)` is K1's interval form: the
packed int32[B, 256] mask of values in [lo[b], hi[b]] (inclusive u64
bounds as int64 images), `~lt_lo & (lt_hi | eq_hi)`, from one launch
that reads the planes once.  Its plain version `in_interval_many_ref`
is that expression over two `cmp_const_many_ref` calls.  Both K1 forms
count into `LAUNCHES["cmp_const_many"]`.

K3 `count_gt(planes, c)` and K4 `cmp_const_planes(planes, c)` replace
`count_gt` and `cmp_const_planes` of the same TPU module: one column of
planes int32[w, W] (or `prep`'s zero-copy [w, W/128, 128] view) against
ONE constant c, a Python or numpy integer in [0, 2^64) that the launch
passes by value.  K3 returns the count of rows whose value is > c as an
int32 0-d tensor without a host sync; K4 returns (lt, eq) int32[W].  Both
build from `csrc/cmp_planes.cu`; CPU tensors take `count_gt_ref` /
`cmp_const_planes_ref`.  w = 0, and for K3 a constant with a bit at or
above w, are decided on the host with no launch.

Anything else (dtype, shape, layout, device) raises.  `LAUNCHES` counts
kernel launches, so a run can show that its path went through the
kernel.
"""
from __future__ import annotations

import ctypes
import os
import threading
from typing import Tuple

import numpy as np
import torch

from liquid_tpu_torch.device import FULL, wrap_i64
from liquid_tpu_torch.ops import mask as mops
from liquid_tpu_torch.ops import nvcc
from liquid_tpu_torch.ops.nvcc import BUILD_DIR, NVCC_FLAGS  # noqa: F401

BLOCK_WORDS = 256  # words per 8192-row block
LANES = 128  # last dimension of `prep`'s view

#: kernel launches since the last reset (a plain integer per kernel)
LAUNCHES = {"cmp_const_many": 0, "count_gt": 0, "cmp_const_planes": 0}

SOURCE = os.path.join(nvcc.CSRC, "cmp_const_many.cu")
PLANES_SOURCE = os.path.join(nvcc.CSRC, "cmp_planes.cu")

_fn_lock = threading.Lock()
_fns = {}


def library_path() -> str:
    """Where the built kernel library lives (keyed by source + flags)."""
    return nvcc.library_path(SOURCE)


def build(verbose: bool = False) -> str:
    """Compile the kernel if this source has not been built yet; returns
    the library path.  Raises with nvcc's output if compilation fails."""
    return nvcc.build(SOURCE, verbose)


def _bind(source: str, symbol: str, argtypes):
    """The launch function `symbol` of `source`'s library, built on first
    use, with its ctypes signature (int return: a CUDA error code)."""
    with _fn_lock:
        fn = _fns.get(symbol)
        if fn is None:
            fn = getattr(nvcc.load(source), symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _fns[symbol] = fn
    return fn


#: both K1 launches: planes and three arrays (single: cs, lt, eq;
#: interval: lo, hi, mask), nblocks, width, stream
_K1_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int,
                                    ctypes.c_void_p]


def _check(planes_stack: torch.Tensor, cs: torch.Tensor) -> None:
    if planes_stack.dtype != torch.int32:
        raise TypeError(f"planes must be int32 words, got {planes_stack.dtype}")
    if cs.dtype != torch.int64:
        raise TypeError(f"constants must be int64 bit images, got {cs.dtype}")
    if planes_stack.dim() != 3 or planes_stack.shape[2] != BLOCK_WORDS:
        raise ValueError(f"planes must be [B, w, {BLOCK_WORDS}], "
                         f"got {tuple(planes_stack.shape)}")
    if cs.shape != (planes_stack.shape[0],):
        raise ValueError(f"constants must be [B={planes_stack.shape[0]}], "
                         f"got {tuple(cs.shape)}")
    if planes_stack.shape[1] > 64:
        raise ValueError(f"width {planes_stack.shape[1]} > 64")
    if planes_stack.device != cs.device:
        raise ValueError(f"planes on {planes_stack.device}, "
                         f"constants on {cs.device}")
    if not (planes_stack.is_contiguous() and cs.is_contiguous()):
        raise ValueError("planes and constants must be contiguous")


def _over_width(cs: torch.Tensor, width: int) -> torch.Tensor:
    """bool[B]: constant has a bit at or above `width` (logical test on
    the int64 image: a negative image has bit 63 set)."""
    if width >= 64:
        return torch.zeros_like(cs, dtype=torch.bool)
    return (cs < 0) | ((cs >> width) != 0)


def _const_only(cs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """w = 0: every stored value is 0, so lt = (c != 0), eq = (c == 0)."""
    over = (cs != 0)[:, None].expand(-1, BLOCK_WORDS)
    full = torch.full(over.shape, FULL, dtype=torch.int32, device=cs.device)
    zero = torch.zeros_like(full)
    return torch.where(over, full, zero), torch.where(over, zero, full)


def cmp_const_many_ref(planes_stack: torch.Tensor, cs: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K1 (same contract, any device)."""
    bsz, width, w_words = planes_stack.shape
    lt = torch.zeros((bsz, w_words), dtype=torch.int32,
                     device=planes_stack.device)
    eq = torch.full_like(lt, FULL)
    for k in range(width - 1, -1, -1):
        # (cs >> k) & 1 reads bit k of the image; an arithmetic shift
        # is harmless because only one bit survives the mask
        cb = torch.where(((cs >> k) & 1) != 0, FULL, 0).to(torch.int32)
        pb = planes_stack[:, k]
        lt = lt | (eq & ~pb & cb[:, None])
        eq = eq & ~(pb ^ cb[:, None])
    over = _over_width(cs, width)[:, None]
    lt = torch.where(over, torch.full_like(lt, FULL), lt)
    eq = torch.where(over, torch.zeros_like(eq), eq)
    return lt, eq


def cmp_const_many(planes_stack: torch.Tensor, cs: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lt, eq) int32[B, 256] for planes int32[B, w, 256] against
    per-block u64 constants (int64 images).  CUDA tensors run the
    kernel; CPU tensors run the plain version; anything else raises."""
    _check(planes_stack, cs)
    dev = planes_stack.device
    if planes_stack.shape[1] == 0:
        return _const_only(cs)
    if dev.type == "cpu":
        return cmp_const_many_ref(planes_stack, cs)
    if dev.type != "cuda":
        raise ValueError(f"cmp_const_many: unsupported device {dev}")
    bsz, width, _ = planes_stack.shape
    lt = torch.empty((bsz, BLOCK_WORDS), dtype=torch.int32, device=dev)
    eq = torch.empty_like(lt)
    if bsz == 0:
        return lt, eq
    launch = _bind(SOURCE, "cmp_const_many_launch", _K1_ARGS)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = launch(
            planes_stack.data_ptr(), cs.data_ptr(), lt.data_ptr(),
            eq.data_ptr(), bsz, width, stream)
    if rc != 0:
        raise RuntimeError(f"cmp_const_many launch failed: CUDA error {rc}")
    LAUNCHES["cmp_const_many"] += 1
    return lt, eq


def in_interval_many_ref(planes_stack: torch.Tensor, lo: torch.Tensor,
                         hi: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K1's interval form (any device)."""
    lt_lo, _ = cmp_const_many_ref(planes_stack, lo)
    lt_hi, eq_hi = cmp_const_many_ref(planes_stack, hi)
    return ~lt_lo & (lt_hi | eq_hi)


def in_interval_many(planes_stack: torch.Tensor, lo: torch.Tensor,
                     hi: torch.Tensor) -> torch.Tensor:
    """Packed int32[B, 256] mask of the values in [lo[b], hi[b]] for
    planes int32[B, w, 256].  CUDA tensors run one K1 launch; CPU
    tensors, and w = 0, the plain version; anything else raises."""
    _check(planes_stack, lo)
    _check(planes_stack, hi)
    dev = planes_stack.device
    if dev.type == "cpu" or planes_stack.shape[1] == 0:
        return in_interval_many_ref(planes_stack, lo, hi)
    if dev.type != "cuda":
        raise ValueError(f"in_interval_many: unsupported device {dev}")
    bsz, width, _ = planes_stack.shape
    mask = torch.empty((bsz, BLOCK_WORDS), dtype=torch.int32, device=dev)
    if bsz == 0:
        return mask
    launch = _bind(SOURCE, "in_interval_many_launch", _K1_ARGS)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = launch(planes_stack.data_ptr(), lo.data_ptr(), hi.data_ptr(),
                    mask.data_ptr(), bsz, width, stream)
    if rc != 0:
        raise RuntimeError(f"in_interval_many launch failed: CUDA error {rc}")
    LAUNCHES["cmp_const_many"] += 1
    return mask


# -- K3 / K4: one column against one constant ---------------------------------

def _load_planes(name: str, n_out: int):
    return _bind(PLANES_SOURCE, f"{name}_launch",
                 [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                  ctypes.c_uint64] + [ctypes.c_void_p] * (n_out + 1))


def prep(planes: torch.Tensor) -> torch.Tensor:
    """[w, W] planes -> the [w, W/128, 128] view K3 and K4 also take (no
    copy; W must be a multiple of 128)."""
    if planes.dim() != 2 or planes.shape[1] % LANES:
        raise ValueError(f"prep needs [w, W] planes with W % {LANES} == 0, "
                         f"got {tuple(planes.shape)}")
    return planes.view(planes.shape[0], planes.shape[1] // LANES, LANES)


def _flat_planes(planes: torch.Tensor) -> torch.Tensor:
    """Check one column's planes (flat or prepped) -> the [w, W] view."""
    if planes.dtype != torch.int32:
        raise TypeError(f"planes must be int32 words, got {planes.dtype}")
    if planes.dim() not in (2, 3) or (planes.dim() == 3
                                      and planes.shape[2] != LANES):
        raise ValueError(f"planes must be [w, W] or [w, W/{LANES}, {LANES}],"
                         f" got {tuple(planes.shape)}")
    if planes.shape[0] > 64:
        raise ValueError(f"width {planes.shape[0]} > 64")
    # before the view: a reshape would copy a strided input silently
    if not planes.is_contiguous():
        raise ValueError("planes must be contiguous")
    if planes.dim() == 3:
        planes = planes.view(planes.shape[0], planes.shape[1] * LANES)
    return planes


def _const(c) -> int:
    """The constant as a Python int in [0, 2^64)."""
    if isinstance(c, torch.Tensor) or not isinstance(c, (int, np.integer)) \
            or isinstance(c, (bool, np.bool_)):
        raise TypeError(f"the constant must be a Python or numpy integer, "
                        f"got {type(c).__name__}")
    c = int(c)
    if not 0 <= c < (1 << 64):
        raise ValueError(f"constant {c} outside [0, 2^64)")
    return c


def cmp_const_planes_ref(planes: torch.Tensor, c
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K4 (same contract, any device): K1's
    word-wise loop over the column as one block."""
    flat = _flat_planes(planes)
    c = _const(c)
    if flat.shape[0] == 0:  # every stored value is 0
        lt = torch.full((flat.shape[1],), FULL if c else 0,
                        dtype=torch.int32, device=flat.device)
        return lt, ~lt
    cs = torch.tensor([wrap_i64(c)], dtype=torch.int64, device=flat.device)
    lt, eq = cmp_const_many_ref(flat[None], cs)
    return lt[0], eq[0]


def count_gt_ref(planes: torch.Tensor, c) -> torch.Tensor:
    """Plain PyTorch version of K3: popcount of ~(lt | eq) -> int32 0-d."""
    lt, eq = cmp_const_planes_ref(planes, c)
    return mops.count(~(lt | eq)).to(torch.int32)


def _device(flat: torch.Tensor, name: str) -> torch.device:
    dev = flat.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev


def count_gt(planes: torch.Tensor, c) -> torch.Tensor:
    """Rows whose value is > c, as an int32 0-d tensor on the planes'
    device (no host sync).  CUDA tensors run K3; CPU tensors the plain
    version."""
    flat = _flat_planes(planes)
    c = _const(c)
    dev = _device(flat, "count_gt")
    width, n_words = flat.shape
    if n_words * 32 >= (1 << 31):
        raise ValueError(f"{n_words * 32} rows: the int32 count would "
                         f"overflow (at most 2^31 - 1 rows)")
    if width == 0 or (width < 64 and c >> width) or n_words == 0:
        return torch.zeros((), dtype=torch.int32, device=dev)
    if dev.type == "cpu":
        return count_gt_ref(flat, c)
    out = torch.zeros((), dtype=torch.int32, device=dev)
    launch = _load_planes("count_gt", 1)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = launch(flat.data_ptr(), n_words, width, c, out.data_ptr(),
                    stream)
    if rc != 0:
        raise RuntimeError(f"count_gt launch failed: CUDA error {rc}")
    LAUNCHES["count_gt"] += 1
    return out


def cmp_const_planes(planes: torch.Tensor, c
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lt, eq) int32[W] of every row against c.  CUDA tensors run K4;
    CPU tensors, and w = 0 (the result follows c alone), the plain
    version."""
    flat = _flat_planes(planes)
    c = _const(c)
    dev = _device(flat, "cmp_const_planes")
    width, n_words = flat.shape
    if dev.type == "cpu" or width == 0 or n_words == 0:
        return cmp_const_planes_ref(flat, c)
    lt = torch.empty(n_words, dtype=torch.int32, device=dev)
    eq = torch.empty_like(lt)
    launch = _load_planes("cmp_const_planes", 2)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = launch(flat.data_ptr(), n_words, width, c, lt.data_ptr(),
                    eq.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"cmp_const_planes launch failed: CUDA error {rc}")
    LAUNCHES["cmp_const_planes"] += 1
    return lt, eq
