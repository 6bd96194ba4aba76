"""K1: the batched bit-plane compare kernel and its plain twin.

Replaces `liquid_tpu/ops/bitpack_pallas.py::cmp_const_many_pallas`.
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

Anything else (dtype, shape, layout, device) raises.  `LAUNCHES` counts
kernel launches, so a run can show that its path went through the
kernel.
"""
from __future__ import annotations

import ctypes
import os
import threading
from typing import Tuple

import torch

from liquid_tpu_torch.device import FULL
from liquid_tpu_torch.ops import nvcc
from liquid_tpu_torch.ops.nvcc import BUILD_DIR, NVCC_FLAGS  # noqa: F401

BLOCK_WORDS = 256  # words per 8192-row block

#: kernel launches since the last reset (a plain integer per kernel)
LAUNCHES = {"cmp_const_many": 0}

SOURCE = os.path.join(nvcc.CSRC, "cmp_const_many.cu")

_fn = None
_fn_lock = threading.Lock()


def library_path() -> str:
    """Where the built kernel library lives (keyed by source + flags)."""
    return nvcc.library_path(SOURCE)


def build(verbose: bool = False) -> str:
    """Compile the kernel if this source has not been built yet; returns
    the library path.  Raises with nvcc's output if compilation fails."""
    return nvcc.build(SOURCE, verbose)


def _load():
    global _fn
    with _fn_lock:
        if _fn is None:
            fn = nvcc.load(SOURCE).cmp_const_many_launch
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int,
                                                   ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _fn = fn
    return _fn


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
    launch = _load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = launch(
            planes_stack.data_ptr(), cs.data_ptr(), lt.data_ptr(),
            eq.data_ptr(), bsz, width, stream)
    if rc != 0:
        raise RuntimeError(f"cmp_const_many launch failed: CUDA error {rc}")
    LAUNCHES["cmp_const_many"] += 1
    return lt, eq
