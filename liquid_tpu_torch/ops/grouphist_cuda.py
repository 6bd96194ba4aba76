"""K2: the grouped exact-sum kernel and its wrapper.

Replaces `liquid_tpu/ops/grouphist_pallas.py::group_accumulate`.
`group_accumulate(slot, vals, m)` takes slot int32[n] and vals int32[n,
C] (C <= MAX_COLS) and returns exact int64[m + 1, C] per-slot sums, with
the reference's clamp: a negative slot goes to the trash row m, slots are
clipped to mp - 1 (mp = m + 1 rounded up to 8) and rows beyond m are
dropped.  The TPU kernel's `seg` and `ntab` are not parameters: the card
adds into i64 directly (`csrc/group_accumulate.cu`).

- A CUDA tensor launches the hand-written kernel, built with nvcc on
  first use and loaded with ctypes.
- A CPU tensor takes `grouphist.group_accumulate_ref`, the plain PyTorch
  version.
Anything else (dtype, shape, layout, device) raises.  `LAUNCHES` counts
kernel launches.
"""
from __future__ import annotations

import ctypes
import os
import threading

import torch

from liquid_tpu_torch.ops import nvcc
from liquid_tpu_torch.ops.grouphist import (
    MAX_COLS, MAX_SLOTS, group_accumulate_ref,
)

#: kernel launches since the last reset
LAUNCHES = {"group_accumulate": 0}

SOURCE = os.path.join(nvcc.CSRC, "group_accumulate.cu")
THREADS = 256  # rows per tile, one thread each (kThreads in the source)

_fn = None
_fn_lock = threading.Lock()


def build(verbose: bool = False) -> str:
    """Compile the kernel if this source has not been built yet; returns
    the library path."""
    return nvcc.build(SOURCE, verbose)


def _load():
    global _fn
    with _fn_lock:
        if _fn is None:
            fn = nvcc.load(SOURCE).group_accumulate_launch
            fn.argtypes = [ctypes.c_void_p] * 3 + [
                ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _fn = fn
    return _fn


def _check(slot: torch.Tensor, vals: torch.Tensor, m: int) -> None:
    if slot.dtype != torch.int32 or vals.dtype != torch.int32:
        raise TypeError(f"slot and vals must be int32, got {slot.dtype} "
                        f"and {vals.dtype}")
    if slot.dim() != 1 or vals.dim() != 2 or vals.shape[0] != slot.shape[0]:
        raise ValueError(f"need slot[n] and vals[n, C], got "
                         f"{tuple(slot.shape)} and {tuple(vals.shape)}")
    if not 1 <= vals.shape[1] <= MAX_COLS:
        raise ValueError(f"C = {vals.shape[1]} outside 1..{MAX_COLS}")
    if not 0 <= m < MAX_SLOTS:
        raise ValueError(f"m + 1 = {m + 1} outside 1..{MAX_SLOTS}")
    if slot.device != vals.device:
        raise ValueError(f"slot on {slot.device}, vals on {vals.device}")
    if not (slot.is_contiguous() and vals.is_contiguous()):
        raise ValueError("slot and vals must be contiguous")


def group_accumulate(slot: torch.Tensor, vals: torch.Tensor,
                     m: int) -> torch.Tensor:
    """int64[m + 1, C] per-slot sums.  CUDA tensors run the kernel; CPU
    tensors run the plain version; anything else raises."""
    _check(slot, vals, m)
    dev = slot.device
    if dev.type == "cpu":
        return group_accumulate_ref(slot, vals, m)
    if dev.type != "cuda":
        raise ValueError(f"group_accumulate: unsupported device {dev}")
    n, cols = vals.shape
    out = torch.zeros((m + 1, cols), dtype=torch.int64, device=dev)
    if n == 0:
        return out
    launch = _load()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = max(1, min(-(-n // THREADS), 8 * sms))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = launch(slot.data_ptr(), vals.data_ptr(), out.data_ptr(), n,
                    cols, m, blocks, stream)
    if rc != 0:
        raise RuntimeError(f"group_accumulate launch failed: CUDA error {rc}")
    LAUNCHES["group_accumulate"] += 1
    return out
