"""K2: the grouped exact-sum kernel and its wrapper.

Replaces `liquid_tpu/ops/grouphist_pallas.py::group_accumulate`.
`group_accumulate(slot, cols, m)` takes slot int32[n] and a sequence of
1..MAX_COLS payload columns, each a contiguous int32[n], and returns exact
int64[m + 1, C] per-slot sums with the reference's clamp: a negative slot
goes to the trash row m, slots are clipped to mp - 1 (mp = m + 1 rounded
up to 8) and rows beyond m are dropped.  The TPU kernel's `seg` and `ntab`
are not parameters: the card adds into i64 tables in shared memory
(`csrc/group_accumulate.cu`).

- A CUDA tensor launches the hand-written kernel, built with nvcc on
  first use and loaded with ctypes.  The columns are read in place (no
  [n, C] stack), with 16-byte loads, so on the card `slot` and every
  column must start 16-byte aligned.  The result is the transposed view of a
  column-major [C, m + 1] buffer: each output column is contiguous.
- A CPU tensor takes `grouphist.group_accumulate_ref`, the plain PyTorch
  version.
Anything else (dtype, shape, layout, alignment, device) raises.
`LAUNCHES` counts calls that launched the kernel.  `plan` is the launch
plan (grid, shared bytes per CTA, slot ranges), in Python so that the CPU
tests reach it.
"""
from __future__ import annotations

import ctypes
import os
import threading
from typing import List, NamedTuple, Sequence

import torch

from liquid_tpu_torch.ops import nvcc
from liquid_tpu_torch.ops.grouphist import (
    MAX_COLS, MAX_SLOTS, group_accumulate_ref, padded_slots,
)

#: kernel launches since the last reset
LAUNCHES = {"group_accumulate": 0}

SOURCE = os.path.join(nvcc.CSRC, "group_accumulate.cu")
THREADS = 1024  # threads per CTA (kThreads in the source)
#: shared memory one CTA may opt into on sm_90 (kMaxSmem in the source)
MAX_SMEM = 232_448
SLOT_BYTES = 8  # one i64 table entry per slot (two u32 words)

_fn = None
_fn_lock = threading.Lock()


class Plan(NamedTuple):
    """One K2 launch: a grid of (C x ranges, chunks) CTAs of THREADS."""
    ranges: int  # slot ranges that split [0, mp)
    range_len: int  # slots per range (the last may be shorter)
    smem: int  # shared bytes per CTA: the range's table
    chunks: int  # row chunks
    quads_per_chunk: int  # groups of 4 rows per chunk


def plan(n: int, cols: int, m: int, sms: int) -> Plan:
    """Split [0, mp) into the fewest equal ranges whose tables fit one
    CTA's shared memory, then give every (column, range) pair as many
    row chunks as keep the grid at one CTA per SM (at least one quad per
    thread per chunk)."""
    mp = padded_slots(m)
    ranges = -(-mp // (MAX_SMEM // SLOT_BYTES))
    range_len = -(-mp // ranges)
    n4 = n // 4
    chunks = max(1, min(sms // (cols * ranges), -(-n4 // THREADS)))
    per = max(1, -(-n4 // chunks))
    chunks = max(1, -(-n4 // per))
    return Plan(ranges, range_len, range_len * SLOT_BYTES, chunks, per)


def build(verbose: bool = False) -> str:
    """Compile the kernel if this source has not been built yet; returns
    the library path."""
    return nvcc.build(SOURCE, verbose)


def _load():
    global _fn
    with _fn_lock:
        if _fn is None:
            fn = nvcc.load(SOURCE).group_accumulate_launch
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                           ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _fn = fn
    return _fn


def _check(slot: torch.Tensor, cols: Sequence[torch.Tensor], m: int
           ) -> List[torch.Tensor]:
    if isinstance(cols, torch.Tensor):
        raise TypeError("cols must be a sequence of int32[n] tensors, "
                        "not one tensor")
    cols = list(cols)
    if not 1 <= len(cols) <= MAX_COLS:
        raise ValueError(f"C = {len(cols)} outside 1..{MAX_COLS}")
    if slot.dtype != torch.int32 or any(c.dtype != torch.int32
                                        for c in cols):
        raise TypeError(f"slot and cols must be int32, got {slot.dtype} and "
                        f"{sorted({str(c.dtype) for c in cols})}")
    if slot.dim() != 1 or any(c.shape != slot.shape for c in cols):
        raise ValueError(f"need slot[n] and C columns [n], got "
                         f"{tuple(slot.shape)} and "
                         f"{[tuple(c.shape) for c in cols]}")
    if not 0 <= m < MAX_SLOTS:
        raise ValueError(f"m + 1 = {m + 1} outside 1..{MAX_SLOTS}")
    if any(c.device != slot.device for c in cols):
        raise ValueError(f"slot on {slot.device}, cols on "
                         f"{sorted({str(c.device) for c in cols})}")
    if not all(t.is_contiguous() for t in [slot] + cols):
        raise ValueError("slot and cols must be contiguous")
    return cols


def group_accumulate(slot: torch.Tensor, cols: Sequence[torch.Tensor],
                     m: int) -> torch.Tensor:
    """int64[m + 1, C] per-slot sums.  CUDA tensors run the kernel; CPU
    tensors run the plain version; anything else raises."""
    cols = _check(slot, cols, m)
    dev = slot.device
    if dev.type == "cpu":
        return group_accumulate_ref(slot, cols, m)
    if dev.type != "cuda":
        raise ValueError(f"group_accumulate: unsupported device {dev}")
    if any(t.data_ptr() % 16 for t in [slot] + cols):
        raise ValueError("the kernel's 16-byte loads need slot and cols "
                         "to start 16-byte aligned")
    n, ncols = slot.shape[0], len(cols)
    out = torch.zeros((ncols, m + 1), dtype=torch.int64, device=dev)
    if n == 0:
        return out.t()
    launch = _load()
    p = plan(n, ncols, m,
             torch.cuda.get_device_properties(dev).multi_processor_count)
    ptrs = (ctypes.c_void_p * ncols)(*[c.data_ptr() for c in cols])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = launch(slot.data_ptr(), ptrs, out.data_ptr(), n, ncols, m,
                    p.range_len, p.ranges, p.quads_per_chunk, p.chunks,
                    stream)
    if rc != 0:
        raise RuntimeError(f"group_accumulate launch failed: CUDA error {rc}")
    LAUNCHES["group_accumulate"] += 1
    return out.t()
