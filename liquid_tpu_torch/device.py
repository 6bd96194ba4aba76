"""Device policy and the word-level bit helpers every layer shares.

Device: entry points run on CUDA unless the caller names another device.
`resolve_device(None)` raises when there is no card -- the port never
quietly picks the CPU.  Tests pass ``"cpu"`` explicitly.

Words: the reference keeps masks and bit-planes as uint32 words
(`liquid_tpu/ops/bitpack.py:35-37`).  PyTorch refuses `~` and `>>` on
uint32, so the port holds the SAME BITS in int32 tensors.  `&`, `|`, `^`
and `~` are bit-identical on either type; a right shift must be logical
(shift, then mask), and popcount is SWAR arithmetic.  u64 constants ride
as their int64 bit image.
"""
from __future__ import annotations

import numpy as np
import torch

WORD_BITS = 32
#: int32 with all 32 bits set (the reference's 0xFFFFFFFF word)
FULL = -1


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA by default; raises when
    CUDA was asked for (explicitly or by default) and there is none."""
    if device is None:
        device = "cuda"
    d = torch.device(device)
    if d.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: liquid_tpu_torch runs on the GPU by default; "
            "pass device='cpu' to run on the CPU")
    if d.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {d}")
    return d


def words_to_tensor(a: np.ndarray, device=None) -> torch.Tensor:
    """numpy uint32 words -> int32 tensor with the same bits."""
    a = np.ascontiguousarray(a, dtype=np.uint32)
    if not a.flags.writeable:  # a cached constant: torch wants its own
        a = a.copy()
    t = torch.from_numpy(a.view(np.int32))
    return t if device is None else t.to(device)


def words_to_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 word tensor -> numpy uint32 with the same bits."""
    assert t.dtype == torch.int32, t.dtype
    return t.detach().cpu().contiguous().numpy().view(np.uint32)


def u64_to_i64(v) -> np.ndarray:
    """numpy uint64 (or Python ints in [0, 2^64)) -> int64 bit images."""
    return np.asarray(v, dtype=np.uint64).view(np.int64)


def wrap_i64(v: int) -> int:
    """Python int -> the int64 with the same low 64 bits."""
    v %= 1 << 64
    return v - (1 << 64) if v >= (1 << 63) else v


def srl(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of an int32/int64 bit image by a static k."""
    bits = 32 if x.dtype == torch.int32 else 64
    assert x.dtype in (torch.int32, torch.int64), x.dtype
    if k == 0:
        return x
    if k >= bits:
        return torch.zeros_like(x)
    return (x >> k) & ((1 << (bits - k)) - 1)


def to_i32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 holding values in [0, 2^32) -> int32 with the same low bits
    (explicit wrap; a narrowing cast of out-of-range values is not
    relied on)."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits per int32 word (SWAR), as int32.  Runs in int64 so no
    intermediate overflows."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) >> 24 & 0xFF).to(torch.int32)
