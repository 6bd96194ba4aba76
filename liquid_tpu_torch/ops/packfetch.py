"""Bit-packed device-to-host fetch of same-width result columns (port of
`liquid_tpu/ops/packfetch.py`).

A large grouped result crosses to the host in two bounded transfers
instead of one per column: a per-column [min, max] header, from which the
host derives each column's bit-width, then ONE buffer of every narrow
column's bit-planes (`v - min` at that width) plus one stacked raw int64
matrix for the incompressible columns (f64 bit images).  The host decodes
with `bitpack.unpack_bitplanes_host`.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from liquid_tpu_torch.ops import bitpack as bp
from liquid_tpu_torch.ops import floatbits
from liquid_tpu_torch.ops.mask import pack_bools

#: below this raw-byte estimate the plain per-column fetch is used
MIN_PACK_BYTES = 1 << 21

#: a column whose bucketed width reaches this rides the raw int64 stack
RAW_WIDTH = 56

#: bytes a raw fetch would have moved vs what crossed
STATS = {"fetches": 0, "packed_fetches": 0, "raw_bytes": 0,
         "wire_bytes": 0}


def _as_i64_image(x: torch.Tensor):
    """Reversible int64 bit image of a device column, and its tag."""
    if x.dtype == torch.float64:
        return floatbits.f64_bits(x), "f64"
    if x.dtype == torch.bool:
        return x.to(torch.int64), "bool"
    return x.to(torch.int64), "i64"


def _from_i64_image(v: np.ndarray, tag: str) -> np.ndarray:
    if tag == "f64":
        return v.view(np.float64)
    if tag == "bool":
        return v.astype(bool)
    return v


def _minmax(mat: torch.Tensor, g: int) -> torch.Tensor:
    live = torch.arange(mat.shape[1], device=mat.device) < g
    big = 1 << 62
    mn = torch.where(live, mat, torch.full_like(mat, big)).amin(1)
    mx = torch.where(live, mat, torch.full_like(mat, -big)).amax(1)
    return torch.stack([mn, mx], 1)


def _pack_planes(mat: torch.Tensor, widths, mins: torch.Tensor,
                 g: int) -> torch.Tensor:
    """mat [c, w2] int64 -> int32 words of the concatenated planes of the
    columns that are neither empty (width 0) nor raw."""
    live = torch.arange(mat.shape[1], device=mat.device) < g
    planes = []
    for i, w in enumerate(widths):
        if w == 0 or w >= RAW_WIDTH:
            continue
        v = torch.where(live, mat[i], mins[i]) - mins[i]  # in [0, 2^56)
        planes += [pack_bools(((v >> b) & 1).to(torch.bool))
                   for b in range(w)]
    if not planes:
        return torch.zeros((0, mat.shape[1] // 32), dtype=torch.int32,
                           device=mat.device)
    return torch.stack(planes)


def fetch_columns(cols: Sequence[torch.Tensor], g: int) -> List[np.ndarray]:
    """Fetch same-width device columns bit-packed -> full-width numpy
    arrays in each column's original dtype (the caller slices [:g]).
    Small payloads, widths that are not a multiple of 32 and g <= 0 take
    the plain per-column fetch."""
    cols = list(cols)
    if not cols:
        return []
    w2 = int(cols[0].shape[0])
    raw_bytes = len(cols) * w2 * 8
    STATS["fetches"] += 1
    STATS["raw_bytes"] += raw_bytes
    if raw_bytes < MIN_PACK_BYTES or w2 % 32 or g <= 0:
        STATS["wire_bytes"] += raw_bytes
        return [c.cpu().numpy() for c in cols]
    imgs, tags = zip(*[_as_i64_image(c) for c in cols])
    mat = torch.stack(imgs)
    hdr = _minmax(mat, g).cpu().numpy()
    mins = hdr[:, 0]
    widths = []
    for i in range(len(cols)):
        span = int(hdr[i, 1]) - int(mins[i])
        if span < 0 or span >= (1 << (RAW_WIDTH - 1)):
            widths.append(RAW_WIDTH)  # no live rows, or full entropy
            continue
        widths.append(bp.bucket_for(bp.bit_width_for(span)))
    raw_ix = [i for i, w in enumerate(widths) if w >= RAW_WIDTH]
    packed = _pack_planes(mat, widths, torch.from_numpy(mins).to(mat.device),
                          g).cpu().numpy().view(np.uint32)
    raws = mat[raw_ix].cpu().numpy() if raw_ix \
        else np.zeros((0, w2), np.int64)
    STATS["packed_fetches"] += 1
    STATS["wire_bytes"] += hdr.nbytes + packed.nbytes + raws.nbytes
    out: List[np.ndarray] = []
    row = ri = 0
    for i, w in enumerate(widths):
        if w >= RAW_WIDTH:
            v = raws[ri]
            ri += 1
        elif w == 0:
            v = np.full(w2, mins[i], np.int64)
        else:
            u = bp.unpack_bitplanes_host(packed[row:row + w])
            row += w
            v = u.astype(np.int64) + mins[i]
        out.append(_from_i64_image(np.ascontiguousarray(v), tags[i]))
    return out
