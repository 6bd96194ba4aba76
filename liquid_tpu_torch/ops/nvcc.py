"""Build and load the port's hand-written CUDA kernels.

Each kernel is one `csrc/*.cu` source with a plain C launch function.  On
first use the source is compiled with nvcc into `_build/` next to this
package, keyed by a hash of source and flags, and loaded with ctypes.
`build_many` starts one nvcc per source, all at once, so a cold start
waits for the slowest build only.  Nothing is built at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Sequence

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                       "build the port's kernels")


def library_path(source: str) -> str:
    """Where the library built from `source` lives (keyed by source and
    flags)."""
    with open(source, "rb") as f:
        h = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(BUILD_DIR, f"{stem}_{h.hexdigest()[:16]}.so")


def build_many(sources: Sequence[str], verbose: bool = False
               ) -> Dict[str, str]:
    """Compile every source not built yet, one nvcc each, started
    together -> {source: library path}.  Raises with nvcc's output if a
    build fails."""
    out = {s: library_path(s) for s in sources}
    todo = [s for s in sources if not os.path.exists(out[s])]
    if not todo:
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for s in todo:
        tmp = f"{out[s]}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, s]
        procs.append((s, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for s, tmp, proc in procs:
        so, se = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{os.path.basename(s)}: nvcc failed "
                          f"({proc.returncode}):\n{so}\n{se}")
            continue
        if verbose:
            print(f"[nvcc] {os.path.basename(s)}\n{se.strip()}", flush=True)
        os.replace(tmp, out[s])
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def build(source: str, verbose: bool = False) -> str:
    """Compile `source` if it has not been built yet -> library path."""
    return build_many([source], verbose)[source]


def load(source: str) -> ctypes.CDLL:
    """The loaded library of `source`, built on first use."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            lib = _libs[source] = ctypes.CDLL(build(source))
    return lib
