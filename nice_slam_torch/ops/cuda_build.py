"""Build the port's CUDA sources with nvcc into shared libraries with a plain
C interface, and load them with ctypes.

Each source under nice_slam_torch/csrc/ becomes one library, built at
first use into nice_slam_torch/_build/ (listed in .gitignore) and keyed on
a hash of the sources, the flags and the nvcc version, so a fresh checkout
builds everything it needs and a later process reuses the result.
`build_all` starts one nvcc per source together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

# sm_90a: Hopper with its architecture-specific features.  No fast-math:
# the decode's sin/cos arguments reach O(100).  -Xptxas -v puts each
# kernel's registers, shared memory and spills in the build log.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# library name -> its sources in csrc/
SOURCES: Dict[str, List[str]] = {
    "fused_decode": ["fused_decode.cu"],
    "fused_decode_bwd": ["fused_decode_bwd.cu"],
    "grid_scatter": ["grid_scatter.cu"],
}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME); the port's CUDA kernels are "
            "built from nice_slam_torch/csrc at first use")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in SOURCES[name]:
        h.update((CSRC / src).read_bytes())
    for dep in sorted(CSRC.glob("*.cuh")):
        h.update(dep.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start_build(name: str):
    """Start nvcc for `name` unless its library exists.  Returns
    (path, Popen or None, tmp path)."""
    out = _lib_path(name)
    if out.exists():
        return out, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ([nvcc_path()] + NVCC_FLAGS + ["-o", str(tmp)]
           + [str(CSRC / s) for s in SOURCES[name]])
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, proc, tmp


def build_all(names: Optional[List[str]] = None) -> Dict[str, str]:
    """Build every library (or `names`), one nvcc per library, all started
    together.  Returns {name: compiler output} (empty for cached builds);
    raises with the compiler output if a build fails."""
    started = {n: _start_build(n) for n in (names or list(SOURCES))}
    logs = {}
    for n, (out, proc, tmp) in started.items():
        if proc is None:
            logs[n] = ""
            continue
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {n}:\n{text}")
        os.replace(tmp, out)
        logs[n] = text
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library `name`, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            _loaded[name] = lib
        return lib

