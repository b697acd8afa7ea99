"""Host (C++) iso-surface extraction for the mesher: marching tetrahedra.

`marching_cubes.cpp` is built with g++ at the first call (never at import)
into nice_slam_torch/_build/ (listed in .gitignore), keyed on a hash of
the source, the flags and the host CPU's features, so a fresh checkout
builds it and a later process on the same machine reuses the library.  A failed build raises: at the mesher's
256^3 volumes the numpy version would take hours.  The numpy version,
`_marching_tetrahedra_numpy`, is the tests' oracle.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parent / "marching_cubes.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
# the JAX package's flags: with -march=native g++ contracts the vertex
# interpolation into FMAs, so both libraries give the same vertices
GXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _host_cpu() -> bytes:
    """The host CPU's feature flags: -march=native builds for them, so a
    checkout shared by two machines builds one library for each."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            return next((line for line in f if line.startswith(b"flags")),
                        b"")
    except OSError:
        return platform.processor().encode()


def _lib_path() -> Path:
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    h.update(_host_cpu())
    return BUILD_DIR / f"libmarching-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    r = subprocess.run(["g++"] + GXX_FLAGS + ["-o", str(tmp), str(_SRC)],
                       capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        raise RuntimeError(f"g++ failed for {_SRC.name}:\n{r.stderr}")
    # concurrent builders each write their own file; the rename is atomic
    os.replace(tmp, out)


def get_lib() -> ctypes.CDLL:
    """The loaded marching-tetrahedra library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            out = _lib_path()
            if not out.exists():
                _build(out)
            lib = ctypes.CDLL(str(out))
            lib.mt_run.restype = ctypes.c_void_p
            lib.mt_run.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_float,
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_float)]
            lib.mt_nverts.restype = ctypes.c_int64
            lib.mt_nverts.argtypes = [ctypes.c_void_p]
            lib.mt_ntris.restype = ctypes.c_int64
            lib.mt_ntris.argtypes = [ctypes.c_void_p]
            lib.mt_get.restype = None
            lib.mt_get.argtypes = [ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_float),
                                   ctypes.POINTER(ctypes.c_int64)]
            lib.mt_free.restype = None
            lib.mt_free.argtypes = [ctypes.c_void_p]
            _lib = lib
        return _lib


def marching_tetrahedra(volume: np.ndarray, iso: float,
                        origin, spacing) -> Tuple[np.ndarray, np.ndarray]:
    """Extract the iso-surface of volume (nx, ny, nz) at `iso`.

    Surface lies where the field crosses `iso` ("inside" = value > iso).
    Returns (verts (V,3) f32 world coords, tris (T,3) int64)."""
    volume = np.ascontiguousarray(volume, np.float32)
    if volume.ndim != 3:
        raise ValueError(f"volume must be 3-D, got shape {volume.shape}")
    origin = np.ascontiguousarray(origin, np.float32).reshape(3)
    spacing = np.ascontiguousarray(spacing, np.float32).reshape(3)
    lib = get_lib()
    fptr = ctypes.POINTER(ctypes.c_float)
    h = lib.mt_run(volume.ctypes.data_as(fptr), volume.shape[0],
                   volume.shape[1], volume.shape[2], ctypes.c_float(iso),
                   origin.ctypes.data_as(fptr), spacing.ctypes.data_as(fptr))
    try:
        nv = lib.mt_nverts(h)
        nt = lib.mt_ntris(h)
        verts = np.empty((nv, 3), np.float32)
        tris = np.empty((nt, 3), np.int64)
        if nv:
            lib.mt_get(h, verts.ctypes.data_as(fptr),
                       tris.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        return verts, tris
    finally:
        lib.mt_free(h)


# ---------------------------------------------------------------------------
# numpy version (same tetrahedral decomposition; the tests' oracle)

_TETS = np.array([[0, 5, 1, 7], [0, 1, 3, 7], [0, 3, 2, 7],
                  [0, 2, 6, 7], [0, 6, 4, 7], [0, 4, 5, 7]])
_CORNER_OFF = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0],
                        [0, 0, 1], [1, 0, 1], [0, 1, 1], [1, 1, 1]])


def _marching_tetrahedra_numpy(vol, iso, origin, spacing):
    nx, ny, nz = vol.shape
    inside = vol > iso

    # global corner ids per cube corner: (8, nx-1, ny-1, nz-1)
    X, Y, Z = np.meshgrid(np.arange(nx - 1), np.arange(ny - 1),
                          np.arange(nz - 1), indexing="ij")
    corner_gid = np.stack([
        ((X + ox) * ny + (Y + oy)) * nz + (Z + oz)
        for ox, oy, oz in _CORNER_OFF])  # (8, ...)
    corner_in = inside.reshape(-1)[corner_gid]

    edges = {}
    verts = []
    tris = []
    flat_vol = vol.reshape(-1).astype(np.float64)

    def edge_vertex(ga, gb):
        if ga > gb:
            ga, gb = gb, ga
        k = (ga, gb)
        vid = edges.get(k)
        if vid is not None:
            return vid
        va, vb = flat_vol[ga], flat_vol[gb]
        t = 0.5 if vb == va else np.clip((iso - va) / (vb - va), 0.0, 1.0)
        az, ay, ax = ga % nz, (ga // nz) % ny, ga // (nz * ny)
        bz, by, bx = gb % nz, (gb // nz) % ny, gb // (nz * ny)
        p = (origin + spacing * np.array([ax + t * (bx - ax),
                                          ay + t * (by - ay),
                                          az + t * (bz - az)]))
        vid = len(verts)
        verts.append(p)
        edges[k] = vid
        return vid

    # only cubes with a crossing
    any_in = corner_in.any(axis=0)
    any_out = (~corner_in).any(axis=0)
    active = np.argwhere(any_in & any_out)
    cg_flat = corner_gid.reshape(8, -1)
    shape3 = (nx - 1, ny - 1, nz - 1)
    for (cx, cy, cz) in active:
        lin = (cx * shape3[1] + cy) * shape3[2] + cz
        cg = cg_flat[:, lin]
        for tet in _TETS:
            g = cg[tet]
            tin = flat_vol[g] > iso
            s = int(tin.sum())
            if s == 0 or s == 4:
                continue
            pick = s <= 2
            lone = [i for i in range(4) if tin[i] == pick]
            other = [i for i in range(4) if tin[i] != pick]
            if len(lone) == 1:
                a = edge_vertex(g[lone[0]], g[other[0]])
                b = edge_vertex(g[lone[0]], g[other[1]])
                c = edge_vertex(g[lone[0]], g[other[2]])
                if len({a, b, c}) == 3:
                    tris.append((a, b, c))
            else:
                a = edge_vertex(g[lone[0]], g[other[0]])
                b = edge_vertex(g[lone[0]], g[other[1]])
                c = edge_vertex(g[lone[1]], g[other[1]])
                d = edge_vertex(g[lone[1]], g[other[0]])
                if len({a, b, c}) == 3:
                    tris.append((a, b, c))
                if len({a, c, d}) == 3:
                    tris.append((a, c, d))

    verts = (np.asarray(verts, np.float32) if verts
             else np.zeros((0, 3), np.float32))
    tris = (np.asarray(tris, np.int64) if tris
            else np.zeros((0, 3), np.int64))
    return verts, tris
