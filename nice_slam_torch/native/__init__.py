"""Host (C++) kernels: the mesher's marching tetrahedra, the depth
rasterizer of the reconstruction evaluation (tools/eval_recon.py) and the
image codec of the dataset readers (utils/imageio.py).

`marching_cubes.cpp` and `rasterize.cpp` (the port's copies of the JAX
package's nice_slam_tpu/native/) are built together with g++ at the first
call (never at import) into one library under nice_slam_torch/_build/
(listed in .gitignore), keyed on a hash of both sources, the flags and the
host CPU's features, so a fresh checkout builds it and a later process on
the same machine reuses the library.  `imgcodec.cpp` (JPEG decode and
encode, PNG unfiltering) is a library of its own, built the same way
(`get_codec_lib`).  A failed build raises: at the
mesher's 256^3 volumes and the evaluation's 500x500 views of meshes of
~10^6 triangles the numpy versions would take hours (the JAX package's
rasterize_depth falls back to numpy instead,
nice_slam_tpu/native/__init__.py:210-222).  The numpy versions,
`_marching_tetrahedra_numpy` and `_rasterize_depth_numpy`, are the tests'
oracles.
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

_HERE = Path(__file__).resolve().parent
_SRCS = [_HERE / name for name in ("marching_cubes.cpp", "rasterize.cpp")]
_CODEC_SRCS = [_HERE / "imgcodec.cpp"]
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
# the JAX package's flags: with -march=native g++ contracts the vertex
# interpolation into FMAs, so both libraries give the same vertices
GXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_codec_lib: Optional[ctypes.CDLL] = None


def _host_cpu() -> bytes:
    """The host CPU's feature flags: -march=native builds for them, so a
    checkout shared by two machines builds one library for each."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            return next((line for line in f if line.startswith(b"flags")),
                        b"")
    except OSError:
        return platform.processor().encode()


def _lib_path(srcs=_SRCS, stem: str = "libnative") -> Path:
    h = hashlib.sha256()
    for src in srcs:
        h.update(src.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    h.update(_host_cpu())
    return BUILD_DIR / f"{stem}-{h.hexdigest()[:16]}.so"


def _build(out: Path, srcs=_SRCS) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    r = subprocess.run(["g++"] + GXX_FLAGS + ["-o", str(tmp)]
                       + [str(s) for s in srcs],
                       capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        raise RuntimeError(f"g++ failed for "
                           f"{', '.join(s.name for s in srcs)}:\n{r.stderr}")
    # concurrent builders each write their own file; the rename is atomic
    os.replace(tmp, out)


def get_codec_lib() -> ctypes.CDLL:
    """The loaded image codec library (imgcodec.cpp), built first if
    needed."""
    global _codec_lib
    with _lock:
        if _codec_lib is None:
            out = _lib_path(_CODEC_SRCS, "libimgcodec")
            if not out.exists():
                _build(out, _CODEC_SRCS)
            lib = ctypes.CDLL(str(out))
            u8p = ctypes.POINTER(ctypes.c_uint8)
            i32p = ctypes.POINTER(ctypes.c_int32)
            lib.jpeg_info.restype = ctypes.c_int
            lib.jpeg_info.argtypes = [u8p, ctypes.c_int64, i32p, i32p, i32p,
                                      ctypes.c_char_p, ctypes.c_int]
            lib.jpeg_decode.restype = ctypes.c_int
            lib.jpeg_decode.argtypes = [u8p, ctypes.c_int64, u8p,
                                        ctypes.c_int64, ctypes.c_char_p,
                                        ctypes.c_int]
            lib.jpeg_encode.restype = ctypes.c_int
            lib.jpeg_encode.argtypes = [
                u8p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, u8p,
                ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
                ctypes.c_char_p, ctypes.c_int]
            lib.png_unfilter.restype = ctypes.c_int
            lib.png_unfilter.argtypes = [
                u8p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int64,
                ctypes.c_int32, u8p, ctypes.c_char_p, ctypes.c_int]
            _codec_lib = lib
        return _codec_lib


def get_lib() -> ctypes.CDLL:
    """The loaded host library, built first if needed."""
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
            lib.raster_depth.restype = None
            lib.raster_depth.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                ctypes.c_int64, ctypes.c_float, ctypes.c_float,
                ctypes.c_float, ctypes.c_float, ctypes.c_float,
                ctypes.c_float, ctypes.POINTER(ctypes.c_float)]
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


# ---------------------------------------------------------------------------
# Depth rasterization (rasterize.cpp): the z-buffer triangle renderer of the
# 2D reconstruction evaluation (full-buffer depth L1 as the reference's
# Open3D offscreen renders, src/tools/eval_recon.py:153-204)

def rasterize_depth(verts: np.ndarray, tris: np.ndarray, c2w: np.ndarray,
                    H: int, W: int, fx: float, fy: float, cx: float,
                    cy: float, z_near: float = 0.01,
                    z_far: float = 20.0) -> np.ndarray:
    """Render the mesh's depth buffer from camera pose `c2w` (4x4)
    (nice_slam_tpu/native/__init__.py:191-222).

    Returns (H, W) f32 view-space depth; 0 where no geometry (as an Open3D
    depth capture).  Camera: x right, y up, -z forward."""
    verts = np.ascontiguousarray(verts, np.float32)
    tris = np.ascontiguousarray(tris, np.int64)
    w2c = np.ascontiguousarray(np.linalg.inv(np.asarray(c2w, np.float64)),
                               np.float32)
    out = np.zeros((H, W), np.float32)
    if not len(tris):
        return out
    lib = get_lib()
    fptr = ctypes.POINTER(ctypes.c_float)
    lib.raster_depth(
        verts.ctypes.data_as(fptr), len(verts),
        tris.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(tris),
        w2c.ctypes.data_as(fptr), H, W, ctypes.c_float(fx),
        ctypes.c_float(fy), ctypes.c_float(cx), ctypes.c_float(cy),
        ctypes.c_float(z_near), ctypes.c_float(z_far),
        out.ctypes.data_as(fptr))
    return out


def _rasterize_depth_numpy(verts, tris, w2c, H, W, fx, fy, cx, cy,
                           z_near, z_far):
    """numpy version, triangle by triangle (the tests' oracle;
    nice_slam_tpu/native/__init__.py:225-285)."""
    out = np.zeros((H, W), np.float32)
    if len(tris) == 0:
        return out
    cam = verts @ w2c[:3, :3].T + w2c[:3, 3]
    zcap = -z_near
    for t in range(len(tris)):
        c = cam[tris[t]]
        front = c[:, 2] < zcap
        if not front.any():
            continue
        # near-plane clip to a polygon
        poly = []
        for k in range(3):
            a, b = c[k], c[(k + 1) % 3]
            if front[k]:
                poly.append(a)
            if front[k] != front[(k + 1) % 3]:
                tt = (zcap - a[2]) / (b[2] - a[2])
                poly.append(a + tt * (b - a))
        if len(poly) < 3:
            continue
        fan = [(poly[0], poly[i], poly[i + 1])
               for i in range(1, len(poly) - 1)]
        for (p0, p1, p2) in fan:
            P = np.stack([p0, p1, p2])
            invd = -1.0 / P[:, 2]
            u = fx * P[:, 0] * invd + cx
            v = -fy * P[:, 1] * invd + cy
            area = ((u[1] - u[0]) * (v[2] - v[0])
                    - (u[2] - u[0]) * (v[1] - v[0]))
            if abs(area) < 1e-12:
                continue
            x0 = max(0, int(np.floor(u.min())))
            x1 = min(W - 1, int(np.ceil(u.max())))
            y0 = max(0, int(np.floor(v.min())))
            y1 = min(H - 1, int(np.ceil(v.max())))
            if x0 > x1 or y0 > y1:
                continue
            xs, ys = np.meshgrid(np.arange(x0, x1 + 1),
                                 np.arange(y0, y1 + 1))
            b0 = ((u[1] - xs) * (v[2] - ys)
                  - (u[2] - xs) * (v[1] - ys)) / area
            b1 = ((u[2] - xs) * (v[0] - ys)
                  - (u[0] - xs) * (v[2] - ys)) / area
            b2 = 1.0 - b0 - b1
            inside = (b0 >= 0) & (b1 >= 0) & (b2 >= 0)
            w_interp = b0 * invd[0] + b1 * invd[1] + b2 * invd[2]
            inside &= w_interp > 0
            if not inside.any():
                continue
            d = np.where(inside, 1.0 / np.maximum(w_interp, 1e-12), np.inf)
            d = np.where(d > z_far, np.inf, d)
            tile = out[y0:y1 + 1, x0:x1 + 1]
            cur = np.where(tile == 0.0, np.inf, tile)
            new = np.minimum(cur, d)
            out[y0:y1 + 1, x0:x1 + 1] = np.where(
                np.isfinite(new), new, 0.0).astype(np.float32)
    return out
