"""Procedural RGB-D scene generator (numpy ray tracer).

There are no datasets bundled with this repo, so tests, the demo, and the
benchmark run on a deterministic synthetic scene: the interior of a box
room containing a few lambert-shaded spheres and a box, viewed from an
orbiting camera.  Depth is z-buffer depth (distance along the -z optical
axis), matching the sensor-depth convention the SLAM pipeline consumes.

This plays the role of the reference's Demo sequence (a 500-frame ScanNet
snippet): a small, fast, CPU-renderable end-to-end fixture.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np


@dataclass
class Sphere:
    center: np.ndarray
    radius: float
    albedo: np.ndarray


@dataclass
class Box:
    lo: np.ndarray
    hi: np.ndarray
    albedo: np.ndarray


@dataclass
class SyntheticScene:
    room_lo: np.ndarray
    room_hi: np.ndarray
    spheres: List[Sphere]
    boxes: List[Box]
    wall_albedo: np.ndarray
    light_dir: np.ndarray

    @staticmethod
    def default() -> "SyntheticScene":
        return SyntheticScene(
            room_lo=np.array([0.0, 0.0, 0.0]),
            room_hi=np.array([4.0, 3.0, 4.0]),
            spheres=[
                Sphere(np.array([1.0, 0.6, 1.2]), 0.6,
                       np.array([0.85, 0.25, 0.2])),
                Sphere(np.array([3.0, 0.8, 2.8]), 0.8,
                       np.array([0.2, 0.45, 0.85])),
                Sphere(np.array([2.0, 2.3, 3.2]), 0.4,
                       np.array([0.9, 0.8, 0.2])),
            ],
            boxes=[
                Box(np.array([2.2, 0.0, 0.6]), np.array([3.4, 1.1, 1.6]),
                    np.array([0.25, 0.75, 0.35])),
            ],
            wall_albedo=np.array([0.7, 0.68, 0.65]),
            light_dir=np.array([0.4, 0.8, 0.45]) / np.linalg.norm(
                [0.4, 0.8, 0.45]),
        )


def _sphere_hit(o, d, c, r):
    oc = o - c
    b = np.sum(oc * d, axis=-1)
    cterm = np.sum(oc * oc, axis=-1) - r * r
    disc = b * b - cterm
    ok = disc > 0
    sq = np.sqrt(np.maximum(disc, 0.0))
    t = -b - sq
    t = np.where(t > 1e-4, t, -b + sq)
    return np.where(ok & (t > 1e-4), t, np.inf)


def _box_hit(o, d, lo, hi):
    """Entry t of an axis-aligned box (exterior hit)."""
    inv = 1.0 / np.where(np.abs(d) < 1e-12, 1e-12, d)
    t0 = (lo - o) * inv
    t1 = (hi - o) * inv
    tmin = np.max(np.minimum(t0, t1), axis=-1)
    tmax = np.min(np.maximum(t0, t1), axis=-1)
    ok = (tmax > np.maximum(tmin, 1e-4))
    return np.where(ok, np.where(tmin > 1e-4, tmin, np.inf), np.inf), tmin, tmax


def _room_exit(o, d, lo, hi):
    """Exit t from inside the room box (interior walls)."""
    inv = 1.0 / np.where(np.abs(d) < 1e-12, 1e-12, d)
    t0 = (lo - o) * inv
    t1 = (hi - o) * inv
    return np.min(np.maximum(t0, t1), axis=-1)


def render_frame(scene: SyntheticScene, c2w: np.ndarray, H: int, W: int,
                 fx: float, fy: float, cx: float, cy: float):
    """Ray-trace one RGB-D frame.  Returns (color (H,W,3) float [0,1],
    depth (H,W) float z-depth)."""
    j, i = np.meshgrid(np.arange(H, dtype=np.float64),
                       np.arange(W, dtype=np.float64), indexing="ij")
    dirs = np.stack([(i - cx) / fx, -(j - cy) / fy, -np.ones_like(i)], -1)
    R = c2w[:3, :3]
    d = dirs @ R.T
    o = np.broadcast_to(c2w[:3, 3], d.shape)

    flat_o = o.reshape(-1, 3)
    flat_d = d.reshape(-1, 3)

    best_t = _room_exit(flat_o, flat_d, scene.room_lo, scene.room_hi)
    n_pix = flat_o.shape[0]
    # wall normals at exit point (pointing inward)
    hit = flat_o + best_t[:, None] * flat_d
    albedo = np.broadcast_to(scene.wall_albedo, (n_pix, 3)).copy()
    normal = np.zeros((n_pix, 3))
    for axis in range(3):
        at_lo = np.abs(hit[:, axis] - scene.room_lo[axis]) < 1e-6
        at_hi = np.abs(hit[:, axis] - scene.room_hi[axis]) < 1e-6
        normal[at_lo, axis] = 1.0
        normal[at_hi, axis] = -1.0
    nn = np.linalg.norm(normal, axis=-1, keepdims=True)
    normal = normal / np.where(nn == 0, 1.0, nn)

    for s in scene.spheres:
        t = _sphere_hit(flat_o, flat_d, s.center, s.radius)
        closer = t < best_t
        best_t = np.where(closer, t, best_t)
        p = flat_o + t[:, None] * flat_d
        nrm = (p - s.center) / s.radius
        albedo[closer] = s.albedo
        normal[closer] = nrm[closer]

    for b in scene.boxes:
        t, tmin, _ = _box_hit(flat_o, flat_d, b.lo, b.hi)
        closer = t < best_t
        best_t = np.where(closer, t, best_t)
        p = flat_o + t[:, None] * flat_d
        nrm = np.zeros_like(p)
        for axis in range(3):
            nrm[np.abs(p[:, axis] - b.lo[axis]) < 1e-6, axis] = -1.0
            nrm[np.abs(p[:, axis] - b.hi[axis]) < 1e-6, axis] = 1.0
        nl = np.linalg.norm(nrm, axis=-1, keepdims=True)
        nrm = nrm / np.where(nl == 0, 1.0, nl)
        albedo[closer] = b.albedo
        normal[closer] = nrm[closer]

    lambert = 0.35 + 0.65 * np.clip(normal @ scene.light_dir, 0, 1)
    color = np.clip(albedo * lambert[:, None], 0.0, 1.0)
    # z-buffer depth: distance along the camera's -z axis
    cam_fwd = -R[:, 2]
    zdepth = best_t * (flat_d @ cam_fwd)
    return (color.reshape(H, W, 3).astype(np.float32),
            zdepth.reshape(H, W).astype(np.float32))


def orbit_trajectory(scene: SyntheticScene, n_frames: int,
                     radius_frac: float = 0.28,
                     height_frac: float = 0.5,
                     sweep: Optional[float] = None) -> np.ndarray:
    """Smooth orbit inside the room looking at the room center.
    Returns (n, 4, 4) c2w with the -z forward convention.

    Default sweep keeps inter-frame motion realistic for frame-to-frame
    tracking (~1.1 deg / ~2 cm per frame, comparable to real RGB-D
    sequences), capped at 1.5 pi for long runs."""
    if sweep is None:
        sweep = min(0.02 * n_frames, 1.5 * np.pi)
    center = 0.5 * (scene.room_lo + scene.room_hi)
    size = scene.room_hi - scene.room_lo
    rad = radius_frac * min(size[0], size[2])
    poses = []
    for k in range(n_frames):
        a = sweep * k / max(n_frames - 1, 1)
        eye = center + np.array([rad * np.cos(a),
                                 (height_frac - 0.5) * size[1]
                                 + 0.12 * np.sin(2.1 * a),
                                 rad * np.sin(a)])
        look = center + np.array([0.35 * np.sin(0.7 * a), 0.0,
                                  0.35 * np.cos(0.9 * a)])
        fwd = look - eye
        fwd = fwd / np.linalg.norm(fwd)
        up = np.array([0.0, 1.0, 0.0])
        right = np.cross(fwd, up)
        right /= np.linalg.norm(right)
        up2 = np.cross(right, fwd)
        c2w = np.eye(4)
        # columns: x right, y up, z backward (-z forward)
        c2w[:3, 0] = right
        c2w[:3, 1] = up2
        c2w[:3, 2] = -fwd
        c2w[:3, 3] = eye
        poses.append(c2w)
    return np.stack(poses).astype(np.float32)
