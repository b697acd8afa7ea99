"""The frame stream of a cell, made from --seed by one general generator
that reads a traffic file (benchmark/traffic/<name>.json) and the
configuration's scene.

Frozen torch copy of the repository's synthetic scene and numpy ray
caster (nice_slam_torch/utils/synthetic.py `render_frame`,
`orbit_trajectory`), held to them by benchmark/tests/test_bench_stream.py.
The orbit is made periodic (whole numbers of wobble cycles a turn, a
step of 2 pi / views) so the stream never runs out; the objects are
placed clear of the orbit from the traffic's fixed placement seed (the
work of a frame depends on the geometry it sees, so every seed gets the
same), and the seed jitters their colours (and picks the orbit's phase
where the traffic leaves it to the seed).  Frames are rendered on the
card in float64 and kept on the host as a dataset keeps them: colour as
8 bits, depth quantised to the configuration's png_depth_scale.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List

import numpy as np
import torch


@dataclass
class Scene:
    room_lo: np.ndarray
    room_hi: np.ndarray
    spheres: List[tuple]     # (center (3,), radius, albedo (3,))
    boxes: List[tuple]       # (lo (3,), hi (3,), albedo (3,))
    wall_albedo: np.ndarray
    light_dir: np.ndarray


def scene_from_dict(d: dict) -> Scene:
    light = np.asarray(d["light_dir"], np.float64)
    return Scene(
        room_lo=np.asarray(d["room_lo"], np.float64),
        room_hi=np.asarray(d["room_hi"], np.float64),
        spheres=[(np.asarray(s["center"], np.float64), float(s["radius"]),
                  np.asarray(s["albedo"], np.float64))
                 for s in d.get("spheres", [])],
        boxes=[(np.asarray(b["lo"], np.float64),
                np.asarray(b["hi"], np.float64),
                np.asarray(b["albedo"], np.float64))
               for b in d.get("boxes", [])],
        wall_albedo=np.asarray(d["wall_albedo"], np.float64),
        light_dir=light / np.linalg.norm(light))


def orbit_poses(scene: Scene, n: int, sweep: float, radius_frac=0.28,
                height_frac=0.5, eye_wobble=0.12, eye_cycles=2.1,
                look=0.35, look_x_cycles=0.7, look_z_cycles=0.9,
                phase: int = 0, period=None) -> np.ndarray:
    """(n, 4, 4) float32 camera-to-world poses (x right, y up, -z
    forward) on an orbit inside the room looking near its centre.  With
    `period` given, pose k sits at angle sweep * ((k + phase) % period) /
    period; else at sweep * k / (n - 1), as `orbit_trajectory`."""
    center = 0.5 * (scene.room_lo + scene.room_hi)
    size = scene.room_hi - scene.room_lo
    rad = radius_frac * min(size[0], size[2])
    poses = []
    for k in range(n):
        if period is None:
            a = sweep * k / max(n - 1, 1)
        else:
            a = sweep * ((k + phase) % period) / period
        eye = center + np.array([rad * np.cos(a),
                                 (height_frac - 0.5) * size[1]
                                 + eye_wobble * np.sin(eye_cycles * a),
                                 rad * np.sin(a)])
        tgt = center + np.array([look * np.sin(look_x_cycles * a), 0.0,
                                 look * np.cos(look_z_cycles * a)])
        fwd = tgt - eye
        fwd = fwd / np.linalg.norm(fwd)
        up = np.array([0.0, 1.0, 0.0])
        right = np.cross(fwd, up)
        right /= np.linalg.norm(right)
        up2 = np.cross(right, fwd)
        c2w = np.eye(4)
        c2w[:3, 0] = right
        c2w[:3, 1] = up2
        c2w[:3, 2] = -fwd
        c2w[:3, 3] = eye
        poses.append(c2w)
    return np.stack(poses).astype(np.float32)


def _sphere_hit(o, d, c, r):
    oc = o - c
    b = torch.sum(oc * d, dim=-1)
    cterm = torch.sum(oc * oc, dim=-1) - r * r
    disc = b * b - cterm
    ok = disc > 0
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t = -b - sq
    t = torch.where(t > 1e-4, t, -b + sq)
    return torch.where(ok & (t > 1e-4), t, torch.full_like(t, math.inf))


def _box_hit(o, d, lo, hi):
    inv = 1.0 / torch.where(torch.abs(d) < 1e-12,
                            torch.full_like(d, 1e-12), d)
    t0 = (lo - o) * inv
    t1 = (hi - o) * inv
    tmin = torch.amax(torch.minimum(t0, t1), dim=-1)
    tmax = torch.amin(torch.maximum(t0, t1), dim=-1)
    ok = tmax > torch.clamp(tmin, min=1e-4)
    inf = torch.full_like(tmin, math.inf)
    return torch.where(ok, torch.where(tmin > 1e-4, tmin, inf), inf)


def render_views(scene: Scene, c2w: torch.Tensor, H: int, W: int, fx, fy,
                 cx, cy):
    """Ray-trace views (V, 4, 4) float64 on c2w's device: the numpy
    `render_frame`'s arithmetic in torch.  Returns colour (V, H, W, 3) and
    z-depth (V, H, W), float64."""
    dev, f64 = c2w.device, torch.float64

    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=f64, device=dev)

    j, i = torch.meshgrid(torch.arange(H, dtype=f64, device=dev),
                          torch.arange(W, dtype=f64, device=dev),
                          indexing="ij")
    dirs = torch.stack([(i - cx) / fx, -(j - cy) / fy, -torch.ones_like(i)],
                       -1).reshape(-1, 3)
    V = c2w.shape[0]
    R = c2w[:, :3, :3]
    d = torch.einsum("pk,vmk->vpm", dirs, R).reshape(-1, 3)
    o = c2w[:, None, :3, 3].expand(V, H * W, 3).reshape(-1, 3)
    lo, hi = t(scene.room_lo), t(scene.room_hi)
    inv = 1.0 / torch.where(torch.abs(d) < 1e-12, torch.full_like(d, 1e-12),
                            d)
    best = torch.amin(torch.maximum((lo - o) * inv, (hi - o) * inv), dim=-1)
    hit = o + best[:, None] * d
    albedo = t(scene.wall_albedo).expand(o.shape[0], 3).clone()
    normal = torch.zeros_like(o)
    for axis in range(3):
        normal[torch.abs(hit[:, axis] - lo[axis]) < 1e-6, axis] = 1.0
        normal[torch.abs(hit[:, axis] - hi[axis]) < 1e-6, axis] = -1.0
    nn = torch.linalg.norm(normal, dim=-1, keepdim=True)
    normal = normal / torch.where(nn == 0, torch.ones_like(nn), nn)
    for c, r, alb in scene.spheres:
        tt = _sphere_hit(o, d, t(c), r)
        closer = tt < best
        best = torch.where(closer, tt, best)
        p = o + tt[:, None] * d
        albedo[closer] = t(alb)
        normal[closer] = ((p - t(c)) / r)[closer]
    for blo, bhi, alb in scene.boxes:
        tt = _box_hit(o, d, t(blo), t(bhi))
        closer = tt < best
        best = torch.where(closer, tt, best)
        p = o + tt[:, None] * d
        nrm = torch.zeros_like(p)
        for axis in range(3):
            nrm[torch.abs(p[:, axis] - blo[axis]) < 1e-6, axis] = -1.0
            nrm[torch.abs(p[:, axis] - bhi[axis]) < 1e-6, axis] = 1.0
        nl = torch.linalg.norm(nrm, dim=-1, keepdim=True)
        nrm = nrm / torch.where(nl == 0, torch.ones_like(nl), nl)
        albedo[closer] = t(alb)
        normal[closer] = nrm[closer]
    lam = 0.35 + 0.65 * torch.clamp(normal @ t(scene.light_dir), 0, 1)
    color = torch.clamp(albedo * lam[:, None], 0.0, 1.0)
    fwd = -R[:, :, 2]                                        # (V, 3)
    z = best.reshape(V, H * W) * torch.einsum(
        "vpm,vm->vp", d.reshape(V, H * W, 3), fwd)
    return color.reshape(V, H, W, 3), z.reshape(V, H, W)


def _dist_to_box(p, lo, hi):
    q = np.maximum(np.maximum(lo - p, 0.0), p - hi)
    return np.linalg.norm(q, axis=-1)


def place_objects(template: Scene, eyes: np.ndarray, rng, colour_rng,
                  clearance: float, albedo_jitter: float,
                  tries: int = 5000) -> Scene:
    """The template's objects, the largest sphere first, each moved in x
    and z to a place drawn from `rng` inside the room where no orbit eye
    comes within `clearance` of it and it meets no object placed before;
    heights, sizes and kinds stay.  Albedos are jittered by up to
    `albedo_jitter`, drawn from `colour_rng`."""
    lo, hi = template.room_lo, template.room_hi
    placed_spheres, placed_boxes = [], []

    def free(center, radius, box=None):
        if box is not None:
            gap = _dist_to_box(eyes, *box).min()
            ok = gap > clearance
            others = [_dist_to_box(c, *box) - r for c, r, _ in
                      placed_spheres]
        else:
            ok = np.linalg.norm(eyes - center, axis=-1).min() > (
                radius + clearance)
            others = [np.linalg.norm(c - center) - r - radius
                      for c, r, _ in placed_spheres]
            others += [_dist_to_box(center, b0, b1) - radius
                       for b0, b1, _ in placed_boxes]
        return ok and all(o > 0.05 for o in others)

    def jitter(alb):
        return np.clip(alb + colour_rng.uniform(-albedo_jitter,
                                                albedo_jitter, 3), 0.05, 0.95)

    for c, r, alb in sorted(template.spheres, key=lambda s: -s[1]):
        for _ in range(tries):
            x = rng.uniform(lo[0] + r + 0.05, hi[0] - r - 0.05)
            z = rng.uniform(lo[2] + r + 0.05, hi[2] - r - 0.05)
            cand = np.array([x, c[1], z])
            if free(cand, r):
                placed_spheres.append((cand, r, jitter(alb)))
                break
        else:
            raise RuntimeError("no free place for a sphere of the scene")
    for b0, b1, alb in template.boxes:
        ext = b1 - b0
        for _ in range(tries):
            x = rng.uniform(lo[0] + 0.05, hi[0] - ext[0] - 0.05)
            z = rng.uniform(lo[2] + 0.05, hi[2] - ext[2] - 0.05)
            nlo = np.array([x, b0[1], z])
            box = (nlo, nlo + ext)
            if free(None, 0.0, box=box) and all(
                    _dist_to_box(c, *box) - r > 0.05
                    for c, r, _ in placed_spheres):
                placed_boxes.append((box[0], box[1], jitter(alb)))
                break
        else:
            raise RuntimeError("no free place for a box of the scene")
    return Scene(lo, hi, placed_spheres, placed_boxes,
                 template.wall_albedo, template.light_dir)


class FrameStream:
    """The views of one cell: colour (V, H, W, 3) uint8 and depth (V, H, W)
    float32 on the host, poses (V, 4, 4) float32; frame idx is view
    idx % V."""

    def __init__(self, colors, depths, poses):
        self.colors, self.depths, self.poses = colors, depths, poses

    def __len__(self):
        return self.poses.shape[0]

    def frame(self, idx: int):
        """(colour float32 in [0, 1], depth float32, pose) of frame idx,
        as a dataset reader hands them."""
        v = idx % len(self)
        return (self.colors[v].astype(np.float32) / np.float32(255.0),
                self.depths[v], self.poses[v])


def make_stream(traffic: dict, scene_dict: dict, cam: dict, seed: int,
                device) -> FrameStream:
    """Render the cell's closed orbit on `device`.  The objects' places come
    from the traffic's fixed `placement_seed`, so every seed renders the
    same geometry and the same work; `seed` picks the objects' colours and,
    where the traffic's `phase` is "seed", the orbit's phase (the view of
    frame 0), else the phase is that number.  `cam`: H, W, fx, fy, cx, cy
    as the engine sees the frames, and png_depth_scale."""
    if traffic["generator"] != "orbit":
        raise ValueError(f"unknown generator {traffic['generator']!r}")
    rng = np.random.default_rng(seed)
    views = int(traffic["views"])
    phase = int(rng.integers(views))
    if traffic["phase"] != "seed":
        phase = int(traffic["phase"])
    template = scene_from_dict(scene_dict)
    kw = dict(radius_frac=traffic["radius_frac"],
              height_frac=traffic["height_frac"],
              eye_wobble=traffic["eye_wobble_m"],
              eye_cycles=traffic["eye_wobble_cycles"],
              look=traffic["look_offset_m"],
              look_x_cycles=traffic["look_x_cycles"],
              look_z_cycles=traffic["look_z_cycles"])
    poses = orbit_poses(template, views, 2 * np.pi, phase=phase,
                        period=views, **kw)
    scene = place_objects(template, poses[:, :3, 3].astype(np.float64),
                          np.random.default_rng(traffic["placement_seed"]),
                          rng, traffic["object_clearance_m"],
                          traffic["albedo_jitter"])
    H, W = int(cam["H"]), int(cam["W"])
    scale = float(cam["png_depth_scale"])
    colors = np.empty((views, H, W, 3), np.uint8)
    depths = np.empty((views, H, W), np.float32)
    step = int(traffic["render_chunk_views"])
    c2w_all = torch.as_tensor(poses, dtype=torch.float64, device=device)
    for s in range(0, views, step):
        col, z = render_views(scene, c2w_all[s:s + step], H, W, cam["fx"],
                              cam["fy"], cam["cx"], cam["cy"])
        # the dataset's files: 8-bit colour, 16-bit depth at the scale
        colors[s:s + step] = torch.floor(col * 255.0).to(
            torch.uint8).cpu().numpy()
        q = torch.floor(z * scale).clamp(0, 65535)
        depths[s:s + step] = (q.to(torch.float32) / scale).cpu().numpy()
    return FrameStream(colors, depths, poses)
