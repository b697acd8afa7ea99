"""Keyframe store on the device + keyframe window selection
(src/Mapper.py:166-287), as in the JAX package:

- the store is a fixed-capacity ring (uint8 colour, fp32 depth, poses);
- 'overlap' selection samples rays from the current frame, lifts 16
  depth-guided samples, projects them into every stored keyframe, and
  takes a random subset of the keyframes that see any of them;
- 'global' selection is a uniform random subset (the coarse mapper's).
Random draws come from a `torch.Generator` or are passed in, so tests can
feed both packages the same draws.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from nice_slam_torch.camera import Camera
from nice_slam_torch.ops.consts import const
from nice_slam_torch.ops.rays import gather_pixels, rays_from_uv, sample_pixels


@dataclass
class KeyframeStore:
    """colors: (K, H, W, 3) uint8; depths: (K, H, W) fp32; est_c2w/gt_c2w:
    (K, 4, 4); frame_idx: (K,) int64 (-1 = empty); count: stored so far."""
    colors: torch.Tensor
    depths: torch.Tensor
    est_c2w: torch.Tensor
    gt_c2w: torch.Tensor
    frame_idx: torch.Tensor
    count: int = 0

    @property
    def capacity(self) -> int:
        return self.colors.shape[0]


def make_store(capacity: int, H: int, W: int,
               device="cuda") -> KeyframeStore:
    eye = torch.eye(4, device=device).expand(capacity, 4, 4).clone()
    return KeyframeStore(
        colors=torch.zeros(capacity, H, W, 3, dtype=torch.uint8,
                           device=device),
        depths=torch.zeros(capacity, H, W, device=device),
        est_c2w=eye, gt_c2w=eye.clone(),
        frame_idx=torch.full((capacity,), -1, dtype=torch.int64,
                             device=device),
        count=0)


@torch.no_grad()
def add_keyframe(store: KeyframeStore, color, depth, est_c2w, gt_c2w,
                 frame_idx: int) -> None:
    """Append a keyframe in place (colour in [0, 1] -> uint8,
    round-half-up)."""
    i = store.count
    store.colors[i] = torch.clamp(color * 255.0 + 0.5, 0, 255).to(torch.uint8)
    store.depths[i] = depth
    store.est_c2w[i] = est_c2w
    store.gt_c2w[i] = gt_c2w
    store.frame_idx[i] = frame_idx
    store.count = i + 1


@torch.no_grad()
def update_poses(store: KeyframeStore, slots, new_c2w, mask) -> None:
    """Write BA-refined poses back in place for `slots` where mask is True."""
    cur = store.est_c2w[slots]
    store.est_c2w[slots] = torch.where(mask[:, None, None], new_c2w, cur)


def se3_inverse(c2w: torch.Tensor) -> torch.Tensor:
    """Analytic inverse of a rigid 4x4 transform."""
    R = c2w[..., :3, :3]
    t = c2w[..., :3, 3]
    Rt = R.transpose(-1, -2)
    ti = -(Rt @ t[..., None])[..., 0]
    top = torch.cat([Rt, ti[..., None]], dim=-1)
    bottom = const([0.0, 0.0, 0.0, 1.0], c2w.dtype, c2w.device).expand(
        top.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def project_points(pts: torch.Tensor, c2w: torch.Tensor, camera: Camera):
    """Project world points into a camera.  Returns (u, v, z) with z < 0 in
    front (the -z forward convention; Mapper.py:198-216)."""
    w2c = se3_inverse(c2w)
    ph = torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)
    pc = ph @ w2c.transpose(-1, -2)
    x, y, z = -pc[..., 0], pc[..., 1], pc[..., 2]
    zs = z + 1e-5
    u = camera.fx * x / zs + camera.cx
    v = camera.fy * y / zs + camera.cy
    return u, v, z


@torch.no_grad()
def select_keyframes_overlap(store: KeyframeStore, gt_depth, cur_c2w,
                             camera: Camera, k: int,
                             gen: Optional[torch.Generator] = None,
                             n_samples: int = 16, n_pixels: int = 100,
                             pix=None, scores_u=None):
    """Rank stored keyframes by view overlap with the current frame and pick
    a random subset of size <= k of those with overlap > 0.  `pix` = (i, j)
    and `scores_u` (capacity,) uniforms are drawn from `gen` unless given.

    Returns (slots (k,) int64, valid (k,) bool)."""
    i, j = pix if pix is not None else sample_pixels(
        gen, n_pixels, 0, camera.H, 0, camera.W)
    rays_o, rays_d = rays_from_uv(i, j, cur_c2w, camera.fx, camera.fy,
                                  camera.cx, camera.cy)
    d = gather_pixels(gt_depth, i, j)[:, None]
    t = torch.linspace(0.0, 1.0, n_samples, device=d.device)
    z = (d * 0.8) * (1.0 - t) + (d + 0.5) * t
    pts = (rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]).reshape(
        -1, 3)
    # every slot's projection at once: (K, P*S)
    u, v, zc = project_points(pts, store.est_c2w, camera)
    edge = 20
    m = ((u < camera.W - edge) & (u > edge) & (v < camera.H - edge)
         & (v > edge) & (zc < 0))
    percents = torch.mean(m.to(torch.float32), dim=-1)
    slot_ids = torch.arange(store.capacity, device=d.device)
    # the most recent keyframe joins the window anyway (the reference
    # selects among keyframe_dict[:-1], Mapper.py:265-270)
    qualify = (slot_ids < store.count - 1) & (percents > 0.0)
    if scores_u is None:
        scores_u = torch.rand(store.capacity, generator=gen, device=d.device)
    scores = torch.where(qualify, scores_u, torch.full_like(scores_u, -1.0))
    return _topk_slots(scores, k, store.capacity)


def _topk_slots(scores, k: int, capacity: int):
    """top-k slots by score with k possibly above the capacity (tiny
    scenes): the overflow is padded with invalid slots."""
    k_eff = min(k, capacity)
    _, slots = torch.topk(scores, k_eff)
    valid = scores[slots] > 0.0
    if k_eff < k:
        slots = torch.cat([slots, torch.zeros(k - k_eff, dtype=slots.dtype,
                                              device=slots.device)])
        valid = torch.cat([valid, torch.zeros(k - k_eff, dtype=torch.bool,
                                              device=valid.device)])
    return slots, valid


@torch.no_grad()
def select_keyframes_global(store: KeyframeStore, k: int,
                            gen: Optional[torch.Generator] = None,
                            scores_u=None):
    """Uniform random subset of the stored keyframes, the most recent
    excluded (Mapper.py:259-265)."""
    dev = store.depths.device
    if scores_u is None:
        scores_u = torch.rand(store.capacity, generator=gen, device=dev)
    eligible = torch.arange(store.capacity, device=dev) < max(
        store.count - 1, 0)
    scores = torch.where(eligible, scores_u, torch.full_like(scores_u, -1.0))
    return _topk_slots(scores, k, store.capacity)


def build_window(store: KeyframeStore, slots, valid, cur_color, cur_depth,
                 cur_c2w):
    """The fixed-size optimisation window: [selected keyframes..., most
    recent keyframe, current frame] (Mapper.py:267-272).  Invalid slots
    carry zero weight.  Returns a dict of stacked tensors, leading dim
    k+2."""
    dev = cur_depth.device
    last = torch.full((1,), max(store.count - 1, 0), dtype=torch.int64,
                      device=dev)
    slots_full = torch.cat([slots, last])
    valid_full = torch.cat([valid, torch.full((1,), store.count > 0,
                                              dtype=torch.bool, device=dev)])
    colors = store.colors[slots_full].to(torch.float32) / 255.0
    colors = torch.cat([colors, cur_color[None]], dim=0)
    depths = torch.cat([store.depths[slots_full], cur_depth[None]], dim=0)
    c2ws = torch.cat([store.est_c2w[slots_full],
                      cur_c2w[None].to(store.est_c2w.dtype)], dim=0)
    return {
        "colors": colors, "depths": depths, "c2ws": c2ws,
        "valid": torch.cat([valid_full, torch.ones(1, dtype=torch.bool,
                                                   device=dev)]),
        "slots": torch.cat([slots_full, torch.full((1,), -1,
                                                   dtype=slots.dtype,
                                                   device=dev)]),
    }
