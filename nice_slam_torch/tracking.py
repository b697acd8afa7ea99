"""Per-frame camera tracking (src/Tracker.py), as in the JAX package:
a loop of Adam steps on the 7-vector camera against a frozen map, each
step sampling pixels, rendering, and taking the robust depth (+ colour)
loss; the camera kept is the post-step camera of the lowest pre-step loss.
The ray/AABB prefilter (Tracker.py:93-104) is a loss mask, so shapes do
not depend on the data.  The selection stays on the device (no host sync
per iteration).  With gn_iters > 0 the kept camera then takes that many
guarded Gauss-Newton steps (parallel/schur_ba.py, a one-frame window).

The loop's state (camera, Adam moments and step counter, the best camera
and loss, the per-iteration losses and pre-step cameras, the frame)
lives in static buffers that each iteration updates in place, so on a
card one iteration is a CUDA graph (graphs.py) replayed `iters` times:
the counterpart of the JAX package's one jitted `lax.scan`
(nice_slam_tpu/tracking.py:164-212), in every mode (NICE, iMAP*,
occupancy-guided sampling, with or without the panels).  init_select's
two candidate renders are one more step a frame, and each Gauss-Newton
iteration another (`schur_ba.schur_pose_refine`), as the JAX package
computes them inside the same jit (`_track_step_body`).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Optional, Tuple

import torch

from nice_slam_torch.camera import Camera
from nice_slam_torch.graphs import StepGraphs, tensor_key
from nice_slam_torch.models.decoders import ModelSpec
from nice_slam_torch.ops.optim import adam_step_, bias_tables
from nice_slam_torch.ops.rays import (
    gather_pixels,
    ray_aabb_far,
    rays_from_uv,
    sample_pixels,
)
from nice_slam_torch.ops.se3 import (
    cam_from_tensor,
    tensor_from_cam,
    to_homogeneous,
)
from nice_slam_torch.ops.tree import tree_leaves
from nice_slam_torch.parallel import schur_ba
from nice_slam_torch.render import RenderSpec, render_rays


@dataclass(frozen=True)
class TrackSpec:
    iters: int = 10
    pixels: int = 200
    lr: float = 0.001
    seperate_lr: bool = False
    w_color_loss: float = 0.5
    ignore_edge_w: int = 20
    ignore_edge_h: int = 20
    handle_dynamic: bool = True
    use_color: bool = True
    const_speed: bool = True
    # two-candidate initialisation (constant-speed extrapolation vs the
    # previous pose), see nice_slam_tpu/tracking.py TrackSpec for the
    # measured rationale of the asymmetric margin and the 1 cm floor
    init_select: bool = True
    init_select_margin: float = 3.0
    # Gauss-Newton polish of the tracked pose (tracking.pose_GN_*):
    # gn_iters guarded steps on gn_pixels rays over the whole image; off
    # by default (the JAX package measured it as negative for ATE)
    gn_iters: int = 0
    gn_pixels: int = 1000
    gn_damping: float = 1e-3
    nice: bool = True


def masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median of x over mask==True, torch.median semantics (lower middle)."""
    big = torch.where(mask, x, torch.full_like(x, float("inf")))
    srt, _ = torch.sort(big)
    n = torch.sum(mask.to(torch.int64))
    idx = torch.clamp((n - 1) // 2, min=0)
    # index_select, not srt[idx]: indexing by a 0-dim tensor may read it
    # on the host
    return srt.index_select(0, idx.view(1))[0]


def _track_pixels(gen, tspec: TrackSpec, camera: Camera):
    return sample_pixels(gen, tspec.pixels, tspec.ignore_edge_h,
                         camera.H - tspec.ignore_edge_h, tspec.ignore_edge_w,
                         camera.W - tspec.ignore_edge_w)


def tracking_loss(cam, params, grids, bound, gt_color, gt_depth,
                  camera: Camera, tspec: TrackSpec, rspec: RenderSpec,
                  mspec: ModelSpec, gen: Optional[torch.Generator] = None,
                  pix: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """One tracking loss at camera 7-vector `cam` (Tracker.py:71-128):
    robust depth L1 / sqrt(uncertainty) with the 10x-median dynamic-outlier
    mask, plus the colour term.  Pixels are `pix` = (i, j) or drawn from
    `gen`."""
    c2w = cam_from_tensor(cam)
    i, j = pix if pix is not None else _track_pixels(gen, tspec, camera)
    rays_o, rays_d = rays_from_uv(i, j, c2w, camera.fx, camera.fy,
                                  camera.cx, camera.cy)
    batch_d = gather_pixels(gt_depth, i, j)
    batch_c = gather_pixels(gt_color, i, j)
    if tspec.nice:
        t_exit = ray_aabb_far(rays_o.detach(), rays_d.detach(), bound)
        inside = t_exit >= batch_d
    else:
        inside = torch.ones_like(batch_d, dtype=torch.bool)
    depth, var, color, _ = render_rays(params, mspec, grids, bound, rays_o,
                                       rays_d, rspec, "color",
                                       gt_depth=batch_d)
    var = var.detach()
    tmp = torch.abs(batch_d - depth) / torch.sqrt(var + 1e-10)
    if tspec.handle_dynamic:
        med = masked_median(tmp.detach(), inside)
        mask = (tmp < 10.0 * med) & (batch_d > 0) & inside
    else:
        mask = (batch_d > 0) & inside
    loss = torch.sum(tmp * mask)
    if tspec.use_color:
        closs = torch.sum(torch.abs(batch_c - color) * mask[:, None])
        loss = loss + tspec.w_color_loss * closs
    return loss


@torch.no_grad()
def tracking_depth_median(cam, params, grids, bound, gt_depth,
                          camera: Camera, tspec: TrackSpec,
                          rspec: RenderSpec, mspec: ModelSpec,
                          gen: Optional[torch.Generator] = None,
                          pix=None):
    """Median absolute depth residual (metres) of a candidate camera over
    one pixel sample: the init_select signal (deliberately not the
    tracking loss, and without the pose-dependent AABB filter; see
    nice_slam_tpu/tracking.py)."""
    c2w = cam_from_tensor(cam)
    i, j = pix if pix is not None else _track_pixels(gen, tspec, camera)
    rays_o, rays_d = rays_from_uv(i, j, c2w, camera.fx, camera.fy,
                                  camera.cx, camera.cy)
    batch_d = gather_pixels(gt_depth, i, j)
    depth, _, _, _ = render_rays(params, mspec, grids, bound, rays_o, rays_d,
                                 rspec, "color", gt_depth=batch_d)
    return masked_median(torch.abs(batch_d - depth), batch_d > 0)


def _track_buffers(graphs: StepGraphs, tspec: TrackSpec, gt_color,
                   gt_depth):
    """The static buffers of the tracking loop (made once per runner and
    frame shape): camera, Adam moments and step counter, bias tables, best
    camera and loss, the per-iteration losses and pre-step cameras, the
    learning rates and the frame; init_select's two candidate poses and
    the chosen initial camera; the Gauss-Newton polish's valid flag and
    mask."""
    dev = gt_depth.device
    key = ("track", tuple(gt_color.shape), tuple(gt_depth.shape),
           tspec.iters, tspec.lr, tspec.seperate_lr, dev)

    def make():
        if tspec.seperate_lr:
            # quaternion LR is 0.2x the translation LR (Tracker.py:202-213)
            lr = torch.cat([torch.full((4,), tspec.lr * 0.2, device=dev),
                            torch.full((3,), tspec.lr, device=dev)])
        else:
            lr = torch.full((7,), tspec.lr, device=dev)
        z = torch.zeros(7, device=dev)
        return SimpleNamespace(
            cam=z.clone(), m=z.clone(), v=z.clone(), best_cam=z.clone(),
            step=torch.zeros((), dtype=torch.int64, device=dev),
            best_loss=torch.zeros((), device=dev),
            losses=torch.zeros(max(tspec.iters, 1), device=dev),
            cams=torch.zeros(max(tspec.iters, 1), 7, device=dev),
            tables=bias_tables(tspec.iters, dev), lr=lr,
            color=torch.empty_like(gt_color), depth=torch.empty_like(gt_depth),
            init_c2w=torch.zeros(4, 4, device=dev),
            pre_c2w=torch.zeros(4, 4, device=dev), cam0=z.clone(),
            gn_valid=torch.ones(1, dtype=torch.bool, device=dev),
            gn_mask=torch.ones(1, device=dev))

    return key, graphs.buffers(key, make)


def _map_key(params, grids, bound) -> tuple:
    return tensor_key(tree_leaves(params) + tree_leaves(grids) + [bound])


def track_frame(params, grids, bound, cam0, gt_color, gt_depth,
                camera: Camera, tspec: TrackSpec, rspec: RenderSpec,
                mspec: ModelSpec, gen: Optional[torch.Generator] = None,
                return_cams: bool = False,
                graphs: Optional[StepGraphs] = None):
    """Optimise one frame's camera.  Returns (best_cam, first_loss,
    last_loss, best_loss), all on the device, plus with return_cams the
    (iters, 7) PRE-step camera of every iteration (what the reference's
    per-iteration visualiser renders, src/Tracker.py:230-231).

    The candidate kept is the post-step camera whose pre-step loss was
    minimal (Tracker.py:232-247).  The decoders are frozen, so the fused
    decode is told that no weight gradient is wanted.

    `graphs` (the engine's tracking runner) replays each iteration as a
    captured CUDA graph on a card; the map (params, grids, bound) must
    then stay where it is between frames (the engine's tracking copy):
    the signature holds its addresses.  Every iteration records its
    pre-step camera, so a frame with return_cams replays the same graph.
    Without a runner the loop runs eagerly."""
    rspec = dataclasses.replace(rspec, train_decoders=False)
    graphs = graphs or StepGraphs(cam0.device, capture=False)
    bkey, b = _track_buffers(graphs, tspec, gt_color, gt_depth)
    with torch.no_grad():
        b.cam.copy_(cam0)
        b.best_cam.copy_(cam0)
        b.m.zero_()
        b.v.zero_()
        b.step.zero_()
        b.best_loss.fill_(float("inf"))
        b.color.copy_(gt_color)
        b.depth.copy_(gt_depth)

    def step():
        c = b.cam.clone().requires_grad_(True)
        loss = tracking_loss(c, params, grids, bound, b.color, b.depth,
                             camera, tspec, rspec, mspec, gen=gen)
        (g,) = torch.autograd.grad(loss, c)
        with torch.no_grad():
            loss = loss.detach()
            b.losses.index_copy_(0, b.step.view(1), loss.view(1))
            b.cams.index_copy_(0, b.step.view(1), b.cam.view(1, 7))
            better = loss < b.best_loss
            adam_step_(b.cam, g, b.m, b.v, b.step, b.tables, b.lr)
            b.best_cam.copy_(torch.where(better, b.cam, b.best_cam))
            b.best_loss.copy_(torch.where(better, loss, b.best_loss))

    key = ("track", bkey, tspec, rspec, mspec, camera, id(gen),
           _map_key(params, grids, bound))
    for _ in range(tspec.iters):
        graphs.step(key, step, (gen,))
    best = b.best_loss.clone()
    res = (b.best_cam.clone(),
           b.losses[0].clone() if tspec.iters else best,
           b.losses[tspec.iters - 1].clone() if tspec.iters else best, best)
    if return_cams:
        return res + (b.cams[:tspec.iters].clone(),)
    return res


def const_speed_init(pre_c2w, pre_pre_c2w):
    """Constant-speed motion model: delta = pre @ inv(pre_pre) applied to
    pre (Tracker.py:192-198).  4x4 in and out."""
    delta = pre_c2w @ torch.linalg.inv(pre_pre_c2w)
    return delta @ pre_c2w


def track_step(params, grids, bound, est_c2w: torch.Tensor, idx: int,
               gt_color, gt_depth, camera: Camera, tspec: TrackSpec,
               rspec: RenderSpec, mspec: ModelSpec,
               gen: Optional[torch.Generator] = None,
               return_cams: bool = False,
               graphs: Optional[StepGraphs] = None):
    """Track frame `idx` from the poses already in est_c2w (n, 4, 4) and
    write its pose there.  Returns the device tensor [first, last, best]
    of the tracking losses, and with return_cams also `track_frame`'s
    (iters, 7) pre-step cameras (the Gauss-Newton polish comes after
    them).  `graphs`: see `track_frame`; init_select's candidate renders
    are one step of it (the signature "init_select") and each
    Gauss-Newton iteration another ("gn")."""
    graphs = graphs or StepGraphs(gt_depth.device, capture=False)
    bkey, b = _track_buffers(graphs, tspec, gt_color, gt_depth)
    with torch.no_grad():
        b.color.copy_(gt_color)
        b.depth.copy_(gt_depth)
    pre = est_c2w[idx - 1]
    init_c2w = pre
    if tspec.const_speed and idx >= 2:
        init_c2w = const_speed_init(pre, est_c2w[idx - 2])
        if tspec.init_select:
            # keep the extrapolation unless it renders catastrophically
            # worse than the previous pose on the same pixels (margin x,
            # the previous pose's median floored at 1 cm)
            eval_rspec = dataclasses.replace(rspec, train_decoders=False)
            with torch.no_grad():
                b.init_c2w.copy_(init_c2w)
                b.pre_c2w.copy_(pre)

            def select():
                pix = _track_pixels(gen, tspec, camera)
                med_cs = tracking_depth_median(
                    tensor_from_cam(b.init_c2w), params, grids, bound,
                    b.depth, camera, tspec, eval_rspec, mspec, pix=pix)
                med_pre = tracking_depth_median(
                    tensor_from_cam(b.pre_c2w), params, grids, bound,
                    b.depth, camera, tspec, eval_rspec, mspec, pix=pix)
                keep = med_cs <= tspec.init_select_margin * torch.clamp(
                    med_pre, min=0.01)
                b.init_c2w.copy_(torch.where(keep, b.init_c2w, b.pre_c2w))

            graphs.step(("init_select", bkey, tspec, eval_rspec, mspec,
                         camera, id(gen), _map_key(params, grids, bound)),
                        select, (gen,))
            init_c2w = b.init_c2w
    with torch.no_grad():
        b.cam0.copy_(tensor_from_cam(init_c2w))
    best_cam, first, last, best, *pre_cams = track_frame(
        params, grids, bound, b.cam0, b.color, b.depth, camera, tspec,
        rspec, mspec, gen=gen, return_cams=return_cams, graphs=graphs)
    if tspec.gn_iters > 0:
        # the polish of nice_slam_tpu/tracking.py:333-346: a one-frame
        # window over the whole image, the map frozen
        window = {"depths": b.depth[None], "valid": b.gn_valid}
        best_cam = schur_ba.schur_pose_refine(
            params, grids, bound, window, best_cam[None], b.gn_mask, camera,
            dataclasses.replace(rspec, train_decoders=False), mspec,
            tspec.gn_iters, tspec.gn_pixels, tspec.gn_damping, gen=gen,
            graphs=graphs)[0]
    est_c2w[idx] = to_homogeneous(cam_from_tensor(best_cam))
    losses = torch.stack([first, last, best])
    return (losses, pre_cams[0]) if return_cams else losses
