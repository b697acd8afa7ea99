"""Gauss-Newton pose refinement with the map held fixed (the JAX package's
nice_slam_tpu/parallel/schur_ba.py).

The joint render objective's normal equations over (poses, grid
features), with the feature block eliminated under the alternation
approximation (features held at their current Adam iterate, so the Schur
complement is the pose block itself).  Each sampled ray comes from one
window frame's camera, so that block is exactly block-diagonal per frame:
one damped 7x7 solve per window frame.  The features re-adapt in the next
mapping event's Adam stages.

Each iteration is guarded: the candidate pose is evaluated on the same
ray sample (and the same stratified jitter: the render's uniforms are
drawn once, `render.render_draws`, and given to both renders) and
accepted per frame only if it does not raise the weighted SSE, keeps at
least half the current pose's valid rays and the frame may move
(cam_lr_mask > 0).  Residuals are depth residuals weighted by the
mapping loss's robust terms (valid depth, in-bound, 1/sqrt(depth
variance)); the weights are data terms, held fixed.

The Jacobian.  The JAX package takes `jacfwd` of the residual (7 JVP
renders).  Here the decode of the default widths is an autograd Function
over the kernels with no forward mode, so J is taken by reverse mode:
every ray gets its own copy of its frame's 7-vector, all the window's
rays render in one batch, and one backward of sum(r) gives row k of the
copies' gradient = dr_k/dcam, since residual k depends only on its own
ray (its near/far, its samples; each frame's max sensor depth is passed
per ray).  That is the same J as jacfwd's in exact arithmetic, from one
forward and one backward decode per iteration, plus one forward decode
for the candidate's SSE.  The decoders and grids are frozen
(train_decoders=False), so the backward computes no weight gradient and
the grid scatter never runs.

On a card one guarded iteration is a CUDA graph (graphs.py) when
`schur_pose_refine` is given a runner: the window, mask and map it reads
are then static buffers, and the cameras live in the runner's.
"""

from __future__ import annotations

from typing import Optional

import torch

from nice_slam_torch.camera import Camera
from nice_slam_torch.graphs import StepGraphs, tensor_key
from nice_slam_torch.ops.rays import ray_aabb_far, ray_dirs
from nice_slam_torch.ops.se3 import cam_from_tensor
from nice_slam_torch.ops.tree import tree_leaves
from nice_slam_torch.render import RenderSpec, render_draws, render_rays


def window_pixels(gen: Optional[torch.Generator], wn: int, n: int,
                  camera: Camera, device):
    """n pixels per window frame, uniform over the whole image (as the
    JAX package's per-frame sample_pixels(0, H, 0, W)): (i, j), each
    (wn, n) float."""
    i = torch.randint(0, camera.W, (wn, n), generator=gen, device=device)
    j = torch.randint(0, camera.H, (wn, n), generator=gen, device=device)
    return i.to(torch.float32), j.to(torch.float32)


def _rays(cams_r, i, j, camera: Camera):
    """Rays from per-ray cameras (N, 7) at pixels i, j (N,)."""
    c2w = cam_from_tensor(cams_r)                              # (N, 3, 4)
    dirs = ray_dirs(i, j, camera.fx, camera.fy, camera.cx, camera.cy)
    rays_d = torch.sum(dirs[:, None, :] * c2w[:, :3, :3], dim=-1)
    return c2w[:, :3, 3], rays_d


def _samples(window, i, j, frame_max_depth=None):
    """Per ray: its frame, sensor depth and its frame's max sensor depth
    over the sample, or `frame_max_depth` (Wn,) when given: (N,), (N,),
    (N, 1)."""
    wn, n = i.shape
    f = torch.arange(wn, device=i.device)[:, None].expand(wn, n)
    gt_d = window["depths"][f, j.long(), i.long()]
    if frame_max_depth is None:
        max_d = torch.amax(gt_d, dim=1, keepdim=True).expand(wn, n)
    else:
        max_d = frame_max_depth[:, None].expand(wn, n)
    return f.reshape(-1), gt_d.reshape(-1), max_d.reshape(-1, 1)


def _frame_residuals(cams_r, i, j, gt_d, max_d, params, grids, bound,
                     camera: Camera, rspec: RenderSpec, mspec,
                     gen: Optional[torch.Generator] = None, draws=None):
    """Weighted depth residuals (N,) of rays with per-ray cameras cams_r
    (N, 7), zero where masked (JAX `_frame_residuals`, for every frame's
    rays at once).  `draws`: the render's uniforms (`render_draws`),
    else drawn from `gen`."""
    rays_o, rays_d = _rays(cams_r, i, j, camera)
    depth, var, _, _ = render_rays(params, mspec, grids, bound, rays_o,
                                   rays_d, rspec, "color", gt_depth=gt_d,
                                   gen=gen, max_depth=max_d, draws=draws)
    # the weights are data terms, not functions of the pose solved for
    t_exit = ray_aabb_far(rays_o.detach(), rays_d.detach(), bound)
    m = (gt_d > 0) & (t_exit >= gt_d)
    w = (m.to(depth.dtype) / torch.sqrt(var + 1e-10)).detach()
    return (depth - gt_d) * w


def pose_jacobian(params, grids, bound, window, cams, camera: Camera,
                  rspec: RenderSpec, mspec, pix,
                  gen: Optional[torch.Generator] = None,
                  frame_max_depth=None, draws=None):
    """Residuals and their Jacobian on the pixels `pix` = (i, j), each
    (Wn, P), by reverse mode: every ray renders with its own copy of its
    frame's camera, and one backward of sum(r) gives row k of the copies'
    gradient = dr_k/dcam.  Returns (J (Wn, P, 7), r (Wn, P))."""
    i, j = pix
    wn = cams.shape[0]
    f, gt_d, max_d = _samples(window, i, j, frame_max_depth)
    with torch.enable_grad():
        cams_r = cams.detach()[f].requires_grad_(True)
        r = _frame_residuals(cams_r, i.reshape(-1), j.reshape(-1), gt_d,
                             max_d, params, grids, bound, camera, rspec,
                             mspec, gen, draws)
        (J,) = torch.autograd.grad(r.sum(), cams_r)
    return J.reshape(wn, -1, 7), r.detach().reshape(wn, -1)


def pose_system(params, grids, bound, window, cams, camera: Camera,
                rspec: RenderSpec, mspec, pixels_per_frame: int,
                valid_mask, gen: Optional[torch.Generator] = None,
                pix=None, frame_max_depth=None, draws=None):
    """Per-frame Gauss-Newton system on one ray sample: pixels `pix` =
    (i, j), each (Wn, pixels_per_frame), or drawn from `gen`;
    `frame_max_depth` (Wn,) replaces each frame's max sensor depth over
    the sample (a data-parallel rank passes the union's); `draws`: the
    render's uniforms.

    Returns (H (Wn, 7, 7), b (Wn, 7), sse (Wn,))."""
    if pix is None:
        pix = window_pixels(gen, cams.shape[0], pixels_per_frame, camera,
                            cams.device)
    J, r = pose_jacobian(params, grids, bound, window, cams, camera, rspec,
                         mspec, pix, gen, frame_max_depth, draws)
    v = valid_mask.to(r.dtype)
    H = (J.transpose(1, 2) @ J) * v[:, None, None]
    b = (J.transpose(1, 2) @ r[..., None])[..., 0] * v[:, None]
    return H, b, torch.sum(r * r, dim=1) * v


@torch.no_grad()
def residual_sse(params, grids, bound, window, cams, camera: Camera,
                 rspec: RenderSpec, mspec, pixels_per_frame: int,
                 valid_mask, gen: Optional[torch.Generator] = None,
                 pix=None, frame_max_depth=None, draws=None):
    """Per-frame weighted SSE (Wn,) on a ray sample, forward only (the
    guard's evaluation)."""
    wn = cams.shape[0]
    i, j = pix if pix is not None else window_pixels(
        gen, wn, pixels_per_frame, camera, cams.device)
    f, gt_d, max_d = _samples(window, i, j, frame_max_depth)
    r = _frame_residuals(cams[f], i.reshape(-1), j.reshape(-1), gt_d, max_d,
                         params, grids, bound, camera, rspec, mspec, gen,
                         draws)
    return torch.sum((r * r).reshape(wn, -1), dim=1) * valid_mask.to(r.dtype)


@torch.no_grad()
def mask_count(bound, window, cams, camera: Camera, pixels_per_frame: int,
               gen: Optional[torch.Generator] = None, pix=None):
    """Per-frame count (Wn,) of the rays whose residual is not masked: the
    mask of `_frame_residuals`, which depends on the pose through the
    ray/AABB test and needs no render.  The guard needs it: a candidate
    that pushes every ray out of bound zeroes every weight, and its SSE of
    ~0 would otherwise win."""
    wn = cams.shape[0]
    i, j = pix if pix is not None else window_pixels(
        gen, wn, pixels_per_frame, camera, cams.device)
    f, gt_d, _ = _samples(window, i, j)
    rays_o, rays_d = _rays(cams[f], i.reshape(-1), j.reshape(-1), camera)
    t_exit = ray_aabb_far(rays_o, rays_d, bound)
    m = (gt_d > 0) & (t_exit >= gt_d)
    return torch.sum(m.to(torch.float32).reshape(wn, -1), dim=1)


def gn_pose_update(cams, H, b, cam_lr_mask, damping: float,
                   delta_max: float = 0.2):
    """Damped per-frame solve (H + damping (diag(H) + I)) delta = b, with
    the step clamped to |delta| <= delta_max, applied where
    cam_lr_mask > 0 (the BA convention: the oldest and invalid window
    slots stay frozen).  A non-finite solve is no step."""
    eye = torch.eye(7, dtype=H.dtype, device=H.device)
    d = torch.diagonal(H, dim1=-2, dim2=-1)
    A = H + damping * (torch.diag_embed(d) + eye)
    delta, _ = torch.linalg.solve_ex(A, b)
    delta = torch.where(torch.isfinite(delta), delta,
                        torch.zeros_like(delta))
    norm = torch.linalg.norm(delta, dim=1, keepdim=True)
    delta = delta * torch.clamp(delta_max / (norm + 1e-12), max=1.0)
    step_mask = (cam_lr_mask > 0).to(cams.dtype)[:, None]
    return cams - delta * step_mask


def gn_iteration(params, grids, bound, window, cams, cam_lr_mask,
                 camera: Camera, rspec: RenderSpec, mspec,
                 pixels_per_frame: int, damping: float, reduce_fn=None,
                 gen: Optional[torch.Generator] = None, pix=None,
                 frame_max_depth=None):
    """One guarded GN iteration on one ray sample.  reduce_fn(tuple) ->
    tuple sums the systems and the guard's SSEs and counts of a sharded
    ray batch (None on one device); `frame_max_depth`: see pose_system.
    The render's uniforms are drawn once, after the pixels, and both
    renders take them.  Returns (cams, sse, accept (Wn,))."""
    valid_mask = window["valid"]
    wn = cams.shape[0]
    if pix is None:
        pix = window_pixels(gen, wn, pixels_per_frame, camera, cams.device)
    # the candidate's render takes the same stratified jitter
    draws = render_draws(gen, pix[0].numel(), rspec, cams.device)
    H, b, sse0 = pose_system(params, grids, bound, window, cams, camera,
                             rspec, mspec, pixels_per_frame, valid_mask,
                             gen=gen, pix=pix,
                             frame_max_depth=frame_max_depth, draws=draws)
    if reduce_fn is not None:
        H, b, sse0 = reduce_fn((H, b, sse0))
    cand = gn_pose_update(cams, H, b, cam_lr_mask, damping)
    sse1 = residual_sse(params, grids, bound, window, cand, camera, rspec,
                        mspec, pixels_per_frame, valid_mask, gen=gen,
                        pix=pix, frame_max_depth=frame_max_depth,
                        draws=draws)
    cnt0 = mask_count(bound, window, cams, camera, pixels_per_frame, pix=pix)
    cnt1 = mask_count(bound, window, cand, camera, pixels_per_frame, pix=pix)
    if reduce_fn is not None:
        sse1, cnt0, cnt1 = reduce_fn((sse1, cnt0, cnt1))
    accept = (sse1 <= sse0) & (cnt1 >= 0.5 * cnt0) & (cam_lr_mask > 0)
    cams = torch.where(accept[:, None], cand, cams)
    return cams, torch.where(accept, sse1, sse0), accept


def schur_pose_refine(params, grids, bound, window, cams, cam_lr_mask,
                      camera: Camera, rspec: RenderSpec, mspec,
                      n_iters: int, pixels_per_frame: int, damping: float,
                      reduce_fn=None, gen: Optional[torch.Generator] = None,
                      pixels=None, shard=None,
                      graphs: Optional[StepGraphs] = None):
    """n_iters guarded GN iterations, each on a fresh ray sample (pixels[k]
    when given, else drawn from `gen`).  With `shard` (parallel/
    data_parallel.RayShard) each sample is this rank's slice of the
    union's (pixels[k] then gives the union's) and the systems are summed
    through shard.reduce.  Returns new cameras (Wn, 7).

    Each iteration is one step of `graphs` (a side's runner; without it
    the loop runs eagerly) on the runner's static cameras and accept
    flags, under ("gn_cams" / "gn_accept", Wn, device).  On a card it is
    the signature "gn", a CUDA graph, unless `pixels`, `shard` or
    `reduce_fn` is given (their step runs eagerly); every tensor it reads
    (the map, `bound`, the window's depths and valid flags,
    `cam_lr_mask`) must then be a buffer that stays where it is, since
    the signature holds its address."""
    graphs = graphs or StepGraphs(cams.device, capture=False)
    wn, dev = cams.shape[0], cams.device
    cur = graphs.buffers(("gn_cams", wn, dev),
                         lambda: torch.empty(wn, 7, device=dev))
    acc = graphs.buffers(("gn_accept", wn, dev),
                         lambda: torch.zeros(wn, dtype=torch.bool,
                                             device=dev))
    with torch.no_grad():
        cur.copy_(cams)
    key = None
    if pixels is None and shard is None and reduce_fn is None:
        key = ("gn", pixels_per_frame, damping, camera, rspec, mspec,
               id(gen), tensor_key(
                   tree_leaves(params) + tree_leaves(grids)
                   + [bound, window["depths"], window["valid"], cur,
                      cam_lr_mask]))

    def step(pix):
        frame_max, reduce = None, reduce_fn
        if shard is not None:
            pix, frame_max = shard.gn_draws(window, camera, pixels_per_frame,
                                            gen, pix)
            reduce = shard.reduce
        new, _, accept = gn_iteration(
            params, grids, bound, window, cur, cam_lr_mask, camera, rspec,
            mspec, pixels_per_frame, damping, reduce_fn=reduce, gen=gen,
            pix=pix, frame_max_depth=frame_max)
        with torch.no_grad():
            cur.copy_(new)
            acc.copy_(accept)

    for k in range(n_iters):
        pix = None if pixels is None else pixels[k]
        graphs.step(key, lambda pix=pix: step(pix), (gen,))
    return cur.clone()
