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
are then static buffers, and the cameras live in the runner's.  A
data-parallel iteration is three graphs, cut at its two reduces.
"""

from __future__ import annotations

from typing import Optional

import torch

from nice_slam_torch.camera import Camera
from nice_slam_torch.graphs import StepGraphs, load_draws, tensor_key
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


def _gn_system(params, grids, bound, window, cams, camera: Camera,
               rspec: RenderSpec, mspec, pixels_per_frame: int,
               gen: Optional[torch.Generator], pix, frame_max_depth):
    """The first part of a guarded GN iteration: the pixels (drawn from
    `gen` unless given), the render's uniforms (drawn once, after the
    pixels: the candidate's render takes the same stratified jitter) and
    the system.  Returns (pix, draws, (H, b, sse0))."""
    if pix is None:
        pix = window_pixels(gen, cams.shape[0], pixels_per_frame, camera,
                            cams.device)
    draws = render_draws(gen, pix[0].numel(), rspec, cams.device)
    system = pose_system(params, grids, bound, window, cams, camera, rspec,
                         mspec, pixels_per_frame, window["valid"], gen=gen,
                         pix=pix, frame_max_depth=frame_max_depth,
                         draws=draws)
    return pix, draws, system


def _gn_guard(params, grids, bound, window, cams, cam_lr_mask,
              camera: Camera, rspec: RenderSpec, mspec,
              pixels_per_frame: int, damping: float, H, b,
              gen: Optional[torch.Generator], pix, frame_max_depth, draws):
    """The second part: the candidate pose and the guard's evaluation on
    the same sample.  Returns (cand, (sse1, cnt0, cnt1))."""
    cand = gn_pose_update(cams, H, b, cam_lr_mask, damping)
    sse1 = residual_sse(params, grids, bound, window, cand, camera, rspec,
                        mspec, pixels_per_frame, window["valid"], gen=gen,
                        pix=pix, frame_max_depth=frame_max_depth,
                        draws=draws)
    cnt0 = mask_count(bound, window, cams, camera, pixels_per_frame, pix=pix)
    cnt1 = mask_count(bound, window, cand, camera, pixels_per_frame, pix=pix)
    return cand, (sse1, cnt0, cnt1)


def _gn_accept(cams, cand, cam_lr_mask, sse0, sse1, cnt0, cnt1):
    """The last part: each frame's candidate accepted or not.  Returns
    (cams, sse, accept (Wn,))."""
    accept = (sse1 <= sse0) & (cnt1 >= 0.5 * cnt0) & (cam_lr_mask > 0)
    cams = torch.where(accept[:, None], cand, cams)
    return cams, torch.where(accept, sse1, sse0), accept


def gn_iteration(params, grids, bound, window, cams, cam_lr_mask,
                 camera: Camera, rspec: RenderSpec, mspec,
                 pixels_per_frame: int, damping: float,
                 gen: Optional[torch.Generator] = None, pix=None):
    """One guarded GN iteration on one device's ray sample (a sharded
    batch runs `_gn_system`, `_gn_guard` and `_gn_accept` as segments
    around its reduces: schur_pose_refine).  The render's uniforms are
    drawn once, after the pixels, and both renders take them.  Returns
    (cams, sse, accept (Wn,))."""
    pix, draws, (H, b, sse0) = _gn_system(
        params, grids, bound, window, cams, camera, rspec, mspec,
        pixels_per_frame, gen, pix, None)
    cand, checks = _gn_guard(
        params, grids, bound, window, cams, cam_lr_mask, camera, rspec,
        mspec, pixels_per_frame, damping, H, b, gen, pix, None, draws)
    return _gn_accept(cams, cand, cam_lr_mask, sse0, *checks)


def schur_pose_refine(params, grids, bound, window, cams, cam_lr_mask,
                      camera: Camera, rspec: RenderSpec, mspec,
                      n_iters: int, pixels_per_frame: int, damping: float,
                      gen: Optional[torch.Generator] = None, pixels=None,
                      shard=None, graphs: Optional[StepGraphs] = None):
    """n_iters guarded GN iterations, each on a fresh ray sample (pixels[k]
    when given, else drawn from `gen`).  With `shard` (parallel/
    data_parallel.RayShard) each sample is this rank's slice of the
    union's (pixels[k] then gives the union's) and the systems are summed
    through shard.reduce_.  Returns new cameras (Wn, 7).

    Each iteration is one step of `graphs` (a side's runner; without it
    the loop runs eagerly) on the runner's static cameras and accept
    flags, under ("gn_cams" / "gn_accept", Wn, device).  On a card it is
    the signature "gn", a CUDA graph; with `shard` a segmented step of
    three graphs (the system, the candidate and its guard, the accept)
    with the two reduces run between their replays.  Given `pixels` are
    copied into static buffers before each replay.  Every tensor the step
    reads (the map, `bound`, the window's depths and valid flags,
    `cam_lr_mask`) must be a buffer that stays where it is, since the
    signature holds its address."""
    graphs = graphs or StepGraphs(cams.device, capture=False)
    wn, dev = cams.shape[0], cams.device
    cur = graphs.buffers(("gn_cams", wn, dev),
                         lambda: torch.empty(wn, 7, device=dev))
    acc = graphs.buffers(("gn_accept", wn, dev),
                         lambda: torch.zeros(wn, dtype=torch.bool,
                                             device=dev))
    with torch.no_grad():
        cur.copy_(cams)
    pix_buf = graphs.draw_buffers(pixels)
    key = ("gn", pixels_per_frame, damping, camera, rspec, mspec, id(gen),
           tensor_key(tree_leaves(params) + tree_leaves(grids)
                      + [bound, window["depths"], window["valid"], cur,
                         cam_lr_mask]),
           shard and shard.signature(),
           None if pix_buf is None else tensor_key(pix_buf))

    def step():
        new, _, accept = gn_iteration(
            params, grids, bound, window, cur, cam_lr_mask, camera, rspec,
            mspec, pixels_per_frame, damping, gen=gen, pix=pix_buf)
        with torch.no_grad():
            cur.copy_(new)
            acc.copy_(accept)

    if shard is not None:
        sums = graphs.bucket(("gn_system", wn), [(wn, 7, 7), (wn, 7), (wn,)])
        guard = graphs.bucket(("gn_guard", wn), [(wn,)] * 3)
        held = {}

        def system_segment():
            pix, frame_max = shard.gn_draws(window, camera, pixels_per_frame,
                                            gen, pix_buf)
            pix, draws, system = _gn_system(
                params, grids, bound, window, cur, camera, rspec, mspec,
                pixels_per_frame, gen, pix, frame_max)
            held["pix"] = tuple(graphs.hold(f"gn_pix{k}", x)
                                for k, x in enumerate(pix))
            held["frame_max"] = graphs.hold("gn_frame_max", frame_max)
            held["draws"] = tuple(None if x is None else
                                  graphs.hold(f"gn_draws{k}", x)
                                  for k, x in enumerate(draws))
            sums.pack(system)

        def guard_segment():
            H, b, _ = sums.views()
            cand, checks = _gn_guard(
                params, grids, bound, window, cur, cam_lr_mask, camera,
                rspec, mspec, pixels_per_frame, damping, H, b, gen,
                held["pix"], held["frame_max"], held["draws"])
            held["cand"] = graphs.hold("gn_cand", cand)
            guard.pack(checks)

        def accept_segment():
            new, _, accept = _gn_accept(cur, held["cand"], cam_lr_mask,
                                        sums.views()[2], *guard.views())
            with torch.no_grad():
                cur.copy_(new)
                acc.copy_(accept)

        segs = ((system_segment, guard_segment, accept_segment),
                (lambda: shard.reduce_(sums, "gn"),
                 lambda: shard.reduce_(guard, "gn")),
                ((gen,), (), ()))
    for k in range(n_iters):
        if pix_buf is not None:
            load_draws(pix_buf, pixels[k])
        if shard is None:
            graphs.step(key, step, (gen,))
        else:
            graphs.step_segments(key, *segs)
    return cur.clone()
