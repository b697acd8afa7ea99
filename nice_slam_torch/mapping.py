"""Keyframe-window joint mapping (src/Mapper.py), strict schedule, as in
the JAX package:

- the staged middle -> fine -> colour schedule with static iteration
  counts from the iter-ratio thresholds (Mapper.py:403-419);
- one Adam over the whole tree (decoders, grids, window cameras) with a
  per-stage learning-rate tree; its moments are fresh per call and kept
  across the call's stages;
- frustum feature selection (Mapper.py:93-164) is a voxel mask multiplied
  into the grid gradients: invisible features get exactly zero update;
- local BA optimises the window cameras with a per-slot LR mask (the
  oldest keyframe and invalid slots frozen; Mapper.py:346-363), and with
  pose_gn_iters > 0 the staged Adam is followed by guarded Gauss-Newton
  steps on those cameras (parallel/schur_ba.py);
- an occupancy-guided run refreshes its occupancy proxy after each NICE
  mapping pass that is not the coarse mapper's (`refresh_occ_proxy`);
- in a process group of more than one rank the staged Adam is
  data-parallel (parallel/data_parallel.py: `map_optimize` with a
  `RayShard` hook that gives each rank its slice of the union's rays and
  sums the loss and gradients over the group), or under tpu.grid_sharded
  the NICE mapper runs with its grids in X-slabs over a 2-D process group
  (parallel/grid_sharded.py `gs_map_once`).

In iMAP* mode there are no grids and no frustum masks: the one decoder
trains at imap_decoders_lr under StepLR(200, 0.8) (Mapper.py:388-389),
every stage takes the colour term, and a density regulation term keeps
free space empty.

Leaves whose learning rate is structurally zero are frozen: they get no
gradient and no update; so is every grid without a learning rate, such
as the occupancy proxy.

`map_optimize` copies the map, the window cameras, the window and the
masks into static buffers at the start of a call and out at its end;
every iteration updates them in place (Adam's moments and step counter
too), so on a card each stage's iteration is a CUDA graph (graphs.py)
replayed for the stage's iterations: the counterpart of the JAX
package's three `lax.scan`s (nice_slam_tpu/mapping.py:444-471), in
every mode: iMAP* reads its StepLR rate from a device table at the step
counter, the occupancy proxy is one of the static grids, and each
Gauss-Newton iteration after the staged Adam is a step of its own.
Given `pixels` are copied into static draw buffers before each replay.
The data-parallel `shard` step has a gloo all_reduce inside: it is a
segmented step, two graphs around the collective, which runs eagerly
between their replays (the JAX package's jitted shard_map with its psum,
nice_slam_tpu/parallel/data_parallel.py:53-101); grid-sharded mapping
(parallel/grid_sharded.py) is segmented the same way at its five
collectives.  The parts of an event are spans of the engine's tracer
(utils/profiling.span): map.prepare, each stage's replay loop (`stage_span`),
map.ba_gn, map.writeback, map.keyframe and the coarse mapper's map.coarse.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Dict, Optional, Tuple

import torch

from nice_slam_torch.camera import Camera
from nice_slam_torch.graphs import StepGraphs, load_draws, tensor_key
from nice_slam_torch.keyframes import (
    KeyframeStore,
    add_keyframe,
    build_window,
    project_points,
    select_keyframes_global,
    select_keyframes_overlap,
)
from nice_slam_torch.models.decoders import ModelSpec, model_apply
from nice_slam_torch.ops.optim import adam_step_, bias_tables
from nice_slam_torch.ops.rays import ray_aabb_far
from nice_slam_torch.ops.se3 import (
    cam_from_tensor,
    tensor_from_cam,
    to_homogeneous,
)
from nice_slam_torch.ops.tree import tree_leaves, tree_map
from nice_slam_torch.parallel import schur_ba
from nice_slam_torch.render import RenderSpec, regulation_sigma, render_rays
from nice_slam_torch.utils.profiling import span


@dataclass(frozen=True)
class StageLR:
    decoders: float = 0.0
    coarse: float = 0.0
    middle: float = 0.0
    fine: float = 0.0
    color: float = 0.0


DEFAULT_STAGE_LR = {
    "coarse": StageLR(coarse=0.001),
    "middle": StageLR(middle=0.1),
    "fine": StageLR(middle=0.005, fine=0.005),
    "color": StageLR(decoders=0.005, middle=0.005, fine=0.005, color=0.005),
}


@dataclass(frozen=True)
class MapSpec:
    pixels: int = 1000
    window_size: int = 5
    w_color_loss: float = 0.2
    middle_iter_ratio: float = 0.4
    fine_iter_ratio: float = 0.6
    fix_fine: bool = True
    fix_color: bool = False
    train_middle: bool = False
    frustum_selection: bool = True
    keyframe_selection: str = "overlap"
    keyframe_every: int = 50
    ba: bool = True
    ba_cam_lr: float = 0.001
    nice: bool = True
    coarse_mapper: bool = False
    imap_decoders_lr: float = 0.0002
    grad_clip: float = 0.0
    # Gauss-Newton refinement of the BA window cameras after the staged
    # Adam (mapping.pose_GN_*; NICE mode with BA on); off by default
    pose_gn_iters: int = 0
    pose_gn_pixels: int = 200
    pose_gn_damping: float = 1e-3
    stage_lr: Tuple[Tuple[str, StageLR], ...] = tuple(
        sorted(DEFAULT_STAGE_LR.items()))

    def stage_lr_table(self):
        return dict(self.stage_lr)

    def stage_iters(self, num_joint_iters: int) -> Dict[str, int]:
        """Per-stage iteration counts from the reference's iter-ratio
        thresholds (Mapper.py:403-410)."""
        if self.coarse_mapper:
            return {"coarse": num_joint_iters, "middle": 0, "fine": 0,
                    "color": 0}
        n = num_joint_iters
        n_mid = min(int(n * self.middle_iter_ratio) + 1, n)
        n_fine = max(min(int(n * self.fine_iter_ratio) + 1, n) - n_mid, 0)
        return {"coarse": 0, "middle": n_mid, "fine": n_fine,
                "color": n - n_mid - n_fine}


def stage_iters_of(mapspec: MapSpec, num_joint_iters: int):
    """((stage, iters), ...) in schedule order, zero-iteration stages
    dropped."""
    it = mapspec.stage_iters(num_joint_iters)
    return tuple((st, it[st]) for st in ("coarse", "middle", "fine", "color")
                 if it[st] > 0)


# ---------------------------------------------------------------------------
# Frustum feature selection

def bilinear_sample_2d(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """Bilinear lookup of img (H, W) at x=u, y=v (callers mask
    out-of-image points)."""
    H, W = img.shape
    u = torch.clamp(u, 0.0, W - 1.0)
    v = torch.clamp(v, 0.0, H - 1.0)
    x0 = torch.clamp(torch.floor(u).long(), 0, max(W - 2, 0))
    y0 = torch.clamp(torch.floor(v).long(), 0, max(H - 2, 0))
    x1 = torch.clamp(x0 + 1, max=W - 1)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    fx = u - x0
    fy = v - y0
    return (img[y0, x0] * (1 - fx) * (1 - fy) + img[y0, x1] * fx * (1 - fy)
            + img[y1, x0] * (1 - fx) * fy + img[y1, x1] * fx * fy)


def grid_node_points(bound: torch.Tensor, shape) -> torch.Tensor:
    """World positions of a grid's nodes (align-corners linspace over the
    AABB, the convention trilinear_interp reads).  (Nx*Ny*Nz, 3)."""
    axes = [torch.linspace(float(bound[a, 0]), float(bound[a, 1]), n,
                           device=bound.device)
            for a, n in enumerate(shape)]
    X, Y, Z = torch.meshgrid(*axes, indexing="ij")
    return torch.stack([X, Y, Z], dim=-1).reshape(-1, 3)


@torch.no_grad()
def frustum_mask(bound, shape, c2w, depth, camera: Camera) -> torch.Tensor:
    """Voxel visibility for one grid (Mapper.py:93-164): nodes projected into
    the current depth image, kept when in the frustum with -z <= depth + 0.5,
    plus every node within 0.5 m of the camera centre.  (Nx, Ny, Nz) bool."""
    pts = grid_node_points(bound, shape)
    u, v, z = project_points(pts, c2w, camera)
    d_at = bilinear_sample_2d(depth, u, v)
    d_at = torch.where(d_at == 0, torch.max(d_at), d_at)
    mask = ((u < camera.W) & (u > 0) & (v < camera.H) & (v > 0)
            & (0 <= -z) & (-z <= d_at + 0.5))
    dist2 = torch.sum((pts - c2w[:3, 3]) ** 2, dim=-1)
    return (mask | (dist2 < 0.25)).reshape(shape)


def grid_masks(grids, bound, c2w, depth, camera: Camera, enabled: bool,
               names=None):
    """Frustum masks (Nx, Ny, Nz, 1) for the grids in `names` (default all);
    coarse is always fully optimisable (Mapper.py:113-115), and the
    occupancy proxy, which never trains, takes no frustum test."""
    masks = {}
    for name, g in grids.items():
        if names is not None and name not in names:
            continue
        if not enabled or name in ("coarse", "occ_proxy"):
            masks[name] = torch.ones(g.shape[:3] + (1,), dtype=g.dtype,
                                     device=g.device)
        else:
            m = frustum_mask(bound, tuple(g.shape[:3]), c2w, depth, camera)
            masks[name] = m[..., None].to(g.dtype)
    return masks


def _trained_grids(mapspec: MapSpec, stage_iters) -> set:
    table = mapspec.stage_lr_table()
    names = set()
    for stage, _ in stage_iters:
        t = table[stage]
        names |= {n for n, lr in (("coarse", t.coarse), ("middle", t.middle),
                                  ("fine", t.fine), ("color", t.color))
                  if lr != 0.0}
    return names


@torch.no_grad()
def prepare_mapping(store: KeyframeStore, color, depth, cur_c2w, grids,
                    bound, camera: Camera, mapspec: MapSpec, ba: bool,
                    gen: Optional[torch.Generator] = None,
                    mask_names=None, sel_draws=None):
    """Keyframe selection, window assembly, frustum masks, window camera
    tensors and the BA learning-rate mask (the oldest valid keyframe and
    invalid slots frozen; Mapper.py:267-272, 346-363).  `sel_draws`
    optionally gives the selection's draws as a dict of keyword arguments
    (pix, scores_u)."""
    k = mapspec.window_size - 2
    draws = sel_draws or {}
    if mapspec.keyframe_selection == "overlap":
        slots, valid = select_keyframes_overlap(store, depth, cur_c2w,
                                                camera, k, gen=gen, **draws)
    else:
        slots, valid = select_keyframes_global(store, k, gen=gen, **draws)
    window = build_window(store, slots, valid, color, depth, cur_c2w)
    masks = grid_masks(grids, bound, cur_c2w, depth, camera,
                       mapspec.frustum_selection and mapspec.nice,
                       names=mask_names)
    cams0 = tensor_from_cam(window["c2ws"][:, :3, :])
    wn = window["valid"].shape[0]
    if ba:
        sl = window["slots"][:-1]
        va = window["valid"][:-1]
        big = torch.iinfo(sl.dtype).max
        oldest = torch.argmin(torch.where(va, sl, torch.full_like(sl, big)))
        cam_lr_mask = window["valid"].to(torch.float32)
        cam_lr_mask[oldest] = 0.0
    else:
        cam_lr_mask = torch.zeros(wn, device=depth.device)
    return window, masks, cams0, cam_lr_mask


# ---------------------------------------------------------------------------
# Loss

def _window_rays(window, cams, camera: Camera, pix_per_frame: int,
                 gen: Optional[torch.Generator] = None, pix=None):
    """Sample pix_per_frame pixels from every window frame and build rays
    from the (optimisable) camera tensors.  `pix` = (i, j), each
    (Wn, pix_per_frame), unless drawn from `gen`.  Returns flat batches."""
    wn = window["colors"].shape[0]
    dev = cams.device
    if pix is None:
        i = torch.randint(0, camera.W, (wn, pix_per_frame), generator=gen,
                          device=dev).to(torch.float32)
        j = torch.randint(0, camera.H, (wn, pix_per_frame), generator=gen,
                          device=dev).to(torch.float32)
    else:
        i, j = pix
    c2ws = cam_from_tensor(cams)                               # (Wn, 3, 4)
    dirs = torch.stack([(i - camera.cx) / camera.fx,
                        -(j - camera.cy) / camera.fy,
                        -torch.ones_like(i)], dim=-1)          # (Wn, P, 3)
    rays_d = torch.sum(dirs[..., None, :] * c2ws[:, None, :3, :3], dim=-1)
    rays_o = c2ws[:, None, :3, 3].expand(rays_d.shape)
    f = torch.arange(wn, device=dev)[:, None]
    jl, il = j.long(), i.long()
    gd = window["depths"][f, jl, il]
    gc = window["colors"][f, jl, il]
    valid = window["valid"][:, None].expand(wn, pix_per_frame)
    return (rays_o.reshape(-1, 3), rays_d.reshape(-1, 3), gd.reshape(-1),
            gc.reshape(-1, 3), valid.reshape(-1))


def mapping_loss(tree, window, bound, camera: Camera, stage: str,
                 mapspec: MapSpec, rspec: RenderSpec, mspec: ModelSpec,
                 gen: Optional[torch.Generator] = None, pix=None,
                 reg_u=None, max_depth=None):
    """One mapping loss (Mapper.py:430-501): masked L1 depth + (colour
    stage, every stage in iMAP*) L1 colour; density mode (iMAP*) adds the
    sigma regulation, whose jitter `reg_u` is drawn from `gen` unless
    given.  `max_depth` replaces the batch's max sensor depth in the
    render (a rank of a data-parallel step passes the union's)."""
    params, grids, cams = tree["params"], tree["grids"], tree["cams"]
    n_pix = mapspec.pixels // window["colors"].shape[0]
    rays_o, rays_d, gt_d, gt_c, valid = _window_rays(window, cams, camera,
                                                     n_pix, gen, pix)
    if mapspec.nice:
        t_exit = ray_aabb_far(rays_o.detach(), rays_d.detach(), bound)
        m = valid & (t_exit >= gt_d)
    else:
        m = valid
    depth, _, color, _ = render_rays(
        params, mspec, grids, bound, rays_o, rays_d, rspec, stage,
        gt_depth=None if mapspec.coarse_mapper else gt_d, gen=gen,
        max_depth=max_depth)
    dm = (gt_d > 0) & m
    loss = torch.sum(torch.abs(gt_d - depth) * dm)
    if not mapspec.nice or stage == "color":
        loss = loss + mapspec.w_color_loss * torch.sum(
            torch.abs(gt_c - color) * m[:, None])
    if not rspec.occupancy:
        sigma = regulation_sigma(params, mspec, grids, bound, rays_o, rays_d,
                                 gt_d, rspec.n_samples, stage, gen=gen,
                                 u=reg_u)
        # m repeated n_samples times each, without repeat_interleave's
        # read of the output size from the device
        sig_m = m[:, None].expand(-1, rspec.n_samples).reshape(-1)
        loss = loss + 0.0005 * torch.sum(torch.abs(sigma) * sig_m)
    return loss


# ---------------------------------------------------------------------------
# Learning-rate trees

def _decoder_lr_tree(params, mapspec: MapSpec, dec_lr: float,
                     dec_lr_static: float):
    """Per-leaf LR for the decoders and the frozen tree (Python bools):
    in NICE mode only the fine (unless fixed) and colour (unless fixed)
    decoders train (Mapper.py:335-344); the iMAP* decoder always trains at
    imap_decoders_lr."""
    def lr_for(name):
        if not mapspec.nice:
            return mapspec.imap_decoders_lr
        if name == "fine":
            return 0.0 if mapspec.fix_fine else dec_lr
        if name == "color":
            return 0.0 if mapspec.fix_color else dec_lr
        if name == "middle":
            return dec_lr if mapspec.train_middle else 0.0
        return 0.0

    def frozen_for(name):
        if not mapspec.nice:
            return False
        if name == "fine":
            return mapspec.fix_fine or dec_lr_static == 0.0
        if name == "color":
            return mapspec.fix_color or dec_lr_static == 0.0
        if name == "middle":
            return (not mapspec.train_middle) or dec_lr_static == 0.0
        return True

    lr = {n: tree_map(lambda _, n=n: lr_for(n), sub)
          for n, sub in params.items()}
    frozen = {n: tree_map(lambda _, n=n: frozen_for(n), sub)
              for n, sub in params.items()}
    return lr, frozen


def _lr_tree(tree, stage: str, mapspec: MapSpec, lr_factor: float,
             cam_lr_mask):
    """(lr tree, frozen tree) of one stage.  Frozen-ness comes from the
    static stage table, so zero-lr leaves get no gradient at all.  iMAP*
    has no grids and no stage table; its cameras are live when BA is on."""
    if not mapspec.nice:
        dec_lr, dec_frozen = _decoder_lr_tree(tree["params"], mapspec, 0.0,
                                              1.0)
        cam_lr = (mapspec.ba_cam_lr * cam_lr_mask if mapspec.ba
                  else torch.zeros_like(cam_lr_mask))
        return ({"params": dec_lr, "grids": {},
                 "cams": cam_lr[:, None].expand(-1, 7)},
                {"params": dec_frozen, "grids": {},
                 "cams": not mapspec.ba})
    table = mapspec.stage_lr_table()[stage]
    grid_lrs = {"coarse": table.coarse, "middle": table.middle,
                "fine": table.fine, "color": table.color}
    grids_lr = {n: grid_lrs.get(n, 0.0) * lr_factor for n in tree["grids"]}
    grids_frozen = {n: grid_lrs.get(n, 0.0) == 0.0 for n in tree["grids"]}
    dec_lr, dec_frozen = _decoder_lr_tree(
        tree["params"], mapspec, table.decoders * lr_factor, table.decoders)
    cams_active = mapspec.ba and stage == "color"
    cam_lr = (mapspec.ba_cam_lr * cam_lr_mask if cams_active
              else torch.zeros_like(cam_lr_mask))
    lr = {"params": dec_lr, "grids": grids_lr,
          "cams": cam_lr[:, None].expand(-1, 7)}
    frozen = {"params": dec_frozen, "grids": grids_frozen,
              "cams": not cams_active}
    return lr, frozen


def imap_lr_scale(step: int) -> float:
    """iMAP*'s StepLR(200, 0.8) on the decoder learning rate at Adam step
    `step` (counted from 0 within one mapping call; Mapper.py:388-389)."""
    return 0.8 ** (step // 200)


def imap_lr_table(lr: float, n: int, device) -> torch.Tensor:
    """(n,) float32: the decoder learning rate at Adam steps 0..n-1,
    float32(lr * imap_lr_scale(k)) taken in double: the value that a
    multiply by the host scalar lr * scale rounds it to.  The JAX package
    takes 0.8 ** k in float32 (nice_slam_tpu/mapping.py:462)."""
    return torch.tensor([lr * imap_lr_scale(k) for k in range(n)],
                        dtype=torch.float64).to(torch.float32).to(device)


# ---------------------------------------------------------------------------
# The mapping optimisation

def _map_buffers(graphs: StepGraphs, params, grids, window, n_iters: int,
                 tag: str = "map"):
    """The static buffers of a mapping loop (made once per runner, tag,
    map shapes, window shape and capacity): the tree {"params", "grids",
    "cams"}, Adam's moments and step counter, bias tables, the losses, the
    window (colours, depths, valid), a frustum mask per grid, the BA
    learning-rate mask and the bound."""
    cap = max(n_iters, graphs.max_iters)
    leaves = tree_leaves(params)
    dev = window["depths"].device
    key = (tag, cap, tuple(window["colors"].shape),
           tuple(window["depths"].shape), dev,
           tuple(tuple(x.shape) for x in leaves),
           tuple((n, tuple(g.shape)) for n, g in grids.items()))

    def make():
        wn = window["colors"].shape[0]
        tree = {"params": tree_map(torch.empty_like, params),
                "grids": {n: torch.empty_like(g) for n, g in grids.items()},
                "cams": torch.empty(wn, 7, device=dev)}
        return SimpleNamespace(
            tree=tree, m=tree_map(torch.zeros_like, tree),
            v=tree_map(torch.zeros_like, tree),
            step=torch.zeros((), dtype=torch.int64, device=dev),
            tables=bias_tables(cap, dev),
            losses=torch.zeros(max(cap, 1), device=dev),
            window={k: torch.empty_like(window[k])
                    for k in ("colors", "depths", "valid")},
            masks={n: torch.ones(g.shape[:3] + (1,), dtype=g.dtype,
                                 device=dev) for n, g in grids.items()},
            cam_lr_mask=torch.empty(wn, device=dev),
            bound=torch.empty(3, 2, device=dev))

    return key, graphs.buffers(key, make)


@torch.no_grad()
def _load_map_buffers(b, params, grids, bound, window, cams0, masks,
                      cam_lr_mask) -> None:
    """A call's inputs copied into the loop's buffers; Adam restarts."""
    tree_map(lambda d, x: d.copy_(x), b.tree["params"], params)
    for n, g in grids.items():
        b.tree["grids"][n].copy_(g)
    b.tree["cams"].copy_(cams0)
    for mom in (b.m, b.v):
        tree_map(lambda x: x.zero_(), mom)
    b.step.zero_()
    for k in ("colors", "depths", "valid"):
        b.window[k].copy_(window[k])
    for n, mk in masks.items():
        b.masks[n].copy_(mk)
    b.cam_lr_mask.copy_(cam_lr_mask)
    b.bound.copy_(bound)


def stage_span(mapspec: MapSpec, stage: str) -> str:
    """The span of a stage's replay loop: map.middle, map.fine, map.color,
    map.coarse.iters for the coarse mapper's, map.iters in iMAP*."""
    if not mapspec.nice:
        return "map.iters"
    return "map.coarse.iters" if stage == "coarse" else "map." + stage


def map_optimize(params, grids, bound, window, cams0, masks, cam_lr_mask,
                 lr_factor: float, camera: Camera, stage_iters,
                 mapspec: MapSpec, rspec: RenderSpec, mspec: ModelSpec,
                 ba: bool = True, gen: Optional[torch.Generator] = None,
                 pixels=None, shard=None, on_iter=None,
                 graphs: Optional[StepGraphs] = None):
    """Run the staged mapping optimisation.  Adam is fresh per call and its
    moments persist across the stages.  `pixels` optionally gives every
    iteration's window draws, in order.  With BA on, NICE mode and
    mapspec.pose_gn_iters > 0, the window cameras then take that many
    guarded Gauss-Newton steps with the map frozen (nice_slam_tpu/
    mapping.py:388-395).

    `shard` (parallel/data_parallel.RayShard) makes the step data-parallel:
    each iteration renders this rank's slice of the union's draws
    (`pixels` then gives the union's), and the loss and the live gradients
    are summed over its group before the masks and Adam.  The
    data-parallel step, as the JAX package's (nice_slam_tpu/parallel/
    data_parallel.py:92-101), applies neither mapping.grad_clip nor
    iMAP*'s StepLR scale, at any world size.

    `on_iter(it, tree)`, when given, is called before the step of every
    iteration `it` (counted over the stages from 0) with the current
    {"params", "grids", "cams"} (the static buffers, between two
    replays): the per-iteration mapping panels (utils/visualizer.py).  It
    must change nothing and draw nothing from `gen`, so a run with it
    equals one without, bit for bit.

    `graphs` (the engine's mapping runner) replays each stage's iteration
    and each Gauss-Newton iteration as a captured CUDA graph on a card;
    with `shard` each iteration is a segmented step, two graphs around
    the all_reduce (the Gauss-Newton iteration three, around its two).
    Without it the loop runs eagerly.

    Returns (params, grids, cams, losses (n_iters,)): new tensors."""
    if not ba:
        mapspec = dataclasses.replace(mapspec, ba=False)
    n_iters = sum(n for _, n in stage_iters)
    graphs = graphs or StepGraphs(cams0.device, capture=False)
    bkey, b = _map_buffers(graphs, params, grids, window, n_iters)
    _load_map_buffers(b, params, grids, bound, window, cams0, masks,
                      cam_lr_mask)
    wn = window["colors"].shape[0]
    pix_buf = graphs.draw_buffers(pixels)
    # iMAP*'s StepLR rate at each step (the data-parallel step takes none)
    imap_lr = None
    if not mapspec.nice and shard is None:
        cap = max(n_iters, graphs.max_iters)
        imap_lr = graphs.buffers(
            ("imap_lr", cap, mapspec.imap_decoders_lr, b.step.device),
            lambda: imap_lr_table(mapspec.imap_decoders_lr, cap,
                                  b.step.device))

    def apply(stage, loss, grads):
        """The masks, the clip, the learning rates and Adam on the live
        gradients (in tree order); the loss recorded at the step."""
        lr_tree, frozen = _lr_tree(b.tree, stage, mapspec, lr_factor,
                                   b.cam_lr_mask)
        gl = iter(grads)
        g = tree_map(lambda x, f: None if f else next(gl), b.tree, frozen)
        for n in g["grids"]:
            if g["grids"][n] is not None:
                g["grids"][n] = g["grids"][n] * b.masks[n]
        g = tree_map(lambda x, gg, f: torch.zeros_like(x)
                     if gg is None and not f else gg, b.tree, g, frozen)
        # the data-parallel step clips nothing and scales no LR, as
        # the JAX package's (data_parallel.py:92-101)
        if mapspec.grad_clip > 0.0 and shard is None:
            gn = torch.sqrt(sum(torch.sum(x * x)
                                for x in tree_leaves(g) if x is not None))
            scale = torch.clamp(mapspec.grad_clip / (gn + 1e-12), max=1.0)
            g = tree_map(lambda x: None if x is None else x * scale, g)
        if imap_lr is not None:
            # read at the step counter before adam_step_ advances it
            lr = imap_lr.index_select(0, b.step.view(1))[0]
            lr_tree = {**lr_tree, "params": tree_map(
                lambda _: lr, lr_tree["params"])}
        with torch.no_grad():
            b.losses.index_copy_(0, b.step.view(1), loss.detach().view(1))
            adam_step_(b.tree, g, b.m, b.v, b.step, b.tables, lr_tree,
                       frozen=frozen)

    def loss_grads(stage, rspec_stage, frozen):
        tr = tree_map(lambda x, f: x if f else
                      x.detach().requires_grad_(True), b.tree, frozen)
        live = [x for x, f in zip(tree_leaves(tr), tree_leaves(frozen))
                if not f]
        reg_u = max_d = None
        pix = pix_buf
        if shard is not None:
            pix, reg_u, max_d = shard.loss_draws(
                b.window, camera, mapspec.pixels // wn, rspec, gen, pix)
        loss = mapping_loss(
            tr, b.window, b.bound, camera, stage, mapspec, rspec_stage,
            mspec, gen=gen, pix=pix, reg_u=reg_u, max_depth=max_d)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
        return live, loss, grads

    def step(stage, rspec_stage, frozen):
        _, loss, grads = loss_grads(stage, rspec_stage, frozen)
        apply(stage, loss, grads)

    def segments(stage, rspec_stage, frozen):
        """The data-parallel iteration: the draws, loss and gradients
        packed into the bucket; the all_reduce; Adam on the sums."""
        shapes = [()] + [x.shape for x, f in zip(
            tree_leaves(b.tree), tree_leaves(frozen)) if not f]
        bucket = graphs.bucket(("map", bkey, stage), shapes)

        def grads_segment():
            live, loss, grads = loss_grads(stage, rspec_stage, frozen)
            bucket.pack([loss] + [torch.zeros_like(x) if gg is None else gg
                                  for x, gg in zip(live, grads)])

        def adam_segment():
            loss, *grads = bucket.views()
            apply(stage, loss, grads)

        return ((grads_segment, adam_segment),
                (lambda: shard.reduce_(bucket, stage),), ((gen,), ()))

    it_all = 0
    for stage, n_stage in stage_iters:
        # NICE decoders only train in the colour stage
        rspec_stage = dataclasses.replace(
            rspec, train_decoders=(stage == "color" or not mapspec.nice))
        frozen = _lr_tree(b.tree, stage, mapspec, lr_factor,
                          b.cam_lr_mask)[1]
        key = ("map", bkey, stage, mapspec, rspec_stage, mspec, camera,
               lr_factor, id(gen), shard and shard.signature(),
               None if pix_buf is None else tensor_key(pix_buf))
        if shard is not None:
            segs = segments(stage, rspec_stage, frozen)
        with span(stage_span(mapspec, stage), graphs=graphs):
            for _ in range(n_stage):
                if on_iter is not None:
                    on_iter(it_all, b.tree)
                if pix_buf is not None:
                    load_draws(pix_buf, pixels[it_all])
                if shard is None:
                    graphs.step(key, lambda st=stage, rs=rspec_stage,
                                fz=frozen: step(st, rs, fz), (gen,))
                else:
                    graphs.step_segments(key, *segs)
                it_all += 1
    cams = b.tree["cams"].clone()
    if ba and mapspec.pose_gn_iters > 0 and mapspec.nice:
        # on the static buffers with the map frozen
        with span("map.ba_gn", graphs=graphs):
            cams = schur_ba.schur_pose_refine(
                b.tree["params"], b.tree["grids"], b.bound, b.window, cams,
                b.cam_lr_mask, camera,
                dataclasses.replace(rspec, train_decoders=False), mspec,
                mapspec.pose_gn_iters, mapspec.pose_gn_pixels,
                mapspec.pose_gn_damping, gen=gen, shard=shard,
                graphs=graphs)
    with span("map.writeback", graphs=graphs):
        out = b.losses[:n_iters].clone()
        params = tree_map(torch.clone, b.tree["params"])
        grids = {n: g.clone() for n, g in b.tree["grids"].items()}
    return params, grids, cams, out


def _one_map_optimize(params, grids, bound, store: KeyframeStore,
                      est_c2w: torch.Tensor, idx: int, color, depth,
                      lr_factor: float, camera: Camera, stage_iters,
                      mapspec: MapSpec, rspec: RenderSpec, mspec: ModelSpec,
                      ba: bool, gen: Optional[torch.Generator] = None,
                      dp=None, gs=None, on_iter=None, graphs=None):
    """One keyframe-window optimisation: selection + frustum masks + staged
    Adam + BA write-back (store and est_c2w updated in place).  With `dp`
    (a parallel/data_parallel.RayShard; the engine gives one when its
    process group has more than one rank) the staged Adam is
    `dp_map_optimize`, for the coarse mapper too, as
    the JAX package routes it (nice_slam_tpu/mapping.py:504-523).  With
    `gs` (a parallel/grid_sharded.GridShard; the engine then gives no
    `dp`) the NICE mapper's staged Adam is `gs_map_once`, without
    Gauss-Newton; the coarse mapper and iMAP* stay dense and local (their
    draws are in lockstep, so every rank computes the same).  `on_iter`
    and `graphs`: see `map_optimize` (under `gs` on_iter also gets the
    sharded decode).
    Returns (params, grids, losses, sel_frames): sel_frames is the
    window's frame ids (the current frame included, -2 = empty slot;
    Mapper.py:274-287)."""
    cur_c2w = est_c2w[idx]
    with span("map.prepare", graphs=graphs):
        window, masks, cams0, cam_lr_mask = prepare_mapping(
            store, color, depth, cur_c2w, grids, bound, camera, mapspec, ba,
            gen=gen, mask_names=_trained_grids(mapspec, stage_iters))
        slots = window["slots"]
        sel_frames = torch.where(
            window["valid"],
            torch.where(slots >= 0,
                        store.frame_idx[torch.clamp(slots, min=0)],
                        torch.full_like(slots, idx)),
            torch.full_like(slots, -2))
    if gs is not None and mapspec.nice and not mapspec.coarse_mapper:
        from nice_slam_torch.parallel.grid_sharded import gs_map_once
        params, grids, cams, losses = gs_map_once(
            params, grids, bound, window, cams0, masks, cam_lr_mask,
            lr_factor, camera, stage_iters, mapspec, rspec, mspec, gs,
            gen=gen, on_iter=on_iter, graphs=graphs)
    elif dp is not None:
        from nice_slam_torch.parallel.data_parallel import dp_map_optimize
        params, grids, cams, losses = dp_map_optimize(
            params, grids, bound, window, cams0, masks, cam_lr_mask,
            lr_factor, camera, stage_iters, mapspec, rspec, mspec, dp,
            ba=ba, gen=gen, on_iter=on_iter, graphs=graphs)
    else:
        params, grids, cams, losses = map_optimize(
            params, grids, bound, window, cams0, masks, cam_lr_mask,
            lr_factor, camera, stage_iters, mapspec, rspec, mspec, ba=ba,
            gen=gen, on_iter=on_iter, graphs=graphs)
    if ba:
        with torch.no_grad(), span("map.writeback", graphs=graphs):
            new_c2w = to_homogeneous(cam_from_tensor(cams))
            kf = window["valid"] & (slots >= 0) & (cam_lr_mask > 0)
            store.est_c2w[slots[kf]] = new_c2w[kf]
            est_c2w[idx] = new_c2w[-1]
    return params, grids, losses, sel_frames


def mapping_step(params, grids, bound, store: KeyframeStore,
                 est_c2w: torch.Tensor, idx: int, color, depth,
                 lr_factor: float, camera: Camera, stage_iters,
                 mapspec: MapSpec, rspec: RenderSpec, mspec: ModelSpec,
                 ba: bool, gen: Optional[torch.Generator] = None,
                 insert_kf: bool = False, gt_pose=None,
                 coarse_spec: Optional[MapSpec] = None,
                 coarse_stage_iters=(), coarse_lr_factor: float = 1.0,
                 dp=None, gs=None, on_iter=None, graphs=None):
    """One mapping event in the reference's order: the mapping optimisation
    (+BA) -> the occupancy proxy's refresh (occupancy-guided runs) ->
    keyframe insertion (insert_kf) -> the coarse mapper
    (coarse_spec; the reference's third process, NICE_SLAM.py:278-286),
    which sees the post-BA poses and the new keyframe.  `dp`, `gs`,
    `on_iter` (the mapper's optimisation only, not the coarse mapper's)
    and `graphs`: see `_one_map_optimize`.

    Returns (params, grids, losses, sel_frames)."""
    params, grids, losses, sel_frames = _one_map_optimize(
        params, grids, bound, store, est_c2w, idx, color, depth, lr_factor,
        camera, stage_iters, mapspec, rspec, mspec, ba, gen, dp, gs, on_iter,
        graphs)
    if mapspec.nice and not mapspec.coarse_mapper and "occ_proxy" in grids:
        grids = dict(grids)
        grids["occ_proxy"] = refresh_occ_proxy(params, grids, bound, mspec)
    if insert_kf:
        with span("map.keyframe", graphs=graphs):
            add_keyframe(store, color, depth, est_c2w[idx], gt_pose, idx)
    if coarse_spec is not None:
        with span("map.coarse", graphs=graphs):
            params, grids, _, _ = _one_map_optimize(
                params, grids, bound, store, est_c2w, idx, color, depth,
                coarse_lr_factor, camera, coarse_stage_iters, coarse_spec,
                rspec, mspec, False, gen, dp, gs, graphs=graphs)
    return params, grids, losses, sel_frames


@torch.no_grad()
def refresh_occ_proxy(params, grids, bound, mspec: ModelSpec):
    """The occupancy proxy decoded anew at its grid nodes (the positions its
    own trilinear reads interpolate between) from the current map: the
    fine stage's middle + fine occupancy o, stored as sigmoid(10 o), in
    one decode (nice_slam_tpu/mapping.py:709-722)."""
    shape = tuple(grids["occ_proxy"].shape[:3])
    pts = grid_node_points(bound, shape)
    raw = model_apply(params, mspec, grids, bound, pts, "fine",
                      train_decoders=False)
    return torch.sigmoid(10.0 * raw[..., 3]).reshape(shape + (1,))
