"""Grid-sharded mapping over a 2-D process group: the middle, fine and
colour grids cut into X-slabs over the `model` ranks, the rays over the
`data` ranks (the counterpart of the JAX package's
nice_slam_tpu/parallel/grid_sharded.py, routed as its engine.py:137-151
and mapping.py:504-517 route it).

Layout (`shard_grid_x`): shard s owns the global X rows [s*sx, (s+1)*sx),
sx = ceil(nx / n_model); row sx of its slab is a halo copy of shard s+1's
first owned row, and the padding beyond nx is zeros that are never read
(base cells are clipped to nx-2).

Rank r is (d, m) = (r // n_model, r % n_model), row-major as the JAX
package's `make_mesh_2d` lays out its devices.  Per decode
(`make_gs_decode_fn`):
- each rank interpolates only the points whose base cell lies in its
  owned rows (`slab_interp`: an index of those points, gathered and
  scattered alone, placed in a zero (N, C) tensor), so a rank's gather
  and scatter work is its slab's share;
- the feature rows of all the stage's levels are summed over `model` in
  one flat all_reduce (`_ModelSum`, backward the identity: every model
  rank computes the same loss on the same rays, so the cotangent is
  already replicated);
- the points' cotangent through the slabs is summed over `model`
  (`_ModelBroadcast`, forward the identity), the transpose that JAX's
  shard_map inserts for a replicated input of a sharded computation;
  without it each rank's camera gradient would hold only its own points'
  grid term;
- the decoders run replicated on every model rank (`model_apply_feats`,
  which routes by `fused_route`, so at the default widths K1/K2 decode
  the summed features).
Each point has one owner and the slab interpolation keeps the dense
function's cell, corner order and lerps, so the summed features equal
`trilinear_interp` bit for bit.

Per step (`gs_map_optimize`, the order of JAX `_gs_map_optimize`):
the loss and all live gradients are summed over `data`; each slab's halo
plane gradient is added to its right neighbour's row 0 and its own is
zeroed; the frustum masks apply, then Adam; the halo plane is refreshed
from the neighbour's updated row 0 (the last shard keeps its own).  The
halo exchange is an all_reduce(SUM) over `model` of an (n_model, plane)
slot buffer with one writer a slot, so it is exact, and one code path
serves gloo (which has only all_reduce and broadcast for CUDA tensors)
and NCCL.

What the JAX gs step does differently from its `map_optimize`, reproduced
here: no Gauss-Newton refinement of the BA window, no grad_clip, no
iMAP* StepLR (the mode is NICE only); no occupancy proxy in the render
(grids=None reaches it); `_lr_tree(..., ba=True)` whatever `ba` is, the
camera LR mask decides; `mapspec.pixels` is the budget of one `data`
rank.  Unlike the JAX package, whose data shards draw from
fold_in(key, data_index), every rank draws the union of the `data` ranks'
rays from the shared generator (parallel/data_parallel.RayShard), and the
render's far plane takes the union's max depth: the generators stay in
lockstep, and gs at [n_data, n_model] equals one dense process at
n_data x pixels up to summation order.

`gs_map_once` is the engine's adapter: dense -> slab -> dense per mapping
call; after it every rank holds the same dense grids (each writes its
owned rows into zeros, summed over `model`, one writer a row), so the
engine state, tracking and checkpoints stay dense.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import torch
import torch.distributed as dist

from nice_slam_torch.camera import Camera
from nice_slam_torch.mapping import (
    MapSpec,
    _lr_tree,
    _trained_grids,
    _window_rays,
)
from nice_slam_torch.models.decoders import (
    ModelSpec,
    model_apply_feats,
    stage_levels,
)
from nice_slam_torch.ops.grid import _cell, normalize_coords, slab_trilinear
from nice_slam_torch.ops.optim import adam_init, adam_update
from nice_slam_torch.ops.rays import ray_aabb_far
from nice_slam_torch.ops.tree import tree_leaves, tree_map
from nice_slam_torch.parallel.data_parallel import RayShard
from nice_slam_torch.render import RenderSpec, render_rays

SHARDED_LEVELS = ("middle", "fine", "color")


# ---------------------------------------------------------------------------
# Slab layout

def slab_rows(nx: int, n_shards: int) -> int:
    """Owned rows per shard (ceil split)."""
    return -(-nx // n_shards)


def own_slab(grid: torch.Tensor, n_shards: int, s: int) -> torch.Tensor:
    """Shard s's slab (sx+1, ny, nz, C) of `grid` (its owned rows, then the
    halo plane; zeros beyond nx)."""
    nx = grid.shape[0]
    sx = slab_rows(nx, n_shards)
    out = grid.new_zeros((sx + 1,) + tuple(grid.shape[1:]))
    rows = grid[s * sx:s * sx + sx + 1]
    out[:rows.shape[0]] = rows
    return out


def shard_grid_x(grid: torch.Tensor, n_shards: int) -> torch.Tensor:
    """(nx, ny, nz, C) -> the stacked slabs (n_shards, sx+1, ny, nz, C)."""
    return torch.stack([own_slab(grid, n_shards, s) for s in range(n_shards)])


def unshard_grid_x(slabs: torch.Tensor, nx: int) -> torch.Tensor:
    """Inverse of shard_grid_x (drops halos and padding)."""
    return slabs[:, :-1].reshape((-1,) + tuple(slabs.shape[2:]))[:nx]


def shard_grids(grids: Dict[str, torch.Tensor], n_shards: int, s: int):
    """Shard s's slab of every SHARDED_LEVELS grid: (slabs, global
    shapes (nx, ny, nz))."""
    slabs, shapes = {}, {}
    for name in SHARDED_LEVELS:
        if name in grids:
            shapes[name] = tuple(grids[name].shape[:3])
            slabs[name] = own_slab(grids[name], n_shards, s)
    return slabs, shapes


# ---------------------------------------------------------------------------
# One rank's slab interpolation

def owned_points(p_nor: torch.Tensor, global_shape, shard_idx: int,
                 sx: int) -> torch.Tensor:
    """Ids of the points whose base cell's X row lies in shard_idx's owned
    rows (the cell of ops/grid.trilinear_interp)."""
    x0 = _cell(tuple(global_shape) + (1,), p_nor)[0][:, 0]
    own = (x0 >= shard_idx * sx) & (x0 < (shard_idx + 1) * sx)
    return torch.nonzero(own).squeeze(1)


def slab_interp(slab: torch.Tensor, p_nor: torch.Tensor, global_shape,
                shard_idx: int, sx: int) -> torch.Tensor:
    """This shard's part of the trilinear interpolation of the global grid
    at p_nor in [-1, 1]^3: (N, C), the owned points' rows equal to the
    dense interpolation's bit for bit and 0 elsewhere.  Only the owned
    points are gathered (and, backward, scattered into the slab)."""
    idx = owned_points(p_nor, global_shape, shard_idx, sx)
    part = slab_trilinear(slab, p_nor[idx], global_shape, shard_idx * sx)
    out = p_nor.new_zeros(p_nor.shape[0], slab.shape[-1])
    return out.index_copy(0, idx, part)


# ---------------------------------------------------------------------------
# The 2-D process group

class GridShard:
    """Rank r of an n_data x n_model process group as (d, m) = (r //
    n_model, r % n_model), with its `model` group (the ranks of its d) and
    its `data` group (the ranks of its m), and a RayShard over the `data`
    group for the draws and the data reduce.  Every rank creates every
    sub-group, in the same order (a rank that skipped a `new_group` would
    hang the others).  Counts what it moves: bytes and calls by (kind,
    stage) and seconds by kind, the kinds 'features', 'points' (the
    points' cotangent), 'halo' and 'reassembly'; the data reduce is the
    RayShard's.  Without a process group it is [1, 1], and every sum is
    the identity (as a world-1 RayShard's)."""

    def __init__(self, n_data: int, n_model: int):
        rank, world = 0, 1
        if dist.is_available() and dist.is_initialized():
            rank, world = dist.get_rank(), dist.get_world_size()
        if world != n_data * n_model:
            raise ValueError(
                f"tpu.grid_sharded [{n_data}, {n_model}] needs "
                f"{n_data * n_model} ranks, the process group has {world}")
        self.n_data, self.n_model = n_data, n_model
        self.d, self.m = divmod(rank, n_model)
        self.model_group = self.data_group = None
        for d in range(n_data if world > 1 else 0):
            g = dist.new_group(list(range(d * n_model, (d + 1) * n_model)))
            if d == self.d:
                self.model_group = g
        for m in range(n_model if world > 1 else 0):
            g = dist.new_group(list(range(m, world, n_model)))
            if m == self.m:
                self.data_group = g
        self.rays = RayShard(group=self.data_group)
        self.bytes: dict = {}
        self.calls: dict = {}
        self.seconds: dict = {}

    def model_sum_(self, t: torch.Tensor, kind: str, stage: str):
        """all_reduce(SUM) of `t` in place over the `model` group,
        counted."""
        dev = t.device
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        if self.n_model > 1:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.model_group)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self.seconds[kind] = (self.seconds.get(kind, 0.0)
                              + time.perf_counter() - t0)
        key = (kind, stage)
        self.bytes[key] = self.bytes.get(key, 0) + t.numel() * t.element_size()
        self.calls[key] = self.calls.get(key, 0) + 1
        return t

    def stats(self) -> dict:
        """{"shape": [n_data, n_model], "bytes_per_iter": {kind: {stage:
        B}} (the data reduce under 'data', empty at n_data 1;
        'reassembly' per mapping call; the sharded query's stage 'query'
        in all), "iters" by stage, "bytes" and "seconds" by kind}."""
        iters = {k: c for k, c in self.rays.calls.items()}
        per_iter: dict = {}
        for (kind, stage), b in self.bytes.items():
            n = (self.calls[(kind, stage)] if kind == "reassembly"
                 else max(iters.get(stage, 0), 1))
            per_iter.setdefault(kind, {})[stage] = b / n
        # at n_data 1 the data reduce moves nothing
        moved = self.n_data > 1
        per_iter["data"] = (dict(self.rays.stats()["bytes_per_iter"])
                            if moved else {})
        by_kind: dict = {"data": sum(self.rays.bytes.values()) if moved
                         else 0}
        for (kind, _), b in self.bytes.items():
            by_kind[kind] = by_kind.get(kind, 0) + b
        return {"shape": [self.n_data, self.n_model],
                "bytes_per_iter": per_iter, "iters": iters,
                "bytes": by_kind,
                "seconds": {**self.seconds, "data": self.rays.seconds}}


class _ModelSum(torch.autograd.Function):
    """Forward: the sum over the `model` group.  Backward: the identity
    (the loss is the same on every model rank, so the cotangent is
    already the replicated one; summing it again would make every slab
    gradient n_model times too large)."""

    @staticmethod
    def forward(ctx, x, gs: GridShard, stage: str):
        return gs.model_sum_(x.clone(), "features", stage)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _ModelBroadcast(torch.autograd.Function):
    """Forward: the identity on a value replicated over `model`.
    Backward: the sum of the cotangent over `model` (each rank holds only
    its slab's part of it)."""

    @staticmethod
    def forward(ctx, x, gs: GridShard, stage: str):
        ctx.gs, ctx.stage = gs, stage
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return ctx.gs.model_sum_(g.clone(), "points", ctx.stage), None, None


def gs_feats(slabs, bound, p: torch.Tensor, shapes, levels,
             gs: GridShard, stage: str) -> dict:
    """The per-point features of `levels` from this rank's slabs, summed
    over `model` in one flat all_reduce: {level: (N, C)}, contiguous.
    `stage` names the collectives in gs's counts."""
    p_nor = normalize_coords(p, bound)
    if p_nor.requires_grad:
        p_nor = _ModelBroadcast.apply(p_nor, gs, stage)
    locs = [slab_interp(slabs[n], p_nor, shapes[n], gs.m,
                        slabs[n].shape[0] - 1) for n in levels]
    flat = _ModelSum.apply(torch.cat([x.reshape(-1) for x in locs]), gs,
                           stage)
    feats, k = {}, 0
    for n, x in zip(levels, locs):
        feats[n] = flat[k:k + x.numel()].reshape(x.shape)
        k += x.numel()
    return feats


def make_gs_decode_fn(params, mspec: ModelSpec, slabs, bound, shapes,
                      stage: str, gs: GridShard, train_decoders: bool = True,
                      count_as: Optional[str] = None):
    """(M, 3) points -> raw (M, 4) from the sharded features, with the
    out-of-AABB occupancy forcing (reference Renderer.py:38-61; JAX
    grid_sharded.py:173-188).  The collectives count under `count_as`
    (default the stage)."""
    def decode_fn(pp):
        feats = gs_feats(slabs, bound, pp, shapes, stage_levels(stage), gs,
                         count_as or stage)
        raw = model_apply_feats(params, mspec, pp, feats, stage,
                                train_decoders)
        inside = torch.all((pp > bound[:, 0]) & (pp < bound[:, 1]), dim=-1)
        occ = torch.where(inside, raw[..., 3],
                          torch.full_like(raw[..., 3], 100.0))
        return torch.cat([raw[..., :3], occ[..., None]], dim=-1)

    return decode_fn


@torch.no_grad()
def gs_eval_points(params, mspec: ModelSpec, slabs, bound, shapes,
                   pts: torch.Tensor, stage: str,
                   gs: GridShard) -> torch.Tensor:
    """The sharded query: raw (N, 4) of `pts` with the grids over `model`
    and the points over `data` (data rank d decodes the d-th of n_data
    contiguous chunks); every rank returns all N rows.  Its collectives
    count under 'query'."""
    n = pts.shape[0]
    chunk = -(-n // gs.n_data)
    lo, hi = min(gs.d * chunk, n), min((gs.d + 1) * chunk, n)
    raw = make_gs_decode_fn(params, mspec, slabs, bound, shapes, stage, gs,
                            train_decoders=False,
                            count_as="query")(pts[lo:hi])
    out = pts.new_zeros(n, 4)
    out[lo:hi] = raw
    if gs.n_data > 1:
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=gs.data_group)
    return out


# ---------------------------------------------------------------------------
# The sharded mapping optimisation

def gs_mapping_loss(tree, window, bound, shapes, camera: Camera, stage: str,
                    mapspec: MapSpec, rspec: RenderSpec, mspec: ModelSpec,
                    gs: GridShard, pix, max_depth,
                    gen: Optional[torch.Generator] = None):
    """mapping.mapping_loss with the sharded decode (NICE mode) on this
    rank's rays `pix` (its part of the union's draws), the render's far
    plane at the union's `max_depth`; no occupancy proxy reaches the
    render (JAX grid_sharded.py:233-258)."""
    params, slabs, cams = tree["params"], tree["grids"], tree["cams"]
    rays_o, rays_d, gt_d, gt_c, valid = _window_rays(
        window, cams, camera, pix[0].shape[1], pix=pix)
    t_exit = ray_aabb_far(rays_o.detach(), rays_d.detach(), bound)
    m = valid & (t_exit >= gt_d)
    decode_fn = make_gs_decode_fn(params, mspec, slabs, bound, shapes, stage,
                                  gs, rspec.train_decoders)
    depth, _, color, _ = render_rays(
        params, mspec, None, bound, rays_o, rays_d, rspec, stage,
        gt_depth=gt_d, gen=gen, max_depth=max_depth, decode_fn=decode_fn)
    dm = (gt_d > 0) & m
    loss = torch.sum(torch.abs(gt_d - depth) * dm)
    if stage == "color":
        loss = loss + mapspec.w_color_loss * torch.sum(
            torch.abs(gt_c - color) * m[:, None])
    return loss


def _halo_planes(planes, gs: GridShard, write_slot: int, kind: str,
                 stage: str):
    """The planes (each (ny, nz, C)) that the rank at slot `write_slot`
    wrote, as every rank reads them after one all_reduce(SUM) over `model`
    of an (n_model, sum of plane sizes) slot buffer: returns the (n_model,
    ...) slots of each plane."""
    sizes = [x.numel() for x in planes]
    buf = planes[0].new_zeros(gs.n_model, sum(sizes))
    if 0 <= write_slot < gs.n_model:
        buf[write_slot] = torch.cat([x.reshape(-1) for x in planes])
    gs.model_sum_(buf, kind, stage)
    out, k = [], 0
    for x, n in zip(planes, sizes):
        out.append(buf[:, k:k + n].reshape((gs.n_model,) + tuple(x.shape)))
        k += n
    return out


def halo_exchange_grads(grads: dict, gs: GridShard, stage: str) -> dict:
    """Each slab's halo plane gradient added to its right neighbour's row
    0, then zeroed (JAX grid_sharded.py:338-350)."""
    names = list(grads)
    slots = _halo_planes([grads[n][-1] for n in names], gs, gs.m + 1,
                         "halo", stage)
    out = {}
    for n, s in zip(names, slots):
        g = grads[n].clone()
        g[0] += s[gs.m]
        g[-1] = 0.0
        out[n] = g
    return out


@torch.no_grad()
def refresh_halos(slabs: dict, names, gs: GridShard, stage: str) -> dict:
    """The halo plane of each named slab refreshed from the right
    neighbour's row 0; the last shard keeps its own (JAX
    grid_sharded.py:357-369)."""
    names = list(names)
    slots = _halo_planes([slabs[n][0] for n in names], gs, gs.m, "halo",
                         stage)
    out = dict(slabs)
    if gs.m + 1 < gs.n_model:
        for n, s in zip(names, slots):
            sl = slabs[n].clone()
            sl[-1] = s[gs.m + 1]
            out[n] = sl
    return out


def gs_map_optimize(params, slabs, bound, window, cams0, mask_slabs,
                    cam_lr_mask, lr_factor: float, camera: Camera,
                    stage_iters, mapspec: MapSpec, rspec: RenderSpec,
                    mspec: ModelSpec, shapes, gs: GridShard,
                    gen: Optional[torch.Generator] = None, pixels=None,
                    on_iter=None):
    """The staged mapping optimisation on this rank's slabs (dict of
    (sx+1, ny, nz, C)), in the step order of JAX `_gs_map_optimize`.
    mask_slabs: the frustum masks of the trained levels in the same
    layout; shapes: the global (nx, ny, nz) by level.  A `data` rank's
    budget is mapspec.pixels; `pixels` optionally gives every iteration's
    union draws, in order (each (Wn, n_data x pixels / Wn)).
    `on_iter(it, tree, decode_fn)`, when given, is called before the step
    of every iteration with the slabs in tree["grids"] and the colour
    stage's sharded decode of them (collective: every rank calls it in
    lockstep), as mapping.map_optimize's on_iter.

    Returns (params, slabs, cams, losses (n_iters,), summed over
    `data`)."""
    tree = {"params": params, "grids": slabs, "cams": cams0.detach()}
    opt = adam_init(tree)
    wn = window["colors"].shape[0]
    # cameras stay live in the colour stage whatever `ba` is: the LR mask
    # decides (JAX _lr_tree(..., ba=True))
    spec_ba = dataclasses.replace(mapspec, ba=True)
    losses = []
    it_all = 0
    for stage, n_iters in stage_iters:
        lr_tree, frozen = _lr_tree(tree, stage, spec_ba, lr_factor,
                                   cam_lr_mask)
        rspec_stage = dataclasses.replace(
            rspec, train_decoders=stage == "color", occ_guided=False)
        for _ in range(n_iters):
            if on_iter is not None:
                on_iter(it_all, tree, make_gs_decode_fn(
                    tree["params"], mspec, tree["grids"], bound, shapes,
                    "color", gs, train_decoders=False, count_as="vis"))
            tr = tree_map(lambda x, f: x if f else
                          x.detach().requires_grad_(True), tree, frozen)
            live = [x for x, f in zip(tree_leaves(tr), tree_leaves(frozen))
                    if not f]
            pix, _, max_d = gs.rays.loss_draws(
                window, camera, mapspec.pixels // wn, rspec, gen,
                None if pixels is None else pixels[it_all])
            loss = gs_mapping_loss(tr, window, bound, shapes, camera, stage,
                                   mapspec, rspec_stage, mspec, gs, pix,
                                   max_d, gen)
            grads = torch.autograd.grad(loss, live, allow_unused=True)
            loss, *grads = gs.rays.reduce(
                [loss] + [torch.zeros_like(x) if gg is None else gg
                          for x, gg in zip(live, grads)], stage)
            gl = iter(grads)
            g = tree_map(lambda x, f: None if f else next(gl), tr, frozen)
            live_grids = {n: gg for n, gg in g["grids"].items()
                          if gg is not None}
            if live_grids:
                live_grids = halo_exchange_grads(live_grids, gs, stage)
                g["grids"] = {n: live_grids[n] * mask_slabs[n]
                              if n in live_grids else gg
                              for n, gg in g["grids"].items()}
            tree, opt = adam_update(tree, g, opt, lr_tree, frozen=frozen)
            if live_grids:
                tree["grids"] = refresh_halos(tree["grids"], live_grids, gs,
                                              stage)
            losses.append(loss.detach())
            it_all += 1
    out = torch.stack(losses) if losses else torch.zeros(0)
    return tree["params"], tree["grids"], tree["cams"], out


@torch.no_grad()
def reassemble(slabs: dict, shapes: dict, gs: GridShard) -> dict:
    """The dense grids from every model rank's slabs: each rank writes its
    owned rows into zeros, one all_reduce(SUM) over `model` (one writer a
    row, so exact)."""
    names = list(slabs)
    dense = []
    for n in names:
        nx = shapes[n][0]
        sx = slabs[n].shape[0] - 1
        d = slabs[n].new_zeros((nx,) + tuple(slabs[n].shape[1:]))
        lo, hi = min(gs.m * sx, nx), min((gs.m + 1) * sx, nx)
        d[lo:hi] = slabs[n][:hi - lo]
        dense.append(d)
    flat = torch.cat([d.reshape(-1) for d in dense])
    gs.model_sum_(flat, "reassembly", "call")
    out, k = {}, 0
    for n, d in zip(names, dense):
        out[n] = flat[k:k + d.numel()].reshape(d.shape)
        k += d.numel()
    return out


def gs_map_once(params, grids, bound, window, cams0, masks, cam_lr_mask,
                lr_factor: float, camera: Camera, stage_iters,
                mapspec: MapSpec, rspec: RenderSpec, mspec: ModelSpec,
                gs: GridShard, gen: Optional[torch.Generator] = None,
                pixels=None, on_iter=None):
    """The engine's adapter (JAX grid_sharded.py:208-230): one mapping
    optimisation from and to the engine's dense grids.  The levels that
    the call trains are reassembled; every rank returns the same dense
    grids.  Returns (params, grids, cams, losses)."""
    slabs, shapes = shard_grids(grids, gs.n_model, gs.m)
    mask_slabs = {n: own_slab(masks[n], gs.n_model, gs.m)
                  for n in slabs if n in masks}
    params, slabs, cams, losses = gs_map_optimize(
        params, slabs, bound, window, cams0, mask_slabs, cam_lr_mask,
        lr_factor, camera, stage_iters, mapspec, rspec, mspec, shapes, gs,
        gen=gen, pixels=pixels, on_iter=on_iter)
    trained = [n for n in SHARDED_LEVELS
               if n in slabs and n in _trained_grids(mapspec, stage_iters)]
    new_grids = dict(grids)
    if trained:
        new_grids.update(reassemble({n: slabs[n] for n in trained},
                                    shapes, gs))
    return params, new_grids, cams, losses

