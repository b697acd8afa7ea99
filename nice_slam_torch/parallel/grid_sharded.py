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
package's `make_mesh_2d` lays out its devices.  Per decode:
- each rank interpolates from its slab only the points whose base cell
  lies in its owned rows (`slab_interp`: the other points read row 0,
  give 0 and add nothing to either gradient; every shape is static, so
  each rank gathers and scatters all the points, whatever its share:
  tools/slab_gather.py times it against the owned points alone);
- the feature rows of all the stage's levels are summed over `model` in
  one flat all_reduce (backward the identity: every model rank computes
  the same loss on the same rays, so the cotangent is already
  replicated);
- the points' cotangent through the slabs is summed over `model`, the
  transpose that JAX's shard_map inserts for a replicated input of a
  sharded computation; without it each rank's camera gradient would hold
  only its own points' grid term;
- the decoders run replicated on every model rank (`model_apply_feats`,
  which routes by `fused_route`, so at the default widths K1/K2 decode
  the summed features).
Each point has one owner and the slab interpolation keeps the dense
function's cell, corner order and lerps, so the summed features equal
`trilinear_interp` bit for bit.  `make_gs_decode_fn` composes this as
autograd Functions around the collectives (`_ModelSum`,
`_ModelBroadcast`) for the eager decodes: the sharded query
`gs_eval_points` and the panels' decode.

Per step (`gs_map_optimize`, the order of JAX `_gs_map_optimize`):
the loss and all live gradients are summed over `data`; each slab's halo
plane gradient is added to its right neighbour's row 0 and its own is
zeroed; the frustum masks apply, then Adam; the halo plane is refreshed
from the neighbour's updated row 0 (the last shard keeps its own).  The
halo exchange is an all_reduce(SUM) over `model` of an (n_model, plane)
slot buffer with one writer a slot, so it is exact, and one code path
serves gloo (which has only all_reduce and broadcast for CUDA tensors)
and NCCL.  The step is a segmented step of the mapping runner
(`_gs_step`, graphs.py `step_segments`), cut at its collectives (the
feature sum, the points' cotangent sum, the data reduce, the two halo
exchanges) on static buffers: on a card each segment is a CUDA graph and
the collectives run eagerly between the replays.  The loss's backward
is split by hand at the feature sum: the decode's backward to the
decoders, the summed features and the points; the slab interpolation
recomputed with grad for the slabs' gradient and the points' part; after
the points' sum, one backward of the recomputed rays to the cameras.
Only the rays, their normalisation and the slab gather are recomputed;
every sum keeps the dense backward's order, so at [1, 1] the step equals
the dense `map_optimize` bit for bit.

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
from nice_slam_torch.graphs import StepGraphs, load_draws, tensor_key
from nice_slam_torch.mapping import (
    MapSpec,
    _load_map_buffers,
    _lr_tree,
    _map_buffers,
    _trained_grids,
    _window_rays,
)
from nice_slam_torch.models.decoders import (
    ModelSpec,
    model_apply_feats,
    stage_levels,
)
from nice_slam_torch.ops.grid import _cell, normalize_coords, slab_trilinear
from nice_slam_torch.ops.composite import raw2outputs
from nice_slam_torch.ops.optim import adam_step_
from nice_slam_torch.ops.rays import ray_aabb_far
from nice_slam_torch.ops.sampling import sample_pdf
from nice_slam_torch.ops.tree import tree_leaves, tree_map
from nice_slam_torch.parallel.data_parallel import RayShard
from nice_slam_torch.render import RenderSpec, _zvals

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
    """(N,) bool: whether each point's base cell's X row lies in
    shard_idx's owned rows (the cell of ops/grid.trilinear_interp)."""
    x0 = _cell(tuple(global_shape) + (1,), p_nor)[0][:, 0]
    return (x0 >= shard_idx * sx) & (x0 < (shard_idx + 1) * sx)


def slab_interp(slab: torch.Tensor, p_nor: torch.Tensor, global_shape,
                shard_idx: int, sx: int) -> torch.Tensor:
    """This shard's part of the trilinear interpolation of the global grid
    at p_nor in [-1, 1]^3: (N, C), the owned points' rows equal to the
    dense interpolation's bit for bit and 0 elsewhere.  The other points
    add nothing to the slab's gradient or their own.  Every shape is
    static (no count of owned points reaches the host), so a CUDA graph
    holds it."""
    own = owned_points(p_nor, global_shape, shard_idx, sx)
    return slab_trilinear(slab, p_nor, global_shape, shard_idx * sx, own)


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
        self._groups = (id(self.model_group), id(self.data_group))
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

    def signature(self) -> tuple:
        """What a step's signature holds of this shard."""
        return ("grid", self.n_data, self.n_model, self.d, self.m,
                *self._groups)

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


def _slab_parts(slabs, p_nor: torch.Tensor, shapes, levels,
                m: int) -> torch.Tensor:
    """Model rank m's part of the features of `levels` at p_nor, flat:
    each level's (N, C) rows in turn (the buffer one all_reduce sums)."""
    return torch.cat([slab_interp(slabs[n], p_nor, shapes[n], m,
                                  slabs[n].shape[0] - 1).reshape(-1)
                      for n in levels])


def _split(flat: torch.Tensor, slabs, levels, n_pts: int) -> dict:
    """A flat feature buffer (`_slab_parts`'s layout) as {level: (N, C)}
    views."""
    feats, k = {}, 0
    for n in levels:
        c = slabs[n].shape[-1]
        feats[n] = flat[k:k + n_pts * c].reshape(n_pts, c)
        k += n_pts * c
    return feats


def _decode(params, mspec: ModelSpec, p: torch.Tensor, feats: dict,
            stage: str, train_decoders: bool, bound) -> torch.Tensor:
    """Raw (N, 4) of points p from their summed features, with the
    out-of-AABB occupancy forcing (reference Renderer.py:38-61; JAX
    grid_sharded.py:173-188)."""
    raw = model_apply_feats(params, mspec, p, feats, stage, train_decoders)
    inside = torch.all((p > bound[:, 0]) & (p < bound[:, 1]), dim=-1)
    occ = torch.where(inside, raw[..., 3],
                      torch.full_like(raw[..., 3], 100.0))
    return torch.cat([raw[..., :3], occ[..., None]], dim=-1)


def gs_feats(slabs, bound, p: torch.Tensor, shapes, levels,
             gs: GridShard, stage: str) -> dict:
    """The per-point features of `levels` from this rank's slabs, summed
    over `model` in one flat all_reduce: {level: (N, C)}, contiguous.
    `stage` names the collectives in gs's counts."""
    p_nor = normalize_coords(p, bound)
    if p_nor.requires_grad:
        p_nor = _ModelBroadcast.apply(p_nor, gs, stage)
    flat = _ModelSum.apply(_slab_parts(slabs, p_nor, shapes, levels, gs.m),
                           gs, stage)
    return _split(flat, slabs, levels, p.shape[0])


def make_gs_decode_fn(params, mspec: ModelSpec, slabs, bound, shapes,
                      stage: str, gs: GridShard, train_decoders: bool = True,
                      count_as: Optional[str] = None):
    """(M, 3) points -> raw (M, 4) from the sharded features (`_decode`).
    The collectives count under `count_as` (default the stage)."""
    def decode_fn(pp):
        feats = gs_feats(slabs, bound, pp, shapes, stage_levels(stage), gs,
                         count_as or stage)
        return _decode(params, mspec, pp, feats, stage, train_decoders,
                       bound)

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

def _halo_pack(buf: torch.Tensor, planes, slot: int) -> None:
    """The slot buffer (n_model, sum of plane sizes) zeroed and `planes`
    written into its row `slot` (none when it is out of range)."""
    buf.zero_()
    if 0 <= slot < buf.shape[0]:
        buf[slot] = torch.cat([x.reshape(-1) for x in planes])


def _halo_slots(buf: torch.Tensor, planes) -> list:
    """The (n_model, ...) slots of each of `planes` in a slot buffer."""
    out, k = [], 0
    for x in planes:
        n = x.numel()
        out.append(buf[:, k:k + n].reshape((buf.shape[0],) + tuple(x.shape)))
        k += n
    return out


def _halo_planes(planes, gs: GridShard, write_slot: int, kind: str,
                 stage: str):
    """The planes (each (ny, nz, C)) that the rank at slot `write_slot`
    wrote, as every rank reads them after one all_reduce(SUM) over `model`
    of an (n_model, sum of plane sizes) slot buffer: returns the (n_model,
    ...) slots of each plane."""
    buf = planes[0].new_zeros(gs.n_model, sum(x.numel() for x in planes))
    _halo_pack(buf, planes, write_slot)
    gs.model_sum_(buf, kind, stage)
    return _halo_slots(buf, planes)


@torch.no_grad()
def check_halos(slabs: dict, names, gs: GridShard) -> list:
    """The halo invariant, collectively: for each named slab, whether its
    halo plane equals the right neighbour's row 0 (none on the last
    shard, which keeps its own).  Its exchange counts under 'check'."""
    names = list(names)
    if not names:
        return []
    rows = _halo_planes([slabs[n][0] for n in names], gs, gs.m, "check",
                        "check")
    if gs.m + 1 >= gs.n_model:
        return []
    return [bool(torch.equal(slabs[n][-1], r[gs.m + 1]))
            for n, r in zip(names, rows)]


def _fuse(pieces, gen):
    """(segments, host calls, generators) of a step from its pieces (fn,
    host call after it or None, whether fn draws from `gen`; the last
    piece has no host call): the pieces between two host calls run as one
    segment."""
    segs, between, gens, run, draws = [], [], [], [], False
    for k, (fn, host, draw) in enumerate(pieces):
        run.append(fn)
        draws = draws or draw
        if host is None and k + 1 < len(pieces):
            continue

        def seg(fns=tuple(run)):
            for f in fns:
                f()

        segs.append(seg)
        gens.append((gen,) if draws else ())
        if host is not None:
            between.append(host)
        run, draws = [], False
    return tuple(segs), tuple(between), tuple(gens)


def _gs_step(graphs: StepGraphs, key, b, stage: str, lr_factor: float,
             camera: Camera, spec_ba: MapSpec, rspec: RenderSpec,
             rspec_stage: RenderSpec, mspec: ModelSpec, shapes,
             gs: GridShard, gen: Optional[torch.Generator], pix_buf):
    """The segments of one mapping iteration of `stage` on the static
    buffers `b`, cut at the collectives of JAX's step (nice_slam_tpu/
    parallel/grid_sharded.py:319-369):

    1. the draws, the samples along the rays and this slab's part of the
       features (the importance pass adds a decode and a second part);
       the features summed over `model`;
    2. the loss from the summed features, its backward to the decoders,
       the features and the points, and the slab interpolation recomputed
       with grad for the slabs' gradient and this slab's part of the
       points' (the feature sum's backward is the identity); the points'
       cotangent summed over `model` (when the cameras are live: the
       colour stage);
    3. the rays and points recomputed from the cameras, and one backward
       of [normalised points, points] with [summed cotangent, decoder
       cotangent] to the cameras (the dense backward's sums, in its
       order); the loss and live gradients summed over `data`;
    4. the halo plane gradients into the slot buffer; exchanged over
       `model`;
    5. each slab's halo plane gradient added to its right neighbour's row
       0, the masks, Adam; row 0 into the slot buffer; exchanged;
    6. each halo plane refreshed, the loss recorded.

    Only the rays, their normalisation and the slab gather are
    recomputed, never the decode.  Returns (segments, host calls,
    generators) for `StepGraphs.step_segments`."""
    levels = stage_levels(stage)
    frozen = _lr_tree(b.tree, stage, spec_ba, lr_factor, b.cam_lr_mask)[1]
    live = [x for x, f in zip(tree_leaves(b.tree), tree_leaves(frozen))
            if not f]
    n_params = sum(not f for f in tree_leaves(frozen["params"]))
    names = [n for n in b.tree["grids"] if not frozen["grids"][n]]
    cams_live = not frozen["cams"]
    grid_rows = not rspec_stage.occupancy and cams_live
    importance = rspec_stage.n_importance > 0
    # the samples and summed features the loss reads
    zk, fk = ("z1", "feats1") if importance else ("z0", "feats0")
    wn = b.window["colors"].shape[0]
    grids = b.tree["grids"]
    bucket = graphs.bucket(("gs", stage), [()] + [x.shape for x in live])
    planes = [grids[n][0] for n in names]
    halo_g, halo_r = (graphs.buffers(
        ("gs_halo", k, tuple(tuple(x.shape) for x in planes)),
        lambda: torch.zeros(gs.n_model, sum(x.numel() for x in planes),
                            device=graphs.device)) for k in ("g", "r"))
    # what one segment hands to a later one (static buffers made at the
    # warm-up); the host calls read it at every later iteration
    held = graphs.buffers(("gs_held", key), dict)

    def rays(cams):
        i, j = held["i"], held["j"]
        return _window_rays(b.window, cams, camera, i.shape[1], pix=(i, j))

    def points(rays_o, rays_d, z):
        pts = rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]
        return pts.reshape(-1, 3)

    def part(p):
        """This slab's part of the features of the stage's levels at p."""
        return _slab_parts(grids, normalize_coords(p, b.bound), shapes,
                           levels, gs.m)

    def split(flat, n_pts):
        return _split(flat, grids, levels, n_pts)

    def decode(params, p, feats):
        return _decode(params, mspec, p, feats, stage,
                       rspec_stage.train_decoders, b.bound)

    @torch.no_grad()
    def draw_segment():
        pix, _, max_d = gs.rays.loss_draws(
            b.window, camera, spec_ba.pixels // wn, rspec, gen, pix_buf)
        held["i"] = graphs.hold("gs_i", pix[0])
        held["j"] = graphs.hold("gs_j", pix[1])
        rays_o, rays_d, gt_d, _, _ = rays(b.tree["cams"])
        z = _zvals(rays_o, rays_d, gt_d, b.bound, rspec_stage, True, gen,
                   None, max_d)
        held["z0"] = graphs.hold("gs_z0", z)
        held["feats0"] = graphs.hold("gs_feats0",
                                     part(points(rays_o, rays_d, z)))

    @torch.no_grad()
    def importance_segment():
        rays_o, rays_d, _, _, _ = rays(b.tree["cams"])
        z = held["z0"]
        p = points(rays_o, rays_d, z)
        raw = decode(b.tree["params"], p, split(held["feats0"], p.shape[0]))
        weights = raw2outputs(raw.reshape(z.shape + (4,)), z, rays_d,
                              rspec_stage.occupancy)[3]
        z_mid = 0.5 * (z[..., 1:] + z[..., :-1])
        z_imp = sample_pdf(z_mid, weights[..., 1:-1],
                           rspec_stage.n_importance,
                           det=rspec_stage.perturb == 0.0, gen=gen)
        z, _ = torch.sort(torch.cat([z, z_imp], dim=-1), dim=-1)
        held["z1"] = graphs.hold("gs_z1", z)
        held["feats1"] = graphs.hold("gs_feats1",
                                     part(points(rays_o, rays_d, z)))

    def loss_segment():
        z = held[zk]
        with torch.no_grad():
            rays_o, rays_d, gt_d, gt_c, valid = rays(b.tree["cams"])
            p = points(rays_o, rays_d, z)
        p.requires_grad_(cams_live)
        rays_d.requires_grad_(grid_rows)
        params = tree_map(lambda x, f: x if f else
                          x.detach().requires_grad_(True), b.tree["params"],
                          frozen["params"])
        wrt = [x for x, f in zip(tree_leaves(params),
                                 tree_leaves(frozen["params"])) if not f]
        feats = held[fk].detach().requires_grad_(True)
        raw = decode(params, p, split(feats, p.shape[0]))
        t_exit = ray_aabb_far(rays_o, rays_d.detach(), b.bound)
        m = valid & (t_exit >= gt_d)
        depth, _, color, _ = raw2outputs(raw.reshape(z.shape + (4,)), z,
                                         rays_d, rspec_stage.occupancy)
        dm = (gt_d > 0) & m
        loss = torch.sum(torch.abs(gt_d - depth) * dm)
        if stage == "color":
            loss = loss + spec_ba.w_color_loss * torch.sum(
                torch.abs(gt_c - color) * m[:, None])
        wrt += [feats] + [p] * cams_live + [rays_d] * grid_rows
        d = torch.autograd.grad(loss, wrt, allow_unused=True)
        d_feats = split(d[n_params], p.shape[0])
        # the slab interpolation again, with grad: the slabs' gradient and
        # this slab's part of the points' cotangent
        slabs = {n: grids[n].detach().requires_grad_(True) for n in levels
                 if not frozen["grids"][n]}
        d_slabs, d_q = {}, None
        if slabs or cams_live:
            q = normalize_coords(p.detach(), b.bound).requires_grad_(
                cams_live)
            locs, outs = [], []
            for n in levels:
                loc = slab_interp(slabs.get(n, grids[n]), q, shapes[n], gs.m,
                                  grids[n].shape[0] - 1)
                if loc.requires_grad:
                    locs.append(loc)
                    outs.append(d_feats[n])
            got = torch.autograd.grad(
                locs, list(slabs.values()) + [q] * cams_live, outs,
                allow_unused=True)
            d_slabs = dict(zip(slabs, got))
            d_q = got[-1] if cams_live else None
        with torch.no_grad():
            vals = [loss] + [torch.zeros_like(x) if g is None else g
                             for x, g in zip(wrt, d[:n_params])]
            vals += [d_slabs.get(n) if d_slabs.get(n) is not None
                     else torch.zeros_like(grids[n]) for n in names]
            bucket.pack(vals)
            if cams_live:
                held["dq"] = graphs.hold("gs_dq", d_q)
                held["dp"] = graphs.hold(
                    "gs_dp", torch.zeros_like(p) if d[n_params + 1] is None
                    else d[n_params + 1])
                if grid_rows:
                    held["drd"] = graphs.hold("gs_drd", d[-1])

    def cams_segment():
        cams = b.tree["cams"].detach().requires_grad_(True)
        rays_o, rays_d, _, _, _ = rays(cams)
        p = points(rays_o, rays_d, held[zk])
        q = normalize_coords(p, b.bound)
        outs, seeds = [q, p], [held["dq"], held["dp"]]
        if grid_rows:
            outs.append(rays_d)
            seeds.append(held["drd"])
        (g,) = torch.autograd.grad(outs, cams, seeds)
        with torch.no_grad():
            bucket.views()[-1].copy_(g)

    @torch.no_grad()
    def halo_grads_segment():
        g = dict(zip(names, bucket.views()[1 + n_params:]))
        _halo_pack(halo_g, [g[n][-1] for n in names], gs.m + 1)

    @torch.no_grad()
    def adam_segment():
        loss, *grads = bucket.views()
        gl = iter(grads)
        g = tree_map(lambda x, f: None if f else next(gl), b.tree, frozen)
        for n, slot in zip(names, _halo_slots(halo_g, planes)):
            gg = g["grids"][n].clone()
            gg[0] += slot[gs.m]
            gg[-1] = 0.0
            g["grids"][n] = gg * b.masks[n]
        lr_tree = _lr_tree(b.tree, stage, spec_ba, lr_factor,
                           b.cam_lr_mask)[0]
        adam_step_(b.tree, g, b.m, b.v, b.step, b.tables, lr_tree,
                   frozen=frozen)
        if names:
            _halo_pack(halo_r, [grids[n][0] for n in names], gs.m)
        else:
            record_loss()

    @torch.no_grad()
    def refresh_segment():
        # the last shard keeps its own halo plane
        if gs.m + 1 < gs.n_model:
            for n, slot in zip(names, _halo_slots(halo_r, planes)):
                grids[n][-1].copy_(slot[gs.m + 1])
        record_loss()

    def record_loss():
        """The summed loss at the step Adam just took (the last segment
        records it: never an empty graph)."""
        b.losses.index_copy_(0, b.step.view(1) - 1, bucket.views()[0].view(1))

    def model_sum(name, kind):
        return lambda: gs.model_sum_(held[name], kind, stage)

    def halo_sum(buf):
        return lambda: gs.model_sum_(buf, "halo", stage)

    data = (lambda: gs.rays.reduce_(bucket, stage))
    pieces = [(draw_segment, model_sum("feats0", "features"), True)]
    if importance:
        pieces.append((importance_segment, model_sum("feats1", "features"),
                       rspec_stage.perturb > 0.0))
    if cams_live:
        pieces += [(loss_segment, model_sum("dq", "points"), False),
                   (cams_segment, data, False)]
    else:
        pieces.append((loss_segment, data, False))
    if names:
        pieces += [(halo_grads_segment, halo_sum(halo_g), False),
                   (adam_segment, halo_sum(halo_r), False),
                   (refresh_segment, None, False)]
    else:
        pieces.append((adam_segment, None, False))
    return _fuse(pieces, gen)


def gs_map_optimize(params, slabs, bound, window, cams0, mask_slabs,
                    cam_lr_mask, lr_factor: float, camera: Camera,
                    stage_iters, mapspec: MapSpec, rspec: RenderSpec,
                    mspec: ModelSpec, shapes, gs: GridShard,
                    gen: Optional[torch.Generator] = None, pixels=None,
                    on_iter=None, graphs: Optional[StepGraphs] = None):
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

    Each iteration is a segmented step of `graphs` (the mapping runner;
    without it the segments run eagerly) on static buffers: on a card each
    segment between two collectives is a CUDA graph, and the collectives
    run between their replays (`_gs_step`).

    Returns (params, slabs, cams, losses (n_iters,), summed over
    `data`)."""
    graphs = graphs or StepGraphs(cams0.device, capture=False)
    n_iters = sum(n for _, n in stage_iters)
    bkey, b = _map_buffers(graphs, params, slabs, window, n_iters, tag="gs")
    _load_map_buffers(b, params, slabs, bound, window, cams0, mask_slabs,
                      cam_lr_mask)
    pix_buf = graphs.draw_buffers(pixels)
    # cameras stay live in the colour stage whatever `ba` is: the LR mask
    # decides (JAX _lr_tree(..., ba=True))
    spec_ba = dataclasses.replace(mapspec, ba=True)
    it_all = 0
    for stage, n_stage in stage_iters:
        rspec_stage = dataclasses.replace(
            rspec, train_decoders=stage == "color", occ_guided=False)
        key = ("gs", bkey, stage, spec_ba, rspec_stage, mspec, camera,
               lr_factor, id(gen), tuple(sorted(shapes.items())),
               gs.signature(),
               None if pix_buf is None else tensor_key(pix_buf))
        segs = _gs_step(graphs, key, b, stage, lr_factor, camera, spec_ba,
                        rspec, rspec_stage, mspec, shapes, gs, gen, pix_buf)
        for _ in range(n_stage):
            if on_iter is not None:
                on_iter(it_all, b.tree, make_gs_decode_fn(
                    b.tree["params"], mspec, b.tree["grids"], b.bound,
                    shapes, "color", gs, train_decoders=False,
                    count_as="vis"))
            if pix_buf is not None:
                load_draws(pix_buf, pixels[it_all])
            graphs.step_segments(key, *segs)
            it_all += 1
    return (tree_map(torch.clone, b.tree["params"]),
            {n: g.clone() for n, g in b.tree["grids"].items()},
            b.tree["cams"].clone(), b.losses[:n_iters].clone())


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
                pixels=None, on_iter=None,
                graphs: Optional[StepGraphs] = None):
    """The engine's adapter (JAX grid_sharded.py:208-230): one mapping
    optimisation from and to the engine's dense grids, its iterations
    segmented steps of `graphs` (the engine's mapping runner).  The levels
    that the call trains are reassembled; every rank returns the same
    dense grids.  Returns (params, grids, cams, losses)."""
    slabs, shapes = shard_grids(grids, gs.n_model, gs.m)
    mask_slabs = {n: own_slab(masks[n], gs.n_model, gs.m)
                  for n in slabs if n in masks}
    params, slabs, cams, losses = gs_map_optimize(
        params, slabs, bound, window, cams0, mask_slabs, cam_lr_mask,
        lr_factor, camera, stage_iters, mapspec, rspec, mspec, shapes, gs,
        gen=gen, pixels=pixels, on_iter=on_iter, graphs=graphs)
    trained = [n for n in SHARDED_LEVELS
               if n in slabs and n in _trained_grids(mapspec, stage_iters)]
    new_grids = dict(grids)
    if trained:
        new_grids.update(reassemble({n: slabs[n] for n in trained},
                                    shapes, gs))
    return params, new_grids, cams, losses

