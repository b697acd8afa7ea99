"""Ray-data-parallel mapping over a process group (the counterpart of the
JAX package's nice_slam_tpu/parallel/data_parallel.py:39-168).

Every rank holds a full replica of the map and renders its own slice of
the mapping rays; the loss and the live gradients are summed over the
group, so Adam takes the same step on every rank.  The step is the port's
own `mapping.map_optimize` with a `RayShard` as its hook, not a second
copy of the staged loop.  Per iteration, in order:

1. every rank draws the UNION of the ranks' rays from the shared
   generator, (Wn, world x pixels/Wn) pixel indices (and for iMAP* the
   regulation jitter of the same rays), and keeps its own contiguous
   slice of each frame's columns; the render's far plane takes the
   union's max sensor depth;
2. the loss and the live gradients are all_reduce(SUM)-ed in one flat
   bucket (one call, not one per leaf);
3. the frustum masks apply, then Adam runs identically on every rank.

With Gauss-Newton on, each GN iteration draws the union's pixels the same
way (per-frame max depth over the union) and sums (H, b, sse0) and (sse1,
cnt0, cnt1) through the same bucketed reduce (`schur_ba`).

On a card each iteration is a segmented step of the mapping runner
(graphs.py `step_segments`): the Adam iteration is two CUDA graphs, the
draws, loss and gradients packed into a static `Bucket`, then the
masks and Adam reading its sums, with the all_reduce run eagerly
between their replays; a Gauss-Newton iteration is three graphs around
its two reduces.  The graphed run equals the eager run of the same
segments bit for bit.

Drawing the union keeps every rank's generator in lockstep: keyframe
selection, tracking and everything else stay bit-identical across ranks,
as the JAX package's replicated state does.  And since the mapping loss
is a sum over rays, data parallelism at world W equals one process
drawing W x pixels on the same stream, up to summation order
(tests/test_torch_parallel.py).  The JAX package draws from per-device
keys instead.  Draws made inside the render (the stratified jitter when
rendering.perturb > 0, off in every config) stay the rank's own: equal
counts on every rank, so the lockstep holds, but they are not the
union's.

mapspec.pixels is the budget of one rank, as in the JAX package: a step
renders world x pixels rays.  As the JAX DP step (nice_slam_tpu/parallel/
data_parallel.py:92-101), this one applies neither mapping.grad_clip nor
iMAP*'s StepLR scale, which the local step applies (mapping.py:455-462
there): a quirk of the reference package, kept on purpose, at every world
size, one rank included.  In NICE mode (grad_clip 0, no StepLR) the DP
step and the local step take the same update.
"""

from __future__ import annotations

import time
from typing import Optional

import torch
import torch.distributed as dist

from nice_slam_torch.camera import Camera
from nice_slam_torch.graphs import Bucket, StepGraphs
from nice_slam_torch.mapping import MapSpec, map_optimize
from nice_slam_torch.models.decoders import ModelSpec
from nice_slam_torch.parallel.schur_ba import window_pixels
from nice_slam_torch.render import RenderSpec


class RayShard:
    """This rank's part of a union ray batch, and the reduce over the
    group (the default group; without a process group, world 1: the
    union is this process's batch and the reduce is the identity).
    Counts what it moves: `bytes` and `calls` by stage ('gn' for the
    Gauss-Newton reduces) and `seconds`, the host time inside all_reduce
    with the device synchronised before and after."""

    def __init__(self, group=None):
        self.group = group
        if dist.is_available() and dist.is_initialized():
            self.rank = dist.get_rank(group)
            self.world = dist.get_world_size(group)
        else:
            self.rank, self.world = 0, 1
        self.bytes: dict = {}
        self.calls: dict = {}
        self.seconds = 0.0

    def signature(self) -> tuple:
        """What a step's signature holds of this shard."""
        return ("shard", self.world, self.rank, id(self.group))

    # -- draws -------------------------------------------------------------

    def part(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's contiguous slice of dim 1 of a union draw."""
        n = x.shape[1] // self.world
        return x[:, self.rank * n:(self.rank + 1) * n]

    def loss_draws(self, window, camera: Camera, n_pix: int,
                   rspec: RenderSpec, gen: Optional[torch.Generator],
                   pix=None):
        """The draws of one mapping loss: (pix, reg_u, max_depth) for this
        rank.  `pix` = (i, j), each (Wn, world x n_pix), gives the union's
        pixels; else they are drawn from `gen`, as one process drawing
        world x n_pix pixels a frame draws them."""
        wn = window["colors"].shape[0]
        dev = window["depths"].device
        if pix is None:
            pix = window_pixels(gen, wn, self.world * n_pix, camera, dev)
        i, j = pix
        f = torch.arange(wn, device=dev)[:, None]
        max_depth = torch.max(window["depths"][f, j.long(), i.long()])
        reg_u = None
        if not rspec.occupancy:
            u = torch.rand((i.numel(), rspec.n_samples), generator=gen,
                           device=dev)
            reg_u = self.part(u.reshape(wn, i.shape[1], -1)).reshape(
                -1, rspec.n_samples)
        return (self.part(i), self.part(j)), reg_u, max_depth

    def gn_draws(self, window, camera: Camera, n_pix: int,
                 gen: Optional[torch.Generator], pix=None):
        """One Gauss-Newton sample for this rank: (pix, frame_max_depth
        (Wn,)), the union's `pix` given or drawn as in `loss_draws`."""
        wn = window["colors"].shape[0]
        dev = window["depths"].device
        if pix is None:
            pix = window_pixels(gen, wn, self.world * n_pix, camera, dev)
        i, j = pix
        f = torch.arange(wn, device=dev)[:, None]
        frame_max = torch.amax(window["depths"][f, j.long(), i.long()],
                               dim=1)
        return (self.part(i), self.part(j)), frame_max

    # -- the reduce --------------------------------------------------------

    def reduce_(self, bucket: Bucket, kind: str = "gn") -> None:
        """all_reduce(SUM) of a `Bucket` over the group, in place, in one
        call, counted under `kind` (a stage, or 'gn': a Gauss-Newton
        iteration reduces twice).  The host call between two segments of
        a step (graphs.StepGraphs.step_segments): it runs on the caller's
        stream, outside any capture."""
        flat = bucket.flat
        dev = flat.device
        if self.world > 1:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=self.group)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            self.seconds += time.perf_counter() - t0
        self.bytes[kind] = (self.bytes.get(kind, 0)
                            + flat.numel() * flat.element_size())
        self.calls[kind] = self.calls.get(kind, 0) + 1

    def stats(self) -> dict:
        """{"world", "bytes_per_iter" and "iters" by stage ('gn' counts
        Gauss-Newton iterations), "bytes" in all, "seconds"}."""
        iters = {k: c // 2 if k == "gn" else c for k, c in self.calls.items()}
        return {"world": self.world,
                "bytes_per_iter": {k: self.bytes[k] / max(iters[k], 1)
                                   for k in self.bytes},
                "iters": iters, "bytes": sum(self.bytes.values()),
                "seconds": self.seconds}


def dp_map_optimize(params, grids, bound, window, cams0, masks, cam_lr_mask,
                    lr_factor: float, camera: Camera, stage_iters,
                    mapspec: MapSpec, rspec: RenderSpec, mspec: ModelSpec,
                    shard: RayShard, ba: bool = True,
                    gen: Optional[torch.Generator] = None, pixels=None,
                    on_iter=None, graphs: Optional[StepGraphs] = None):
    """Data-parallel `map_optimize`: the same staged schedule, each
    iteration's loss and gradients summed over `shard`'s group, with a
    rank budget of mapspec.pixels rays (world x pixels a step).  `pixels`
    optionally gives every iteration's union draws, in order; `on_iter`
    as in `map_optimize` (every rank calls it in lockstep); `graphs`: the
    mapping runner, whose segments the iterations replay.

    Returns (params, grids, cams, losses (n_iters,)), the losses summed
    over the group."""
    return map_optimize(params, grids, bound, window, cams0, masks,
                        cam_lr_mask, lr_factor, camera, stage_iters, mapspec,
                        rspec, mspec, ba=ba, gen=gen, pixels=pixels,
                        shard=shard, on_iter=on_iter, graphs=graphs)
