"""Device time of one rank's slab interpolation in grid-sharded mapping:
every point (the static-shape form a CUDA graph of the step holds)
against only the rank's owned points (the form whose index depends on
the data).

    python3 -m nice_slam_torch.tools.slab_gather [--reps 50]

The points are those of one grid-sharded mapping iteration of
configs/Synthetic/synthetic.yaml at full width: the mapping budget's rays
(1,000 over a window of keyframes 0, 2, 4, 6 and frame 8 at their GT
poses) and the depth-guided samples along them (N_samples + N_surface a
ray), normalised to the mapping bound.  The grids are the colour stage's
levels (middle, fine, colour) at the config's shapes, random from a seed.
For n_model 1, 2 and 4 and each model rank m it times, on one GPU, one
forward and one backward (the slab's gradient and the points') of the
three levels' slab interpolation:

- `all_ms`: `grid_sharded.slab_interp`, every point gathered (left-out
  points read row 0) and scattered (into a sink row), captured in a CUDA
  graph and replayed;
- `owned_graphed_ms`: only the owned points, their index found once
  outside the timing, so the gather and scatter see owned rows only,
  captured and replayed: the least device work of the owned-only form;
- `owned_eager_ms`: the owned-only form as it runs without graphs, the
  index found by `torch.nonzero` every call (a host synchronisation).

Each time is the mean over --reps calls between two CUDA events, after a
warm-up.  n_model 1 is one process's dense interpolation.  Prints the
card (nvidia-smi name and power limit) and one JSON line a (n_model, m).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess

import torch

import nice_slam_torch
from nice_slam_torch.config import load_config
from nice_slam_torch.engine import SlamEngine
from nice_slam_torch.keyframes import add_keyframe
from nice_slam_torch import mapping
from nice_slam_torch.models.decoders import stage_levels
from nice_slam_torch.ops.grid import normalize_coords, slab_trilinear
from nice_slam_torch.parallel.grid_sharded import (
    owned_points,
    own_slab,
    slab_interp,
    slab_rows,
)
from nice_slam_torch.parallel.schur_ba import window_pixels
from nice_slam_torch.render import _zvals

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(
    nice_slam_torch.__file__)))


def step_points(dev) -> tuple:
    """(normalised points (N, 3), the map's grids) of one mapping
    iteration of the synthetic config."""
    cfg = load_config(os.path.join(ROOT, "configs", "Synthetic",
                                   "synthetic.yaml"),
                      overrides={"synthetic": {"n_frames": 9}})
    eng = SlamEngine(cfg, device=str(dev))
    frames = {k: eng._load_frame(k) for k in (0, 2, 4, 6, 8)}
    for k in (0, 2, 4, 6):
        c, d, p = frames[k]
        pose = torch.as_tensor(p, device=dev)
        add_keyframe(eng.store, c, d, pose, pose, k)
    c, d, p = frames[8]
    spec = eng.specs.mapper
    gen = torch.Generator(device=dev).manual_seed(1)
    window, _, cams, _ = mapping.prepare_mapping(
        eng.store, c, d, torch.as_tensor(p, device=dev), eng.map_state.grids,
        eng.bound, eng.specs.camera, spec, True, gen=gen)
    wn = window["colors"].shape[0]
    pix = window_pixels(gen, wn, spec.pixels // wn, eng.specs.camera, dev)
    with torch.no_grad():
        rays_o, rays_d, gt_d, _, _ = mapping._window_rays(
            window, cams, eng.specs.camera, pix[0].shape[1], pix=pix)
        z = _zvals(rays_o, rays_d, gt_d, eng.bound, eng.specs.render, True,
                   gen)
        pts = (rays_o[:, None, :] + rays_d[:, None, :] * z[..., None])
        q = normalize_coords(pts.reshape(-1, 3), eng.bound)
    return q, eng.map_state.grids


def _owned_only(slab, q, shape, m, sx, idx=None):
    """The owned points' rows (the rest 0), gathering only those."""
    if idx is None:
        idx = torch.nonzero(owned_points(q, shape, m, sx)).squeeze(1)
    part = slab_trilinear(slab, q[idx], shape, m * sx)
    return q.new_zeros(q.shape[0], slab.shape[-1]).index_copy(0, idx, part)


def _timed(fn, reps: int, graphed: bool) -> float:
    """Mean ms of fn() over `reps` calls (replays when `graphed`)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    call = fn
    if graphed:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            fn()
        call = g.replay
    call()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(reps):
        call()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def measure(reps: int, dev) -> list:
    q0, grids = step_points(dev)
    levels = stage_levels("color")
    n = q0.shape[0]
    seeds = {lv: torch.randn(n, grids[lv].shape[-1], device=dev,
                             generator=torch.Generator(device=dev)
                             .manual_seed(k))
             for k, lv in enumerate(levels)}
    out = []
    for n_model in (1, 2, 4):
        for m in range(n_model):
            slabs = {lv: own_slab(grids[lv], n_model, m).requires_grad_(True)
                     for lv in levels}
            sx = {lv: slab_rows(grids[lv].shape[0], n_model)
                  for lv in levels}
            shape = {lv: tuple(grids[lv].shape[:3]) for lv in levels}
            q = q0.clone().requires_grad_(True)
            idx = {lv: torch.nonzero(owned_points(q0, shape[lv], m, sx[lv]))
                   .squeeze(1) for lv in levels}

            def run(interp):
                locs = [interp(lv) for lv in levels]
                torch.autograd.grad(locs, list(slabs.values()) + [q],
                                    [seeds[lv] for lv in levels])

            def every(lv):
                return slab_interp(slabs[lv], q, shape[lv], m, sx[lv])

            def owned_given(lv):
                return _owned_only(slabs[lv], q, shape[lv], m, sx[lv],
                                   idx[lv])

            def owned_found(lv):
                return _owned_only(slabs[lv], q, shape[lv], m, sx[lv])

            out.append({
                "n_model": n_model, "m": m, "points": n,
                "owned": {lv: int(idx[lv].numel()) for lv in levels},
                "all_ms": _timed(lambda: run(every), reps, True),
                "owned_graphed_ms": _timed(lambda: run(owned_given), reps,
                                           True),
                "owned_eager_ms": _timed(lambda: run(owned_found), reps,
                                         False)})
            print(json.dumps(out[-1]), flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    measure(args.reps, torch.device("cuda"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
