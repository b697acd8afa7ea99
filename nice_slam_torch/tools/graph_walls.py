"""Walls of the synthetic config's mode paths, eager against graphed.

    python3 -m nice_slam_torch.tools.graph_walls [imap gn occ vis dp gs]

Runs each named path of configs/Synthetic/synthetic.yaml at full width
and at chip_smoke.py's depth for it (iMAP* 5 frames, GN + BA 13, occupancy
11, the panels 11, data-parallel and grid-sharded [1, 2] 6) four times in
one process on one GPU: eager, graphed, graphed, eager, each on a fresh
engine after the earlier ones are freed.  The parallel paths run two
ranks on the card over gloo, each rank a process of its own (started by
this script, `--rank`) that makes the four runs in the one process
group.  An eager run is the engine with runners that never capture
(`StepGraphs(capture=False)`, as chip_smoke.py's eager gates run it).
Prints the card (nvidia-smi name and power limit) and one JSON line a
run (and rank): the wall (host clock around `SlamEngine.run` and a
synchronize), track and map seconds, the collectives' seconds (host
clock between two synchronisations), ATE, the peak device memory and
what was held at the start, and the runners' graphs, replays, eager
steps and host calls.

The package measured is the `nice_slam_torch` that imports first, with
its own configs.  To measure another checkout (a parent commit's), run
this file by its path with that checkout first on PYTHONPATH:

    PYTHONPATH=<checkout> python3 nice_slam_torch/tools/graph_walls.py imap
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time

import torch

import nice_slam_torch
from nice_slam_torch.config import load_config
from nice_slam_torch.engine import SlamEngine
from nice_slam_torch.graphs import StepGraphs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(
    nice_slam_torch.__file__)))
# (NICE, frames, overrides): chip_smoke.py's phases 9, 12, 13 and 20
PATHS = {
    "imap": (False, 5, {"scale": 1.0}),
    "gn": (True, 13, {"mapping": {"every_frame": 2, "keyframe_every": 2,
                                  "pose_GN_iters": 2},
                      "tracking": {"pose_GN_iters": 2}}),
    "occ": (True, 11, {"rendering": {"occupancy_guided": True}}),
    "vis": (True, 11, {"tracking": {"vis_freq": 5, "vis_inside_freq": 25},
                       "mapping": {"vis_freq": 5, "vis_inside_freq": 25}}),
    # chip_smoke.py's phases 15 and 19 (two ranks)
    "dp": (True, 6, {"tpu": {"data_parallel": True, "mesh_shape": [2]}}),
    "gs": (True, 6, {"tpu": {"grid_sharded": [1, 2]}}),
}
# the paths that run over a process group, and its size
WORLD = {"dp": 2, "gs": 2}


def run_path(name: str, graphed: bool, device: str = "cuda") -> dict:
    nice, n_frames, over = PATHS[name]
    over = json.loads(json.dumps(over))
    over.update(synthetic={"n_frames": n_frames},
                data={"output": os.path.join(ROOT, "output",
                                             f"graph_walls_{name}")})
    cfg = load_config(os.path.join(ROOT, "configs", "Synthetic",
                                   "synthetic.yaml"), nice=nice,
                      overrides=over)
    eng = SlamEngine(cfg, device=device)
    if not graphed:
        eng._track_graphs = StepGraphs(eng._track_graphs.device,
                                       capture=False)
        eng._map_graphs = StepGraphs(eng._map_graphs.device, capture=False,
                                     max_iters=eng._map_graphs.max_iters)
    if name == "vis":
        eng.enable_visualizer()
    for i in range(n_frames):
        eng.dataset[i]   # the dataset renders frames on the host
    cuda = eng.device.type == "cuda"
    gc.collect()
    if cuda:
        torch.cuda.synchronize()
        torch._C._cuda_clearCublasWorkspaces()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2**20 if cuda else 0.0
    t0 = time.perf_counter()
    eng.run(n_frames)
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = eng.graph_stats()
    coll = 0.0
    if eng.dp is not None:
        coll = eng.dp.seconds
    elif eng.gs is not None:
        coll = sum(eng.gs.stats()["seconds"].values())
    return {"path": name, "graphed": graphed, "rank": eng.rank,
            "wall_s": wall, "track_s": eng.timings["track"],
            "map_s": eng.timings["map"], "collective_s": coll,
            "ate_rmse_m": eng.ate()["rmse"],
            "peak_mib": (torch.cuda.max_memory_allocated() / 2**20
                         if cuda else None),
            "held_mib": held,
            **{k: sum(s[k] for s in stats.values())
               for k in ("graphs", "replays", "eager_steps",
                         "host_calls")}}


ORDER = (False, True, True, False)


def rank_main(name: str, rank: int, port: int, device: str) -> None:
    """One rank of a parallel path: its four runs in one process group."""
    from nice_slam_torch.parallel import multihost

    multihost.initialize(f"127.0.0.1:{port}", WORLD[name], rank,
                         timeout_s=300, device=device)
    for graphed in ORDER:
        print(json.dumps(run_path(name, graphed, device)), flush=True)
    multihost.shutdown()


def run_ranks(name: str, device: str = "cuda") -> None:
    """A parallel path's ranks, each this script with --rank; prints their
    JSON lines, rank 0's first."""
    from nice_slam_torch.parallel.multihost import free_port

    port = free_port()
    # the ranks import the package measured here
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p])}
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), name, "--rank", str(r),
         "--port", str(port), "--device", device],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for r in range(WORLD[name])]
    outs = [p.communicate()[0] for p in procs]
    for p, out in zip(procs, outs):
        if p.returncode != 0:
            raise SystemExit(f"{name}: a rank exited {p.returncode}: "
                             f"{out[-3000:]}")
        print("\n".join(line for line in out.splitlines()
                        if line.startswith("{")), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("paths", nargs="*", default=list(PATHS),
                    choices=list(PATHS))
    # one rank of a parallel path, started by this script
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    args = ap.parse_args()
    from nice_slam_torch.ops import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    if args.rank is not None:
        if args.device == "cuda":
            cuda_build.build_all()   # loads the parent's build
        rank_main(args.paths[0], args.rank, args.port, args.device)
        return 0
    cuda_build.build_all()   # not inside the first run's wall
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip())
    print(f"package {os.path.dirname(nice_slam_torch.__file__)}", flush=True)
    for name in args.paths:
        if name in WORLD:
            run_ranks(name)
            continue
        for graphed in ORDER:
            print(json.dumps(run_path(name, graphed)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
