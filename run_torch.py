#!/usr/bin/env python
"""Run the PyTorch port's SLAM engine (nice_slam_torch) on a scene config.

Usage:
    python run_torch.py configs/Synthetic/synthetic.yaml --frames 11
    python run_torch.py --synthetic 40           # built-in synthetic scene
    python run_torch.py <config> --device cpu    # plain PyTorch, no kernels
    python run_torch.py <config> --imap          # iMAP* mode
    python run_torch.py <config> --resume <output>/ckpts/00050.npz
    python run_torch.py <config> --resume <output>   # its latest checkpoint
    python run_torch.py <config> --no-mesh       # write no mesh
    python run_torch.py <config> --profile LOGDIR  # LOGDIR/trace.json
    python run_torch.py <config> --vis           # residual panels
    # data-parallel mapping on n local ranks (tpu.data_parallel: true,
    # tpu.mesh_shape: [n]), or one rank of a launch across hosts (the
    # tpu.multihost keys or NICE_SLAM_TPU_COORDINATOR / _NUM_PROCESSES /
    # _PROCESS_ID in each process's environment):
    python run_torch.py <config with tpu.data_parallel>
    # grid-sharded mapping on n_data x n_model local ranks
    # (tpu.grid_sharded: [n_data, n_model]):
    python run_torch.py <config with tpu.grid_sharded>
    python run_torch.py <config with tpu.pipelined>   # tracker | mapper

The port runs NICE-SLAM and iMAP* under strict, loose and free sync on one
GPU, with the fused decode as CUDA kernels, writes checkpoints
(<output>/ckpts/{idx:05d}.npz, the JAX package's format: either package
resumes the other's) and meshes (<output>/mesh/{idx:05d}_mesh.ply every
mapping.mesh_freq frames and final_mesh.ply at the last frame; the
marching tetrahedra are host C++, built with g++ at first use).  The
config's Gauss-Newton pose refinement (tracking / mapping.pose_GN_iters),
occupancy-guided sampling (rendering.occupancy_guided) and the
reference's .pt decoders (pretrained_decoders.coarse / middle_fine, read
when the repository's npz is absent) run too.  --profile writes a
torch.profiler Chrome trace of the run.

Parallel modes: with tpu.data_parallel, tpu.mesh_shape [n] (n > 1) and
no multi-process config, the script starts n local ranks
(torch.multiprocessing, a free port) that map data-parallel
(nice_slam_torch/parallel/data_parallel.py); with a multi-process config
(tpu.multihost or the NICE_SLAM_TPU_* environment) this process is one
rank of such a group (parallel/multihost.py).  With tpu.grid_sharded
[n_data, n_model] (n_model > 1) the script starts n_data x n_model local
ranks the same way, and the NICE mapper runs with its grids in X-slabs
over the `model` ranks and its rays over the `data` ranks
(parallel/grid_sharded.py); it takes precedence over tpu.data_parallel.
tpu.pipelined runs the tracker and the mapper at the same time, the
mapper on a thread and CUDA stream of its own, on two cards or both on
one (parallel/pipelined.py).

--vis draws the reference's debug panels per optimisation iteration
(tracking and mapping .vis_freq / .vis_inside_freq) into
<output>/tracking_vis and <output>/mapping_vis (mapping only under
tpu.pipelined): {idx:05d}_{it:04d}.npz always, and the .jpg where
matplotlib imports; `python -m nice_slam_torch.utils.visualizer <dir>`
draws the jpgs of a run made without it.

A single-process run that fails on a transient rendezvous or transport
error (nice_slam_torch/utils/retry.py) is retried up to twice, each retry
resuming from the newest checkpoint in the output directory (run.py's
retry).  A rank of a multi-rank launch does not retry alone: the failure
ends the launch, and --resume <output> restarts it.

Every rank prints a JSON summary (ate_rmse_m, ate_mean_m, frames,
timings_s, its rank and world size, the group's backend, digests of its
trajectory and of its map, the fused decode's launches, its CUDA-graph
runners' counts (graphs, of them the segments of data-parallel and
grid-sharded mapping steps, signatures, captures, replays, eager steps
and host calls between segments, by side), the all_reduce's bytes and
seconds, the files it wrote, ...); only rank 0 writes files:
<output>/ate.json, the estimated trajectory <output>/traj_est.npy
((frames, 4, 4) camera-to-world), checkpoints and meshes.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time


def _local_rank(rank: int, argv: list, port: int, world: int):
    """Entry of a local rank: the launcher's environment, an equal share
    of the host's cores (unless OMP_NUM_THREADS says otherwise: the ranks'
    threads would otherwise contend with gloo's), then main."""
    if "OMP_NUM_THREADS" not in os.environ:
        import torch

        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    os.environ.update({"NICE_SLAM_TPU_COORDINATOR": f"127.0.0.1:{port}",
                       "NICE_SLAM_TPU_NUM_PROCESSES": str(world),
                       "NICE_SLAM_TPU_PROCESS_ID": str(rank),
                       "LOCAL_RANK": str(rank)})
    main(argv)


def local_ranks(cfg: dict) -> int:
    """How many local ranks to start, with no multi-process config: n_data
    x n_model for tpu.grid_sharded [n_data, n_model] with n_model > 1 (it
    takes precedence), n for tpu.data_parallel with tpu.mesh_shape [n],
    else 1."""
    tpu = cfg.get("tpu", {})
    if tpu.get("multihost") or os.environ.get("NICE_SLAM_TPU_COORDINATOR"):
        return 1
    gs = tpu.get("grid_sharded")
    if gs:
        return int(gs[0]) * int(gs[1]) if int(gs[1]) > 1 else 1
    shape = tpu.get("mesh_shape")
    if not tpu.get("data_parallel") or not shape:
        return 1
    return int(shape[0])


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="nice-slam PyTorch port runner (NICE-SLAM and iMAP*, "
                    "strict/loose/free sync, checkpoint and resume, "
                    "meshing, Gauss-Newton poses, occupancy-guided "
                    "sampling, data-parallel and grid-sharded mapping, the "
                    "pipelined engine, the visualizer panels)")
    ap.add_argument("config", nargs="?", default=None,
                    help="scene config yaml")
    ap.add_argument("--input_folder", type=str, default=None,
                    help="overrides the input folder in the config")
    ap.add_argument("--output", type=str, default=None,
                    help="overrides the output folder in the config")
    # run.py's mutually exclusive pair: NICE-SLAM (the default) or iMAP*
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--nice", action="store_true", default=True,
                      help="NICE-SLAM mode (the default)")
    mode.add_argument("--imap", action="store_false", dest="nice",
                      help="iMAP* mode (one density MLP, no grids)")
    ap.add_argument("--resume", type=str, default=None, metavar="CKPT",
                    help="resume from a checkpoint .npz of either package, "
                         "or from the latest one in an output directory "
                         "(its ckpts/) or a ckpts directory")
    ap.add_argument("--synthetic", type=int, default=None, metavar="N",
                    help="run on the built-in synthetic scene with N frames")
    ap.add_argument("--frames", type=int, default=None,
                    help="limit the number of frames processed")
    ap.add_argument("--seed", type=int, default=None,
                    help="override the seed (tpu.seed in the config)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch versions of the kernels)")
    ap.add_argument("--no-mesh", action="store_true",
                    help="skip mesh extraction")
    ap.add_argument("--vis", action="store_true",
                    help="save GT/rendered/residual panels per tracking "
                         "and mapping iteration (npz, and jpg where "
                         "matplotlib imports)")
    ap.add_argument("--profile", type=str, default=None, metavar="LOGDIR",
                    help="write a torch.profiler Chrome trace of the run to "
                         "LOGDIR/trace.json")
    return ap


def run_config(args) -> dict:
    """The resolved config of a parsed command line: the scene yaml with
    the command line's overrides (input and output folders, seed, the
    synthetic scene) and mode."""
    from nice_slam_torch.config import load_config

    overrides = {}
    if args.synthetic is not None:
        if args.config is None:
            args.config = os.path.join(
                os.path.dirname(os.path.abspath(__file__)),
                "configs", "Synthetic", "synthetic.yaml")
            overrides = {"data": {"output": "output/synthetic_torch"}}
        overrides["dataset"] = "synthetic"
        overrides["synthetic"] = {"n_frames": args.synthetic}
    if args.seed is not None:
        overrides.setdefault("tpu", {})["seed"] = args.seed
    if args.input_folder:
        overrides.setdefault("data", {})["input_folder"] = args.input_folder
    if args.output:
        overrides.setdefault("data", {})["output"] = args.output
    return load_config(args.config, nice=args.nice, overrides=overrides)


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)

    from nice_slam_torch.engine import SlamEngine
    from nice_slam_torch.utils.checkpoint import latest_checkpoint
    from nice_slam_torch.utils.retry import retry_transient

    cfg = run_config(args)
    n_local = local_ranks(cfg)
    if n_local > 1:
        import torch.multiprocessing as mp

        from nice_slam_torch.parallel.multihost import free_port

        mp.spawn(_local_rank, args=(sys.argv[1:] if argv is None else argv,
                                    free_port(), n_local),
                 nprocs=n_local, join=True)
        return
    from nice_slam_torch.parallel import multihost

    multihost.initialize_from_cfg(cfg, device=args.device)
    mesher_hook = None
    if not args.no_mesh:
        from nice_slam_torch.utils.mesher import engine_mesher_hook
        mesher_hook = engine_mesher_hook
    resume = args.resume
    if resume and os.path.isdir(resume):
        resume = (latest_checkpoint(os.path.join(resume, "ckpts"))
                  or latest_checkpoint(resume))
        if resume is None:
            ap.error(f"no checkpoint under {args.resume}")
    from nice_slam_torch.utils.profiling import torch_trace

    pipelined = bool(cfg["tpu"].get("pipelined"))

    def build_and_run():
        # the unit a transient failure retries: a new engine, resumed from
        # the newest checkpoint of the failed attempt (if it wrote one)
        if pipelined:
            from nice_slam_torch.parallel.pipelined import (
                PipelinedSlamEngine,
            )
            eng = PipelinedSlamEngine(cfg, device=args.device,
                                      mesher_hook=mesher_hook)
        else:
            eng = SlamEngine(cfg, device=args.device,
                             mesher_hook=mesher_hook)
        if args.vis:
            if pipelined:
                print("note: tpu.pipelined tracks in frame groups — "
                      "keeping mapping panels only (no per-frame tracking "
                      "panels)")
            eng.enable_visualizer(mapping_only=pipelined)
        ckpt = resume
        if build_and_run.attempted:
            ckpt = latest_checkpoint(os.path.join(eng.output, "ckpts")) \
                or resume
        build_and_run.attempted = True
        if ckpt:
            eng.resume(ckpt)
            print(f"resumed from {ckpt} at frame {eng.frames_done}")
        t0 = time.perf_counter()
        with torch_trace(args.profile):
            eng.run(n_frames=args.frames, progress=True)
        return eng, time.perf_counter() - t0

    build_and_run.attempted = False
    retry = {}
    # a rank of a group does not retry alone (utils/retry.py)
    attempts = 1 if multihost.rank_world()[1] > 1 else 3
    eng, wall = retry_transient(build_and_run, attempts=attempts,
                                label="slam run", stats=retry)

    stats = eng.ate()
    import numpy as np
    import torch

    from nice_slam_torch.ops import fused_decode
    from nice_slam_torch.ops.tree import tree_leaves

    written = dict(eng.written)
    if eng.is_primary:
        os.makedirs(eng.output, exist_ok=True)
        with open(os.path.join(eng.output, "ate.json"), "w") as f:
            json.dump(stats, f, indent=2)
        np.save(os.path.join(eng.output, "traj_est.npy"),
                eng.est_c2w[:eng.frames_done])
        written["ate"] = 1
    st = eng.map_state
    summary = json.dumps({
        "ate_rmse_m": stats["rmse"], "ate_mean_m": stats["mean"],
        "frames": eng.frames_done, "wall_s": wall,
        "timings_s": eng.timings, "device": str(eng.device),
        "rank": eng.rank, "world": eng.world,
        "backend": multihost.backend(),
        "traj_sha256": _digest([eng.est_c2w_dev[:eng.frames_done]]),
        "map_sha256": _digest(tree_leaves(st.params)
                              + tree_leaves(st.grids)),
        "launches": fused_decode.launch_counts(),
        "graphs": eng.graph_stats(),
        "peak_mib": (torch.cuda.max_memory_allocated(eng.device) / 2**20
                     if eng.device.type == "cuda" else None),
        "allreduce": eng.dp.stats() if eng.dp else None,
        "grid_sharded": eng.gs.stats() if eng.gs else None,
        "attempts": retry["attempts"],
        "written": written}, indent=2)
    # one write, so that the ranks' summaries do not interleave
    sys.stdout.write(summary + "\n")
    sys.stdout.flush()
    multihost.shutdown()


if __name__ == "__main__":
    main()
