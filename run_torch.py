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

The port runs NICE-SLAM and iMAP* under strict, loose and free sync on one
GPU, with the fused decode as CUDA kernels, writes checkpoints
(<output>/ckpts/{idx:05d}.npz, the JAX package's format: either package
resumes the other's) and meshes (<output>/mesh/{idx:05d}_mesh.ply every
mapping.mesh_freq frames and final_mesh.ply at the last frame; the
marching tetrahedra are host C++, built with g++ at first use).  The
config's Gauss-Newton pose refinement (tracking / mapping.pose_GN_iters),
occupancy-guided sampling (rendering.occupancy_guided) and the
reference's .pt decoders (pretrained_decoders.coarse / middle_fine, read
when the repository's npz is absent) run too.  Not in the port: the
visualizer and the parallel modes; a config that asks for a parallel
mode is refused.  --profile writes a torch.profiler Chrome trace of the
run.

Prints a JSON summary (ate_rmse_m, ate_mean_m, frames, timings_s, ...)
and writes <output>/ate.json and the estimated trajectory
<output>/traj_est.npy ((frames, 4, 4) camera-to-world).
"""

from __future__ import annotations

import argparse
import json
import os
import time


def main():
    ap = argparse.ArgumentParser(
        description="nice-slam PyTorch port runner (NICE-SLAM and iMAP*, "
                    "strict/loose/free sync, checkpoint and resume, "
                    "meshing, Gauss-Newton poses, occupancy-guided "
                    "sampling; not yet: visualizer, parallel modes)")
    ap.add_argument("config", nargs="?", default=None,
                    help="scene config yaml")
    ap.add_argument("--input_folder", type=str, default=None,
                    help="overrides the input folder in the config")
    ap.add_argument("--output", type=str, default=None,
                    help="overrides the output folder in the config")
    ap.add_argument("--imap", action="store_true",
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
    ap.add_argument("--profile", type=str, default=None, metavar="LOGDIR",
                    help="write a torch.profiler Chrome trace of the run to "
                         "LOGDIR/trace.json")
    args = ap.parse_args()

    from nice_slam_torch.config import load_config
    from nice_slam_torch.engine import SlamEngine
    from nice_slam_torch.utils.checkpoint import latest_checkpoint

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

    cfg = load_config(args.config, nice=not args.imap, overrides=overrides)
    mesher_hook = None
    if not args.no_mesh:
        from nice_slam_torch.utils.mesher import engine_mesher_hook
        mesher_hook = engine_mesher_hook
    eng = SlamEngine(cfg, device=args.device, mesher_hook=mesher_hook)
    if args.resume:
        ckpt = args.resume
        if os.path.isdir(ckpt):
            ckpt = (latest_checkpoint(os.path.join(ckpt, "ckpts"))
                    or latest_checkpoint(ckpt))
            if ckpt is None:
                ap.error(f"no checkpoint under {args.resume}")
        eng.resume(ckpt)
        print(f"resumed from {ckpt} at frame {eng.frames_done}")
    from nice_slam_torch.utils.profiling import torch_trace

    t0 = time.perf_counter()
    with torch_trace(args.profile):
        eng.run(n_frames=args.frames, progress=True)
    wall = time.perf_counter() - t0

    stats = eng.ate()
    print(json.dumps({"ate_rmse_m": stats["rmse"],
                      "ate_mean_m": stats["mean"],
                      "frames": eng.frames_done,
                      "wall_s": wall,
                      "timings_s": eng.timings,
                      "device": str(eng.device)}, indent=2))
    import numpy as np

    os.makedirs(eng.output, exist_ok=True)
    with open(os.path.join(eng.output, "ate.json"), "w") as f:
        json.dump(stats, f, indent=2)
    np.save(os.path.join(eng.output, "traj_est.npy"),
            eng.est_c2w[:eng.frames_done])


if __name__ == "__main__":
    main()
