"""Frustum-cull a mesh against a trajectory (analogue of
src/tools/cull_mesh.py; the port's copy of the JAX package's
tools/cull_mesh.py): drop faces never inside any camera frustum.

Used to prepare GT meshes for eval_recon.  Intrinsics default to the
Replica camera the reference hardcodes (cull_mesh.py:32-39) but are
configurable.  The trajectory comes from a run's checkpoint npz, whose
format both packages share.

    python -m nice_slam_torch.tools.cull_mesh GT.ply --ckpt RUN/ckpts/N.npz \
        [--traj gt|est] [--save_unseen] [--H 680 --W 1200 ...]
"""

from __future__ import annotations

import argparse

import numpy as np


def seen_mask(points, poses, H, W, fx, fy, cx, cy):
    """Per-point: inside at least one camera frustum along the
    trajectory (the reference's per-frame projection test,
    src/tools/cull_mesh.py:49-71)."""
    inside_any = np.zeros(len(points), bool)
    for c2w in poses:
        w2c = np.linalg.inv(c2w)
        pc = points @ w2c[:3, :3].T + w2c[:3, 3]
        z = pc[:, 2]
        front = z < 0
        u = fx * (-pc[:, 0]) / (z - 1e-9) + cx
        v = fy * pc[:, 1] / (z - 1e-9) + cy
        inside_any |= front & (u >= 0) & (u < W) & (v >= 0) & (v < H)
        if inside_any.all():
            break
    return inside_any


def cull(verts, tris, poses, H, W, fx, fy, cx, cy):
    keep = seen_mask(verts, poses, H, W, fx, fy, cx, cy)[tris].all(axis=1)
    return tris[keep]


def unseen_points(verts, tris, poses, H, W, fx, fy, cx, cy,
                  n_samples: int = 200_000, seed: int = 0):
    """Surface samples of the mesh never inside any frustum — the
    `*_pc_unseen.npy` point set the reference's 2D eval uses for
    view rejection (src/tools/eval_recon.py:145-175)."""
    from nice_slam_torch.tools.eval_recon import sample_surface

    pts = sample_surface(verts, tris, n_samples, seed=seed)
    return pts[~seen_mask(pts, poses, H, W, fx, fy, cx, cy)]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("input_mesh")
    ap.add_argument("--ckpt", required=True,
                    help="run checkpoint .npz carrying the trajectory")
    ap.add_argument("--traj", choices=["gt", "est"], default="gt")
    ap.add_argument("--output", default=None)
    ap.add_argument("--H", type=int, default=680)
    ap.add_argument("--W", type=int, default=1200)
    ap.add_argument("--fx", type=float, default=600.0)
    ap.add_argument("--fy", type=float, default=600.0)
    ap.add_argument("--cx", type=float, default=599.5)
    ap.add_argument("--cy", type=float, default=339.5)
    ap.add_argument("--save_unseen", action="store_true",
                    help="also save <output>_pc_unseen.npy: surface "
                         "samples never seen by the trajectory (used by "
                         "eval_recon -2d for view rejection)")
    args = ap.parse_args(argv)

    from nice_slam_torch.utils.plyio import read_ply, write_ply

    verts, tris, colors = read_ply(args.input_mesh)
    with np.load(args.ckpt) as z:
        poses = z["gt_c2w" if args.traj == "gt" else "est_c2w"]
        n = int(z["idx"]) or len(poses)
    poses = [p for p in poses[:n] if np.isfinite(p).all()]

    tris2 = cull(verts, tris, poses, args.H, args.W, args.fx, args.fy,
                 args.cx, args.cy)
    out = args.output or args.input_mesh.replace(".ply", "_culled.ply")
    write_ply(out, verts, tris2, colors)
    print(f"kept {len(tris2)}/{len(tris)} faces -> {out}")

    if args.save_unseen:
        pts = unseen_points(verts, tris, poses, args.H, args.W, args.fx,
                            args.fy, args.cx, args.cy)
        upath = out.replace(".ply", "_pc_unseen.npy")
        np.save(upath, pts.astype(np.float32))
        print(f"saved {len(pts)} unseen surface points -> {upath}")


if __name__ == "__main__":
    main()
