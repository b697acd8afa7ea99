#!/usr/bin/env python
"""Write a scene yaml for self-captured data (the counterpart of the JAX
package's tools/prep_own_data.py, the same command line and yaml; the
reference's src/tools/prep_own_data.py): the intrinsics from an
intrinsic.json (Open3D reconstruction-system format), the scene bound from
a mesh's AABB +- 1 m or from back-projected depth frames.

    python -m nice_slam_torch.tools.prep_own_data <capture folder> \
        [--mesh mesh.ply] [--depth_scale 1000] [--output cfg.yaml]

The mesh is read with the port's utils/plyio.py, the depth frames with
its utils/imageio.py (no OpenCV).
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np
import yaml


def bound_from_depths(folder, K, depth_scale, n_sample=20):
    """The AABB +- 1 m of the camera-frame points of up to ~n_sample of the
    folder's depth/*.png (every 8th pixel), or None without frames."""
    from nice_slam_torch.utils.imageio import imread_depth

    paths = sorted(glob.glob(os.path.join(folder, "depth", "*.png")))
    if not paths:
        return None
    pts_all = []
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    for p in paths[:: max(len(paths) // n_sample, 1)]:
        d = imread_depth(p).astype(np.float32) / depth_scale
        H, W = d.shape
        jj, ii = np.meshgrid(np.arange(0, H, 8), np.arange(0, W, 8),
                             indexing="ij")
        z = d[jj, ii]
        ok = z > 0
        pts = np.stack([(ii[ok] - cx) / fx * z[ok],
                        -(jj[ok] - cy) / fy * z[ok], -z[ok]], -1)
        pts_all.append(pts)
    pts = np.concatenate(pts_all)
    lo = pts.min(0) - 1.0
    hi = pts.max(0) + 1.0
    return [[float(a), float(b)] for a, b in zip(lo, hi)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("input_folder", help="capture folder (color/, depth/, "
                    "intrinsic.json)")
    ap.add_argument("--mesh", default=None, help="optional mesh .ply whose "
                    "AABB +-1m becomes the bound")
    ap.add_argument("--depth_scale", type=float, default=1000.0)
    ap.add_argument("--output", default=None)
    args = ap.parse_args(argv)

    intr_path = os.path.join(args.input_folder, "intrinsic.json")
    with open(intr_path) as f:
        intr = json.load(f)
    mat = np.array(intr["intrinsic_matrix"]).reshape(3, 3).T
    W, H = intr["width"], intr["height"]

    if args.mesh:
        from nice_slam_torch.utils.plyio import read_ply
        verts, _, _ = read_ply(args.mesh)
        lo = verts.min(0) - 1.0
        hi = verts.max(0) + 1.0
        bound = [[float(a), float(b)] for a, b in zip(lo, hi)]
    else:
        bound = bound_from_depths(args.input_folder, mat, args.depth_scale) \
            or [[-5.0, 5.0], [-5.0, 5.0], [-5.0, 5.0]]

    cfg = {
        "inherit_from": "configs/Own/own.yaml",
        "cam": {"H": H, "W": W,
                "fx": float(mat[0, 0]), "fy": float(mat[1, 1]),
                "cx": float(mat[0, 2]), "cy": float(mat[1, 2]),
                "png_depth_scale": args.depth_scale, "crop_edge": 0},
        "mapping": {"bound": bound, "marching_cubes_bound": bound},
        "data": {"input_folder": args.input_folder,
                 "output": os.path.join("output", "Own",
                                        os.path.basename(
                                            args.input_folder.rstrip("/")))},
    }
    out = args.output or os.path.join("configs", "Own", "generated.yaml")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        yaml.safe_dump(cfg, f, sort_keys=False, default_flow_style=None)
    print("wrote", out)


if __name__ == "__main__":
    main()
