"""Reconstruction quality metrics (analogue of src/tools/eval_recon.py),
the port's copy of the JAX package's tools/eval_recon.py: the same numpy
random streams, view sampling, rejection and exclusion rules, so both
tools give the same numbers on the same meshes.

3D: accuracy (cm), completion (cm), completion ratio (<5cm, %) via nearest
neighbours between 200k surface samples of the reconstructed and GT
meshes, with optional ICP pre-alignment (reference eval_recon.py:24-117).

2D: depth L1 over 1000 random interior views (500x500, f=300) rendered
with the host C++ z-buffer triangle rasterizer
(nice_slam_torch/native/rasterize.cpp) in place of the reference's Open3D
offscreen renderer (eval_recon.py:131-210); view sampling, unseen-view
rejection, and full-buffer L1 are definitionally matched.

    python -m nice_slam_torch.tools.eval_recon REC.ply GT_culled.ply -2d \
        [--n_views 1000] [--pc_unseen GT_culled_pc_unseen.npy]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def sample_surface(verts: np.ndarray, tris: np.ndarray, n: int,
                   seed: int = 0) -> np.ndarray:
    """Area-weighted uniform surface sampling (trimesh.sample equivalent)."""
    rng = np.random.RandomState(seed)
    v0, v1, v2 = verts[tris[:, 0]], verts[tris[:, 1]], verts[tris[:, 2]]
    areas = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=1)
    probs = areas / areas.sum()
    face_idx = rng.choice(len(tris), n, p=probs)
    r1 = np.sqrt(rng.rand(n, 1))
    r2 = rng.rand(n, 1)
    a, b, c = v0[face_idx], v1[face_idx], v2[face_idx]
    return (1 - r1) * a + r1 * (1 - r2) * b + r1 * r2 * c


def icp_align(src: np.ndarray, dst: np.ndarray, iters: int = 20):
    """Point-to-point ICP returning a 4x4 transform src->dst
    (replacement for the reference's Open3D ICP, eval_recon.py:45-59)."""
    from scipy.spatial import cKDTree

    from nice_slam_torch.utils.trajectory import horn_align

    T = np.eye(4)
    cur = src.copy()
    tree = cKDTree(dst)
    for _ in range(iters):
        d, idx = tree.query(cur)
        keep = d < np.percentile(d, 90)
        rot, trans, _ = horn_align(cur[keep], dst[idx[keep]])
        cur = cur @ rot.T + trans
        Ti = np.eye(4)
        Ti[:3, :3] = rot
        Ti[:3, 3] = trans
        T = Ti @ T
    return T


def calc_3d_metrics(rec_mesh, gt_mesh, n_samples: int = 200_000,
                    align: bool = True) -> dict:
    from scipy.spatial import cKDTree

    rv, rt, _ = rec_mesh
    gv, gt_, _ = gt_mesh
    rec_pts = sample_surface(rv, rt, n_samples, seed=0)
    gt_pts = sample_surface(gv, gt_, n_samples, seed=1)

    if align:
        T = icp_align(rec_pts[::20], gt_pts[::20])
        rec_pts = rec_pts @ T[:3, :3].T + T[:3, 3]

    tree_gt = cKDTree(gt_pts)
    tree_rec = cKDTree(rec_pts)
    acc, _ = tree_gt.query(rec_pts)       # rec -> gt
    comp, _ = tree_rec.query(gt_pts)      # gt -> rec
    return {
        "accuracy_cm": float(acc.mean() * 100),
        "completion_cm": float(comp.mean() * 100),
        "completion_ratio_pct": float((comp < 0.05).mean() * 100),
    }


def oriented_bounds(pts: np.ndarray):
    """PCA oriented bounding box (first-party stand-in for
    trimesh.bounds.oriented_bounds).  Returns (extents (3,), transform
    (4,4)) where `transform` maps box-frame points into the world; axes
    are ordered by DESCENDING extent, so axis 2 is the shortest (the
    height axis for a room — matching the reference's +0.4 z-raise on the
    camera-position box, src/tools/eval_recon.py:119-127)."""
    c = pts.mean(0)
    X = pts - c
    _, _, Vt = np.linalg.svd(X[:: max(1, len(X) // 50_000)], full_matrices=False)
    R = Vt  # rows = principal axes (already descending variance)
    proj = X @ R.T
    lo, hi = proj.min(0), proj.max(0)
    extents = hi - lo
    center_w = c + ((lo + hi) / 2) @ R
    transform = np.eye(4)
    transform[:3, :3] = R.T
    transform[:3, 3] = center_w
    # right-handed frame
    if np.linalg.det(transform[:3, :3]) < 0:
        transform[:3, 2] *= -1
    return extents, transform


def viewmatrix(z, up, pos):
    """Camera-to-world from forward vector z, up hint, position — the
    reference's look-at construction (src/tools/eval_recon.py:15-21)."""
    vec2 = z / np.linalg.norm(z)
    vec0 = np.cross(up, vec2)
    vec0 = vec0 / np.linalg.norm(vec0)
    vec1 = np.cross(vec2, vec0)
    vec1 = vec1 / np.linalg.norm(vec1)
    m = np.eye(4)
    m[:3, :3] = np.stack([vec0, vec1, vec2], 1)
    m[:3, 3] = pos
    return m


def unseen_visible(points, W, H, fx, fy, cx, cy, c2w) -> bool:
    """True if any of `points` projects inside the view — the reference's
    view-rejection test (check_proj, src/tools/eval_recon.py:63-90).
    The axis flips mirror the reference: its sampled c2w is in the
    +z-forward graphics convention and is converted to the internal
    x-right/y-up/-z-forward convention before projecting."""
    if points is None or len(points) == 0:
        return False
    c2w = c2w.copy()
    c2w[:3, 1] *= -1.0
    c2w[:3, 2] *= -1.0
    w2c = np.linalg.inv(c2w)
    pc = points @ w2c[:3, :3].T + w2c[:3, 3]
    z = pc[:, 2]
    d = -(z) + 1e-5
    u = fx * (-pc[:, 0]) / (z - 1e-9) + cx
    v = fy * pc[:, 1] / (z - 1e-9) + cy
    mask = (d >= 0) & (u > 0) & (u < W) & (v > 0) & (v < H)
    return bool(mask.any())


def render_depth(verts, tris, c2w, H, W, fx, fy, cx, cy,
                 z_far: float = 20.0):
    """Mesh depth buffer via the host z-buffer rasterizer
    (nice_slam_torch/native/rasterize.cpp) — the Open3D offscreen-render
    analogue.  Empty pixels are 0, far plane 20 m, both matching the
    reference's capture settings (eval_recon.py:153-187)."""
    from nice_slam_torch.native import rasterize_depth

    return rasterize_depth(verts, tris, c2w, H, W, fx, fy, cx, cy,
                           z_near=0.01, z_far=z_far)


def calc_2d_metric(rec_mesh, gt_mesh, pc_unseen=None, n_views: int = 1000,
                   seed: int = 0, H: int = 500, W: int = 500,
                   focal: float = 300.0, align: bool = True) -> dict:
    """Depth-L1 between GT and reconstructed mesh renders, defined
    identically to the reference (src/tools/eval_recon.py:131-210):

    - 1000 views at 500x500, f=300 from camera positions sampled inside
      the GT mesh's shrunken oriented bounding box ([0.3, 0.7, 0.7] of
      the extents, raised 0.4 on the short axis), aimed at uniformly
      random far-away targets with up = -short-axis;
    - a candidate view is REJECTED and resampled while any point of the
      unseen GT point set (`*_pc_unseen.npy`, producible with
      nice_slam_torch/tools/cull_mesh.py --save_unseen) is visible in it;
    - the error per view is mean |gt - ours| over the FULL 500x500
      buffer (missing pixels render as depth 0), reconstructed mesh
      ICP-aligned to GT first."""
    rng = np.random.RandomState(seed)
    fx = fy = focal
    cx = W / 2.0 - 0.5
    cy = H / 2.0 - 0.5

    rv, rt = rec_mesh[0], rec_mesh[1]
    gv, gt_t = gt_mesh[0], gt_mesh[1]
    if align:
        T = icp_align(sample_surface(rv, rt, 20_000, seed=0),
                      sample_surface(gv, gt_t, 20_000, seed=1))
        rv = rv @ T[:3, :3].T + T[:3, 3]

    extents, transform = oriented_bounds(gv)
    # vacant-area camera box: shrink the two long (floor-plan) axes to
    # 0.7 and the short (height) axis to 0.3 (ref applies [0.3,0.7,0.7]
    # to ascending-ordered extents; ours are descending, so reversed),
    # then raise the box 0.4 in WORLD z with up=[0,0,-1] — exactly the
    # reference's construction (src/tools/eval_recon.py:119-127,160-163)
    box = extents * np.array([0.7, 0.7, 0.3])
    transform = transform.copy()
    transform[2, 3] += 0.4
    up = np.array([0.0, 0.0, -1.0])

    errs = []
    rejected = 0
    excluded = 0
    for _ in range(n_views):
        clean = False
        for _attempt in range(200):
            local = (rng.rand(3) - 0.5) * box
            origin = transform[:3, :3] @ local + transform[:3, 3]
            target = rng.uniform(-10000, 10000, 3)
            c2w = viewmatrix(target - origin, up, origin)
            if not unseen_visible(pc_unseen, W, H, fx, fy, cx, cy, c2w):
                clean = True
                break
            rejected += 1
        if not clean:
            # the reference loops forever until a clean view appears
            # (src/tools/eval_recon.py:157-174); in a heavily-unseen scene
            # that can never terminate, so after 200 failed resamples we
            # EXCLUDE the view (never silently use a rejected one) and
            # report the exclusion count
            excluded += 1
            continue
        # convert the look-at (graphics, +z forward) pose to the internal
        # -z-forward convention used by the rasterizer
        c2w_int = c2w.copy()
        c2w_int[:3, 1] *= -1.0
        c2w_int[:3, 2] *= -1.0
        d_gt = render_depth(gv, gt_t, c2w_int, H, W, fx, fy, cx, cy)
        d_rec = render_depth(rv, rt, c2w_int, H, W, fx, fy, cx, cy)
        errs.append(np.abs(d_gt - d_rec).mean())
    if excluded:
        print(f"warning: {excluded}/{n_views} views excluded — no clean "
              f"(unseen-free) view found in 200 resamples each",
              file=sys.stderr)
    if not errs:
        return {"depth_l1_cm": float("nan"), "views_used": 0,
                "views_rejected": rejected, "views_excluded": excluded}
    return {"depth_l1_cm": float(np.mean(errs) * 100),
            "views_used": len(errs), "views_rejected": rejected,
            "views_excluded": excluded}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("rec_mesh", help="reconstructed mesh .ply")
    ap.add_argument("gt_mesh", help="ground-truth (culled) mesh .ply")
    ap.add_argument("-2d", "--two_d", action="store_true")
    ap.add_argument("-3d", "--three_d", action="store_true", default=True)
    ap.add_argument("--n_views", type=int, default=1000)
    ap.add_argument("--pc_unseen", type=str, default=None,
                    help="unseen GT point cloud .npy for view rejection; "
                         "defaults to <gt_mesh>_pc_unseen.npy if present "
                         "(produce with nice_slam_torch/tools/cull_mesh.py "
                         "--save_unseen)")
    args = ap.parse_args(argv)

    from nice_slam_torch.utils.plyio import read_ply

    rec = read_ply(args.rec_mesh)
    gt = read_ply(args.gt_mesh)
    out = {}
    if args.three_d:
        out.update(calc_3d_metrics(rec, gt))
    if args.two_d:
        pc_path = args.pc_unseen or args.gt_mesh.replace(
            ".ply", "_pc_unseen.npy")
        pc_unseen = np.load(pc_path) if os.path.exists(pc_path) else None
        if pc_unseen is None:
            print(f"note: no unseen point cloud at {pc_path} — "
                  "running without view rejection", file=sys.stderr)
        out.update(calc_2d_metric(rec, gt, pc_unseen,
                                  n_views=args.n_views))
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
