"""Trajectory and mesh replay of a run (the port's counterpart of the
JAX package's tools/replay.py, itself the analogue of the reference's
visualizer.py + src/tools/viz.py, which need an Open3D GUI).

    python -m nice_slam_torch.tools.replay <output_dir> --html replay.html
    python -m nice_slam_torch.tools.replay <output_dir> [--save F.mp4]
        [--frames_dir D] [--stride N]

Two output modes:
 - `--html out.html`: a fully INTERACTIVE self-contained WebGL viewer
   (orbit/zoom/pan, time slider + play to replay the run, mesh +
   frusta + keyframe-graph toggles) with all geometry embedded as
   base64 (numpy only; the template viewer_template.html lies beside
   this file) — the interactive analogue of the reference's live window
   (src/tools/viz.py:180-209) that needs no GUI stack, no server and no
   network: open the file in any browser.  It embeds the same DATA as
   the JAX package's tool for the same run directory.
 - png/mp4 frame sequences (matplotlib) of the estimated vs GT camera
   trajectory, camera frusta, keyframe graph and mesh silhouette — the
   offline analogues of the reference's live Open3D overlays
   (src/tools/viz.py:45-153).  Where matplotlib is missing it exits
   non-zero and names --html."""

from __future__ import annotations

import argparse
import base64
import json
import os
import sys

import numpy as np


def frustum_segments(c2w: np.ndarray, scale: float = 0.25,
                     aspect: float = 4.0 / 3.0):
    """Wireframe camera frustum segments (apex + image-plane rectangle)
    in world coordinates; -z forward convention.  Fixed-size visual aid,
    like the reference's frustum LineSet (src/tools/viz.py:45-83)."""
    w, h, z = scale * aspect / 2.0, scale / 2.0, -scale
    corners = np.array([[w, h, z], [-w, h, z], [-w, -h, z], [w, -h, z]])
    cw = corners @ c2w[:3, :3].T + c2w[:3, 3]
    apex = c2w[:3, 3]
    segs = [(apex, cw[i]) for i in range(4)]
    segs += [(cw[i], cw[(i + 1) % 4]) for i in range(4)]
    return segs


def draw_frustum(ax, c2w, color, scale=0.25):
    for a, b in frustum_segments(c2w, scale):
        ax.plot(*np.stack([a, b]).T, color=color, linewidth=0.8)


def load_run(output_dir):
    """(est, gt, n, kf_ids, mesh, selkf) from a run's latest checkpoint;
    mesh is (verts f32, tris i64, colors u8|None) or None; selkf is the
    per-mapping-event selected-window record written when
    mapping.save_selected_keyframes_info is on (reference
    Mapper.py:274-287 / Logger.py:30) — a list of
    (event_frame, [window frame ids]) — or None."""
    from nice_slam_torch.utils.checkpoint import latest_checkpoint
    from nice_slam_torch.utils.plyio import read_ply

    ck = latest_checkpoint(os.path.join(output_dir, "ckpts"))
    if ck is None:
        sys.exit("no checkpoint found")
    with np.load(ck) as z:
        est = z["est_c2w"]
        gt = z["gt_c2w"]
        n = int(z["idx"]) or len(est)
        kf_ids = (z["extra/kf_frame_ids"].astype(int)
                  if "extra/kf_frame_ids" in z.files else np.zeros(0, int))
        selkf = None
        if "extra/selkf_event_idx" in z.files:
            selkf = [(int(i), [int(f) for f in row if f >= 0])
                     for i, row in zip(z["extra/selkf_event_idx"],
                                       z["extra/selkf_frames"])]
    mesh_path = os.path.join(output_dir, "mesh", "final_mesh.ply")
    mesh = read_ply(mesh_path) if os.path.exists(mesh_path) else None
    return est, gt, n, kf_ids, mesh, selkf


def write_html(output_dir: str, out_path: str, max_faces: int = 150000):
    """Self-contained interactive WebGL replay (see module docstring)."""
    import html as html_mod

    est, gt, n, kf_ids, mesh, selkf = load_run(output_dir)

    def b64(arr, dtype):
        return base64.b64encode(
            np.ascontiguousarray(arr, dtype).tobytes()).decode()

    data = {
        "n": int(n),
        "est": b64(est[:n].reshape(n, 16), np.float32),
        "gt": b64(gt[:n].reshape(n, 16), np.float32),
        "kf": [int(k) for k in kf_ids if k < n],
    }
    if selkf:
        data["selkf"] = [[i, [f for f in fr if f < n]]
                         for i, fr in selkf if i < n]
    if mesh is not None and len(mesh[1]):
        verts, tris, colors = mesh
        if len(tris) > max_faces:  # keep the file browser-friendly
            sel = np.random.RandomState(0).choice(
                len(tris), max_faces, replace=False)
            tris = tris[sel]
            # compact to the referenced vertices, or the full vertex and
            # color arrays still dominate the file size
            used, inv = np.unique(tris.reshape(-1), return_inverse=True)
            tris = inv.reshape(-1, 3)
            verts = verts[used]
            if colors is not None:
                colors = colors[used]
        data["mesh_v"] = b64(verts, np.float32)
        data["mesh_i"] = b64(tris, np.uint32)
        if colors is not None:
            data["mesh_c"] = b64(colors.astype(np.float32) / 255.0,
                                 np.float32)
    ok = np.isfinite(gt[:n, :3, 3]).all(-1)
    if ok.sum() >= 2:
        from nice_slam_torch.utils.trajectory import ate_stats
        data["ate"] = f"{ate_stats(gt[:n][ok], est[:n][ok])['rmse']:.4f}"

    tpl_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "viewer_template.html")
    with open(tpl_path) as f:
        tpl = f.read()
    # __DATA__ first, then the escaped title: a run-dir basename
    # containing markup (or the literal "__DATA__") must not corrupt
    # the substitution
    html = tpl.replace("__DATA__", json.dumps(data)).replace(
        "__TITLE__", html_mod.escape(os.path.basename(
            os.path.abspath(output_dir))))
    with open(out_path, "w") as f:
        f.write(html)
    print(f"wrote interactive viewer {out_path} "
          f"({os.path.getsize(out_path) / 1e6:.1f} MB, {n} frames"
          + (f", {len(data.get('kf', []))} keyframes" if len(kf_ids)
             else "") + ")")


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="replay a run's trajectory and mesh (png/mp4 with "
                    "matplotlib, or an interactive --html viewer)")
    ap.add_argument("output_dir", help="run output dir (ckpts/, mesh/)")
    ap.add_argument("--save", default=None, help="mp4 output path")
    ap.add_argument("--frames_dir", default=None,
                    help="also dump per-frame pngs here")
    ap.add_argument("--html", default=None,
                    help="write a self-contained interactive WebGL "
                         "viewer to this path instead")
    ap.add_argument("--stride", type=int, default=5)
    args = ap.parse_args(argv)

    if args.html:
        write_html(args.output_dir, args.html)
        return

    try:
        import matplotlib
    except ImportError:
        sys.exit("replay: the png/mp4 mode draws with matplotlib, which "
                 "this host lacks; --html writes the interactive viewer "
                 "with numpy only")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib import animation

    est, gt, n, kf_ids, mesh, selkf = load_run(args.output_dir)
    mesh_pts = None
    if mesh is not None and len(mesh[0]):
        verts = mesh[0]
        sel = np.random.RandomState(0).choice(
            len(verts), min(len(verts), 20000), replace=False)
        mesh_pts = verts[sel]

    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(111, projection="3d")

    def draw(k):
        ax.cla()
        m = min(k * args.stride + 1, n)
        if mesh_pts is not None:
            ax.scatter(mesh_pts[:, 0], mesh_pts[:, 1], mesh_pts[:, 2],
                       s=0.2, c="lightgray", alpha=0.5)
        ok = np.isfinite(gt[:m, :3, 3]).all(-1)
        ax.plot(*gt[:m][ok][:, :3, 3].T, color="black", label="GT")
        ax.plot(*est[:m, :3, 3].T, color="tab:red", label="estimated")
        # current camera frusta (est red, GT gray), reference viz.py:45-83
        draw_frustum(ax, est[m - 1], "tab:red")
        if np.isfinite(gt[m - 1]).all():
            draw_frustum(ax, gt[m - 1], "gray")
        # keyframe graph: inserted keyframes + window links.  With the
        # selected-keyframes record (save_selected_keyframes_info) the
        # links show the ACTUAL optimization window of the latest mapping
        # event; otherwise fall back to generic links to the current
        # camera.
        kfs = kf_ids[kf_ids < m]
        if len(kfs):
            ax.scatter(*est[kfs][:, :3, 3].T, color="tab:green", s=25,
                       marker="^", label="keyframes")
        ev = ([e for e in selkf if e[0] < m] if selkf else None)
        if ev:
            e_idx, e_frames = ev[-1]
            for f_id in e_frames:
                seg = np.stack([est[f_id, :3, 3], est[e_idx, :3, 3]])
                ax.plot(*seg.T, color="tab:orange", linewidth=0.6,
                        alpha=0.6)
        else:
            for k_id in kfs:
                seg = np.stack([est[k_id, :3, 3], est[m - 1, :3, 3]])
                ax.plot(*seg.T, color="tab:green", linewidth=0.4,
                        alpha=0.35)
        ax.legend()
        ax.set_title(f"frame {m - 1}/{n - 1}")

    n_anim = (n + args.stride - 1) // args.stride
    if args.frames_dir:
        os.makedirs(args.frames_dir, exist_ok=True)
        for k in range(n_anim):
            draw(k)
            fig.savefig(os.path.join(args.frames_dir, f"{k:05d}.png"),
                        dpi=100)
        print(f"wrote {n_anim} frames to {args.frames_dir}")
    if args.save:
        anim = animation.FuncAnimation(fig, draw, frames=n_anim)
        anim.save(args.save, fps=10)
        print("saved", args.save)
    if not args.frames_dir and not args.save:
        draw(n_anim - 1)
        out = os.path.join(args.output_dir, "replay.png")
        fig.savefig(out, dpi=120)
        print("saved", out)


if __name__ == "__main__":
    main()
