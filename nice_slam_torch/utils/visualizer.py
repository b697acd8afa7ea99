"""Debug visualiser: GT / rendered / residual panels per iteration (the
counterpart of the JAX package's nice_slam_tpu/utils/visualizer.py,
reference src/utils/Visualizer.py).

A panel is six images of one frame: the input depth, the rendered depth
and their residual; the input RGB, the rendered RGB and their residual.
The residuals are zero where the input depth is 0, the colours are
clipped to [0, 1] and the depth row spans [0, vmax], vmax the largest
input depth.  `save_panel` writes them in two forms:

- always <vis_dir>/{idx:05d}_{it:04d}.npz: the six float32 arrays
  (PANEL_KEYS) and vmax, the panel's content on every host;
- where matplotlib imports, also {idx:05d}_{it:04d}.jpg, the JAX
  package's figure (titles, colormap, dpi and savefig arguments), so the
  jpg's bytes equal what its save_panel writes from the same arrays.

A run on a host without matplotlib keeps the npz files, and says so;
this command draws their jpgs on any host that has it:

    python -m nice_slam_torch.utils.visualizer <vis_dir> [<vis_dir> ...]

Panels render with render.render_image, which takes no generator: the
stratified samples are not jittered and the importance draws are
deterministic, so drawing a panel consumes none of a run's random
numbers."""

from __future__ import annotations

import argparse
import dataclasses
import glob
import os
import sys
from typing import Optional

import numpy as np

PANEL_KEYS = ("gt_depth", "depth", "depth_residual",
              "gt_color", "color", "color_residual")
DEPTH_TITLES = ("Input Depth", "Generated Depth", "Depth Residual")
COLOR_TITLES = ("Input RGB", "Generated RGB", "RGB Residual")
DRAW_COMMAND = "python -m nice_slam_torch.utils.visualizer"


def have_matplotlib() -> bool:
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


def panel_forms(vis_dirs) -> str:
    """The line a run prints when it starts drawing panels: the forms it
    writes and where, and without matplotlib the command that draws the
    jpgs later."""
    dirs = ", ".join(vis_dirs)
    if have_matplotlib():
        return f"visualizer: panels as npz and jpg in {dirs}"
    return (f"visualizer: panels as npz only in {dirs} (no matplotlib "
            f"here); draw the jpgs on a host with matplotlib: "
            f"{DRAW_COMMAND} {' '.join(vis_dirs)}")


def panel_arrays(gt_depth, gt_color, depth, color) -> dict:
    """The six float32 images of a panel (PANEL_KEYS) and vmax, computed
    as the JAX package's save_panel computes them."""
    gt_depth = np.asarray(gt_depth, np.float32)
    gt_color = np.asarray(gt_color, np.float32)
    depth = np.asarray(depth, np.float32)
    color = np.asarray(color, np.float32)
    depth_residual = np.abs(gt_depth - depth)
    depth_residual[gt_depth == 0.0] = 0.0
    color_residual = np.abs(gt_color - color)
    color_residual[gt_depth == 0.0] = 0.0
    return {"gt_depth": gt_depth, "depth": depth,
            "depth_residual": depth_residual, "gt_color": gt_color,
            "color": np.clip(color, 0, 1),
            "color_residual": np.clip(color_residual, 0, 1),
            "vmax": float(np.max(gt_depth)) or 1.0}


def draw_panel(out_path: str, arrays: dict) -> None:
    """The JAX package's 2x3 matplotlib figure of a panel's arrays."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axs = plt.subplots(2, 3, figsize=(12, 7))
    for a, (key, title) in enumerate(zip(PANEL_KEYS[:3], DEPTH_TITLES)):
        axs[0, a].imshow(arrays[key], cmap="plasma", vmin=0,
                         vmax=float(arrays["vmax"]))
        axs[0, a].set_title(title)
        axs[0, a].set_xticks([])
        axs[0, a].set_yticks([])
    for a, (key, title) in enumerate(zip(PANEL_KEYS[3:], COLOR_TITLES)):
        axs[1, a].imshow(arrays[key])
        axs[1, a].set_title(title)
        axs[1, a].set_xticks([])
        axs[1, a].set_yticks([])
    plt.subplots_adjust(wspace=0, hspace=0)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    plt.savefig(out_path, dpi=120, bbox_inches="tight", pad_inches=0.2)
    plt.close(fig)


def save_panel(out_stem: str, gt_depth, gt_color, depth, color) -> list:
    """Write <out_stem>.npz and, where matplotlib imports, <out_stem>.jpg.
    Returns the paths written."""
    arrays = panel_arrays(gt_depth, gt_color, depth, color)
    os.makedirs(os.path.dirname(out_stem) or ".", exist_ok=True)
    np.savez(out_stem + ".npz", **arrays)
    out = [out_stem + ".npz"]
    if have_matplotlib():
        draw_panel(out_stem + ".jpg", arrays)
        out.append(out_stem + ".jpg")
    return out


def _host(x) -> np.ndarray:
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def load_panel(path: str) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in PANEL_KEYS + ("vmax",)}


class Visualizer:
    """Panels of every freq-th frame at every inside_freq-th iteration,
    written to vis_dir/{idx:05d}_{it:04d}.npz (and .jpg): the reference's
    (vis_freq, vis_inside_freq) cadence (src/utils/Visualizer.py:24-107).
    Tracking renders each selected iteration's pre-step camera against
    the frozen map after the frame's loop; mapping renders from the
    mid-optimisation map before the step of each selected iteration
    (mapping.map_optimize's on_iter).  The selected mapping iterations,
    it % inside_freq == 0, are the segment starts of the JAX package's
    segment_stage_iters."""

    def __init__(self, vis_dir: str, freq: int, inside_freq: int = 1):
        self.vis_dir = vis_dir
        self.freq = max(int(freq), 1)
        self.inside_freq = max(int(inside_freq), 1)

    def frame_selected(self, idx: int) -> bool:
        return idx % self.freq == 0

    def iter_selected(self, it: int) -> bool:
        return it % self.inside_freq == 0

    def render_panel(self, engine, idx: int, it: int, gt_color, gt_depth,
                     c2w, params=None, grids=None, bound=None,
                     decode_fn=None) -> Optional[str]:
        """Render frame idx at camera-to-world c2w (4, 4) from (params,
        grids, bound), by default the engine's map, and write the panel
        on the primary rank; every rank renders (a grid-sharded
        `decode_fn` is collective).  The render counts under the engine's
        'vis' stage.  Returns the panel's path stem on the primary rank,
        else None."""
        import torch

        from nice_slam_torch.render import render_image

        s = engine.specs
        st = engine.map_state
        params = st.params if params is None else params
        grids = st.grids if grids is None and decode_fn is None else grids
        bound = engine.bound if bound is None else bound
        rspec = dataclasses.replace(s.render, perturb=0.0,
                                    train_decoders=False)
        with engine.timer.time("vis"):
            c2w = torch.as_tensor(c2w, dtype=torch.float32,
                                  device=bound.device)
            depth, _, color = render_image(
                params, s.model, grids, bound, c2w, s.camera, rspec,
                "color", torch.as_tensor(gt_depth, device=bound.device),
                decode_fn=decode_fn)
            if not engine.is_primary:
                return None
            gt_c = _host(gt_color)
            if gt_c.dtype == np.uint8:
                gt_c = gt_c.astype(np.float32) / 255.0
            stem = os.path.join(self.vis_dir, f"{idx:05d}_{it:04d}")
            save_panel(stem, _host(gt_depth), gt_c, _host(depth),
                       _host(color))
        engine.count_written("vis")
        return stem


def make_engine_vis_hook(vis_dir: str, freq: int = 50,
                         by_call_count: bool = False):
    """Engine-level hook(engine, idx, color, depth): one panel (it 0) of
    frame idx at its estimated pose from the engine's map, every `freq`
    frames, or with by_call_count (the mapping hook, which fires only at
    mapping events) every `freq`-th call, so 'every N-th mapping event'
    holds whatever every_frame is."""
    vis = Visualizer(vis_dir, freq)
    n_calls = [0]

    def hook(engine, idx, color, depth):
        key = n_calls[0] if by_call_count else idx
        n_calls[0] += 1
        if not vis.frame_selected(key):
            return None
        return vis.render_panel(engine, idx, 0, color, depth,
                                engine.map_side()[0][idx])

    return hook


def draw_dirs(vis_dirs) -> int:
    """Draw <stem>.jpg for every <stem>.npz in vis_dirs.  Returns the
    count."""
    n = 0
    for d in vis_dirs:
        for path in sorted(glob.glob(os.path.join(d, "*.npz"))):
            draw_panel(path[:-len(".npz")] + ".jpg", load_panel(path))
            n += 1
    return n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="draw the jpg of every npz panel in the given "
                    "directories (a run's tracking_vis/, mapping_vis/)")
    ap.add_argument("vis_dir", nargs="+")
    args = ap.parse_args(argv)
    if not have_matplotlib():
        print("visualizer: drawing needs matplotlib, which this host "
              "lacks", file=sys.stderr)
        return 1
    n = draw_dirs(args.vis_dir)
    print(f"drew {n} panels in {', '.join(args.vis_dir)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
