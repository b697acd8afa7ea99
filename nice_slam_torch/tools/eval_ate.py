"""ATE evaluation of a run's checkpoint (analogue of the reference's
src/tools/eval_ate.py; the port's copy of the JAX package's
tools/eval_ate.py): loads the latest checkpoint (either package's),
Horn-aligns est vs GT trajectories, reports translational error stats and,
with --plot, a trajectory plot (matplotlib, imported only then; without
it the tool exits with a message after printing the stats).

    python -m nice_slam_torch.tools.eval_ate RUN_OUTPUT [--plot ate.png]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("target", help="run output dir (with ckpts/) or a "
                    "checkpoint .npz")
    ap.add_argument("--plot", default=None, help="save trajectory plot here")
    args = ap.parse_args(argv)

    from nice_slam_torch.utils.checkpoint import latest_checkpoint
    from nice_slam_torch.utils.trajectory import ate_stats, horn_align

    path = args.target
    if os.path.isdir(path):
        path = latest_checkpoint(os.path.join(path, "ckpts")) \
            or latest_checkpoint(path)
        if path is None:
            sys.exit("no checkpoint found")

    with np.load(path) as z:
        est = z["est_c2w"]
        gt = z["gt_c2w"]
        n = int(z["idx"]) or len(est)

    stats = ate_stats(gt[:n], est[:n])
    print(json.dumps({k: (round(v, 6) if isinstance(v, float) else v)
                      for k, v in stats.items()}, indent=2))
    print(f"ATE RMSE: {stats['rmse'] * 100:.3f} cm")

    if args.plot:
        import importlib.util

        if importlib.util.find_spec("matplotlib") is None:
            sys.exit("--plot needs matplotlib, which is not installed; the "
                     "stats above are complete")
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        gt_t = gt[:n, :3, 3]
        est_t = est[:n, :3, 3]
        ok = np.isfinite(gt_t).all(1) & np.isfinite(est_t).all(1)
        rot, trans, _ = horn_align(est_t[ok], gt_t[ok])
        est_aligned = est_t[ok] @ rot.T + trans
        fig, ax = plt.subplots(figsize=(7, 7))
        ax.plot(gt_t[ok, 0], gt_t[ok, 2], "-", color="black",
                label="ground truth")
        ax.plot(est_aligned[:, 0], est_aligned[:, 2], "-", color="tab:blue",
                label="estimated")
        ax.set_xlabel("x [m]")
        ax.set_ylabel("z [m]")
        ax.legend()
        ax.set_title(f"ATE RMSE {stats['rmse'] * 100:.2f} cm")
        plt.savefig(args.plot, dpi=120)
        print("plot saved to", args.plot)


if __name__ == "__main__":
    main()
