#!/usr/bin/env python
"""Multi-seed quality study of the port on the synthetic scene (the
counterpart of the JAX package's tools/quality_study.py: the same flags,
the same resumable study.json and the same summary line).

Runs N seeds of the synthetic sequence through run_torch.py, one after
the other on one device (`--device`, cuda by default), optionally with a
config-override yaml, and prints a line a seed and a summary JSON.
Results go to <workdir>/study.json; finished (config, seed) pairs are
skipped, so an interrupted study resumes where it stopped.

    python -m nice_slam_torch.tools.quality_study --seeds 5
    python -m nice_slam_torch.tools.quality_study --seeds 5 \
        --yaml ab.yaml --name ab
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from typing import Optional

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def run_seed(yaml_path, seed, out_dir, frames, timeout,
             device="cuda") -> Optional[dict]:
    """One run_torch.py run; its ate.json, or None if it failed."""
    cmd = [sys.executable, os.path.join(REPO, "run_torch.py")]
    if yaml_path:
        cmd.append(yaml_path)
    cmd += ["--synthetic", str(frames), "--seed", str(seed),
            "--no-mesh", "--output", out_dir, "--device", device]
    res = subprocess.run(cmd, cwd=REPO, timeout=timeout,
                         stdout=subprocess.DEVNULL,
                         stderr=subprocess.DEVNULL)
    if res.returncode != 0:
        return None
    with open(os.path.join(out_dir, "ate.json")) as f:
        return json.load(f)


def summarize(name: str, frames: int, results: dict) -> Optional[dict]:
    """The summary of a config's finished seeds (failed seeds left out),
    or None when none finished."""
    vals = [v["rmse"] for v in results.values() if v]
    if not vals:
        return None
    return {"config": name, "frames": frames, "seeds": len(vals),
            "rmse_per_seed": [round(v, 4) for v in vals],
            "worst": round(max(vals), 4),
            "mean": round(sum(vals) / len(vals), 4)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, default=5)
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--yaml", type=str, default=None,
                    help="override config (inherit_from synthetic.yaml)")
    ap.add_argument("--name", type=str, default="baseline")
    ap.add_argument("--workdir", type=str,
                    default=os.path.join(REPO, "output", "quality_study"))
    ap.add_argument("--timeout", type=int, default=3000)
    ap.add_argument("--device", type=str, default="cuda",
                    help="run_torch.py's device (default cuda)")
    args = ap.parse_args(argv)

    os.makedirs(args.workdir, exist_ok=True)
    study_path = os.path.join(args.workdir, "study.json")
    study = {}
    if os.path.exists(study_path):
        with open(study_path) as f:
            study = json.load(f)
    cfg_res = study.setdefault(args.name, {})

    for seed in range(args.seeds):
        k = str(seed)
        if k in cfg_res:
            continue
        out = os.path.join(args.workdir, f"{args.name}_s{seed}")
        stats = run_seed(args.yaml, seed, out, args.frames, args.timeout,
                         args.device)
        cfg_res[k] = (None if stats is None
                      else {"rmse": stats["rmse"], "mean": stats["mean"],
                            "max": stats["max"]})
        label = "FAIL" if stats is None else f"{stats['rmse']:.4f}"
        print(f"{args.name} seed {seed}: {label}", flush=True)
        with open(study_path, "w") as f:
            json.dump(study, f, indent=2)

    summary = summarize(args.name, args.frames, cfg_res)
    if summary:
        print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
