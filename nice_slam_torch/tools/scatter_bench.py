"""The grid backward's scatter on the main path's own inputs, by route.

    python3 -m nice_slam_torch.tools.scatter_bench [--calls 24]

Runs the strict path of configs/Synthetic/synthetic.yaml at full width on
one GPU for two frames (the first mapping event cut to 60 iterations:
middle, fine and colour stages) and records the first `--calls` inputs of
every grid's backward scatter made outside a CUDA graph's capture
(ops/grid.grid_grad: the corner rows, the fractional offsets and the
cotangent).  On each recorded input it times, with CUDA events, every
route that sums the weighted corner rows into the grid:

  kernel        ops/grid.grid_grad, the main path's route: the stable sort
                of the int32 keys, then csrc/grid_scatter.cu (the weights
                computed in the kernel, chunks of 64 sorted entries)
  plain         ops/grid.plain_grid_grad: the weighted rows built, then
                scatter_rows (the kernel's plain version, same order)
  index_add     torch.zeros + index_add_ of the weighted rows built
                beforehand (atomics: the order changes from run to run;
                the library's yardstick, which the port never calls)

and runs each route 20 times to see whether it repeats bit for bit.
Prints the card (nvidia-smi name and power limit), the inputs' run
lengths, and one JSON line a route: median ms over the calls, its sum
over them, the largest difference from the float64 sum, and whether it
repeated.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess

import torch

from nice_slam_torch.ops import grid

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


ROUTES = {
    "kernel": lambda rows, f, g, n, flat, v: grid.grid_grad(rows, f, g, n),
    "plain": lambda rows, f, g, n, flat, v: grid.plain_grid_grad(rows, f, g,
                                                                 n),
    "index_add": lambda rows, f, g, n, flat, v: torch.zeros(
        n, v.shape[1], device=v.device).index_add_(0, flat, v),
}


def record(n_calls: int):
    from nice_slam_torch.config import load_config
    from nice_slam_torch.engine import SlamEngine

    calls = []
    orig = grid.grid_grad

    def rec(rows, f, g, n_rows):
        # a capture runs nothing: its inputs hold no values yet
        if (len(calls) < n_calls
                and not torch.cuda.is_current_stream_capturing()):
            calls.append((rows.clone(), f.clone(), g.clone(), n_rows))
        return orig(rows, f, g, n_rows)

    cfg = load_config(
        os.path.join(REPO, "configs", "Synthetic", "synthetic.yaml"),
        overrides={"synthetic": {"n_frames": 2},
                   "mapping": {"iters_first": 60},
                   "data": {"output": os.path.join(REPO, "output",
                                                   "scatter_bench")}})
    grid.grid_grad = rec
    try:
        SlamEngine(cfg, device="cuda").run()
    finally:
        grid.grid_grad = orig
    return calls


def time_ms(fn, reps=9, inner=10):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--calls", type=int, default=24)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("scatter_bench: no CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    calls = record(args.calls)
    lengths = [torch.bincount(r.reshape(-1), minlength=n).float()
               for r, _, _, n in calls]
    print(json.dumps({
        "calls": len(calls),
        "points_x8": sorted({int(r.numel()) for r, _, _, _ in calls}),
        "grid_rows": sorted({n for _, _, _, n in calls}),
        "max_run": max(float(x.max()) for x in lengths),
        "mean_nonempty_run": statistics.mean(
            float(x[x > 0].mean()) for x in lengths)}), flush=True)
    inputs = []
    for rows, f, g, n in calls:
        flat = rows.reshape(-1)
        v = grid.corner_values(f, g).reshape(-1, g.shape[1])
        ref = torch.zeros(n, g.shape[1], dtype=torch.float64,
                          device=g.device).index_add_(0, flat, v.double())
        inputs.append(((rows, f, g, n, flat, v), ref))
    for name, fn in ROUTES.items():
        ms, repeats, err = [], True, 0.0
        for a, ref in inputs:
            ms.append(time_ms(lambda a=a: fn(*a)))
            first = fn(*a)
            err = max(err, float((first.double() - ref).abs().max()))
            repeats &= all(torch.equal(fn(*a), first) for _ in range(19))
        print(json.dumps({"route": name, "median_ms": statistics.median(ms),
                          "sum_ms": sum(ms), "max_abs_err_vs_f64": err,
                          "repeats_20x": repeats}), flush=True)


if __name__ == "__main__":
    main()
