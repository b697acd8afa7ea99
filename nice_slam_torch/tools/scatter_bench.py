"""The grid backward's scatter on the main path's own inputs, by route.

    python3 -m nice_slam_torch.tools.scatter_bench [--calls 24]

Runs the strict path of configs/Synthetic/synthetic.yaml at full width on
one GPU for two frames (the first mapping event cut to 60 iterations:
middle, fine and colour stages) and records the first `--calls` inputs of
every grid's backward scatter (ops/grid.scatter_rows: the corner rows and
the weighted cotangent rows).  On each recorded input it times, with CUDA
events, every route that sums the rows into the grid:

  index_add     torch.zeros + index_add_ (atomics: the order changes from
                run to run)
  sorted        stable sort, then one sequential segment sum over each
                row's whole run (the first fixed-order route)
  index_put     torch.zeros + index_put_(accumulate=True), PyTorch's
                sort-based route
  blocked{K}    scatter_rows with pieces of at most K entries (stable
                sort, each row's run summed in pieces of K, then the
                pieces in order); K = 64 is the default

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


def sorted_sum(rows, vals, n_rows: int):
    """The first fixed-order route: a stable sort, then one sequential
    segment sum over each row's whole run."""
    sorted_rows, perm = torch.sort(rows, stable=True)
    offsets = torch.searchsorted(
        sorted_rows, torch.arange(n_rows + 1, device=rows.device))
    return torch.segment_reduce(vals[perm], "sum", offsets=offsets, axis=0)


def routes():
    def index_add(r, v, n):
        return torch.zeros(n, v.shape[1], device=v.device).index_add_(
            0, r, v)

    def index_put(r, v, n):
        return torch.zeros(n, v.shape[1], device=v.device).index_put_(
            (r,), v, accumulate=True)

    out = {"index_add": index_add, "sorted": sorted_sum,
           "index_put": index_put}
    for k in (16, 64, 256):
        out[f"blocked{k}"] = (
            lambda r, v, n, k=k: grid.scatter_rows(r, v, n, block=k))
    return out


def record(n_calls: int):
    from nice_slam_torch.config import load_config
    from nice_slam_torch.engine import SlamEngine

    calls = []
    orig = grid.scatter_rows

    def rec(rows, vals, n_rows):
        if len(calls) < n_calls:
            calls.append((rows.clone(), vals.clone(), n_rows))
        return orig(rows, vals, n_rows)

    cfg = load_config(
        os.path.join(REPO, "configs", "Synthetic", "synthetic.yaml"),
        overrides={"synthetic": {"n_frames": 2},
                   "mapping": {"iters_first": 60},
                   "data": {"output": os.path.join(REPO, "output",
                                                   "scatter_bench")}})
    grid.scatter_rows = rec
    try:
        SlamEngine(cfg, device="cuda").run()
    finally:
        grid.scatter_rows = orig
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
    lengths = [torch.bincount(r, minlength=n).float() for r, _, n in calls]
    print(json.dumps({
        "calls": len(calls),
        "points_x8": sorted({int(r.shape[0]) for r, _, _ in calls}),
        "grid_rows": sorted({n for _, _, n in calls}),
        "max_run": max(float(x.max()) for x in lengths),
        "mean_nonempty_run": statistics.mean(
            float(x[x > 0].mean()) for x in lengths)}), flush=True)
    refs = [torch.zeros(n, v.shape[1], dtype=torch.float64,
                        device=v.device).index_add_(0, r, v.double())
            for r, v, n in calls]
    for name, fn in routes().items():
        ms = [time_ms(lambda r=r, v=v, n=n: fn(r, v, n))
              for r, v, n in calls]
        repeats, err = True, 0.0
        for (r, v, n), ref in zip(calls, refs):
            first = fn(r, v, n)
            err = max(err, float((first.double() - ref).abs().max()))
            repeats &= all(torch.equal(fn(r, v, n), first)
                           for _ in range(19))
        print(json.dumps({"route": name, "median_ms": statistics.median(ms),
                          "sum_ms": sum(ms), "max_abs_err_vs_f64": err,
                          "repeats_20x": repeats}), flush=True)


if __name__ == "__main__":
    main()
