"""Run one cell of nice_slam_torch's benchmark once and print its result.

    python benchmark/run.py --workload room0.strict --seed 7 --seconds 40 \
        --trace 0

from the root of a checkout.  Needs an NVIDIA card: without one (or with
fewer than the cell asks for) it exits non-zero and prints no result.
The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
--trace 1 its per-layer ones), `device`, with --trace 1 `breakdown`, and
last `check`: each number compared with its limit.  --readings 1 also
computes the precision control (the reference in TF32, put in the
program's place), the reference in float64 and the reference with each
tracking fault of reference/check.TRACK_FAULTS on the same captures, and
prints their numbers, and whether they pass the limits, on standard
error.  What is followed and costed is the configuration's mode's
(benchmark/modes/<mode>.py, registry.mode_of).
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import copy  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "nice_slam_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--readings", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def cache_env() -> None:
    """Kernel caches at fixed places inside the checkout; the port builds
    its own libraries under nice_slam_torch/_build."""
    base = os.path.join(ROOT, ".bench_cache")
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(base, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(base, "torch_extensions"))


def engine_cfg(conf: dict, seed: int, workload: str) -> dict:
    cfg = copy.deepcopy(conf["cfg"])
    cfg["tpu"]["seed"] = int(seed)
    cfg["data"]["output"] = os.path.join(tempfile.gettempdir(),
                                         "nice_slam_bench", workload)
    cfg["pretrained_decoders"]["tpu_npz"] = os.path.join(
        ROOT, cfg["pretrained_decoders"]["tpu_npz"])
    return cfg


def frame_cam(cfg: dict) -> dict:
    """The frames' size and intrinsics as the engine sees them."""
    c = cfg["cam"]
    e = c.get("crop_edge", 0) or 0
    return {"H": c["H"] - 2 * e, "W": c["W"] - 2 * e, "fx": c["fx"],
            "fy": c["fy"], "cx": c["cx"] - e, "cy": c["cy"] - e,
            "png_depth_scale": c["png_depth_scale"]}


def make_context(d, cfg, tr, window_s):
    """What the per-layer readers read."""
    from benchmark import registry
    from benchmark.costs import decode as cd

    spans = {"track": d.track_spans.ms(d.win_ev[0] if d.cuda else d.t_ws),
             "map": d.map_spans.ms(d.win_ev[0] if d.cuda else d.t_ws),
             "first_event": d.first_event.ms()}
    window_ms = (d.win_ev[0].elapsed_time(d.win_ev[1]) if d.cuda
                 else window_s * 1e3)

    def roofline(direction, kernels):
        if not tr:
            return None
        c0, c1 = d.counters["profile_start"], d.counters["profile_end"]
        least = sum((n - c0[direction].get(k, 0))
                    * cd.launch_bound_ms(k, direction)
                    for k, n in c1[direction].items())
        dev_s = sum(s for name, s in tr["kernel_s"].items()
                    if any(k in name for k in kernels))
        if dev_s <= 0 or least <= 0:
            return None
        return 100.0 * least / (dev_s * 1e3)

    return SimpleNamespace(
        spans=spans, counters=d.counters, trace=tr, cfg=cfg,
        window_s=window_s, window_ms=window_ms, roofline=roofline,
        schedule_least_ms=lambda: registry.mode(
            registry.mode_of(cfg)).schedule_least_ms(
                cfg, len(spans["track"]), len(spans["map"])))


def main(argv=None) -> int:
    args = parse(argv)
    # the checkout's root, not this directory, heads the import path
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [ROOT] + [p for p in sys.path
                            if os.path.abspath(p or ".") != here]
    cache_env()
    import torch

    from benchmark import registry

    wl = registry.workload(args.workload)
    chips = int(wl.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"no result: {args.workload} needs {chips} CUDA device(s); "
            f"torch.cuda.is_available() = {torch.cuda.is_available()}")
        return 3
    result, check_lines = run_cell(args, wl, torch.device("cuda"),
                                   T_PROCESS)
    bad = forbidden_modules()
    if bad:
        log(f"no result: loaded modules {bad} (JAX or the JAX package)")
        return 4
    for line in check_lines:
        log(line)
    print(json.dumps(result), flush=True)
    return 0


def run_cell(args, wl, dev, t_process, engine_hook=None, conf=None):
    """Set-up, window, check.  Returns (result dict, check lines).
    `engine_hook(eng)` runs after the engine is built (the tests plant
    faults there); `conf` replaces the workload's configuration file (the
    tests' small one)."""
    import torch

    from benchmark import harness, registry, trace
    from benchmark.reference import check
    from benchmark.traffic.stream import make_stream

    conf = conf or registry.config(wl["config"])
    traffic = registry.traffic(wl["traffic"])
    cfg = engine_cfg(conf, args.seed, args.workload)
    cuda = dev.type == "cuda"
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    stream = make_stream(traffic, conf["scene"], frame_cam(cfg), args.seed,
                         dev)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    from nice_slam_torch.engine import SlamEngine
    from nice_slam_torch.parallel.pipelined import PipelinedSlamEngine

    ds = harness.StreamDataset(stream, int(conf["sequence_length"]))
    cls = PipelinedSlamEngine if cfg["tpu"]["pipelined"] else SlamEngine
    eng = cls(cfg, dataset=ds, output=cfg["data"]["output"],
              device=str(dev))
    start_params = check._dev_tree(eng.map_state.params, "cpu")
    if engine_hook is not None:
        engine_hook(eng)
    d = harness.Driver(eng, wl, args.seconds, bool(args.trace), args.seed)
    d.install()
    ds.driver = d
    try:
        eng.run()
        raise RuntimeError("the stream ran out before the window closed")
    except harness.StopWindow:
        pass
    if cuda:
        torch.cuda.synchronize()
    window_s = d.t_we - d.t_ws
    setup_s = d.t_ws - t_process
    frames = d.end_idx - d.warm
    turn = [(d.takes[i + 1] - d.takes[i]) * 1e3
            for i in range(d.warm, d.end_idx)]
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    tr = None
    if args.trace:
        tr = trace.summarize(d.prof, d.prof_t[1] - d.prof_t[0],
                             harness.ANNOTATIONS)
    ctx = make_context(d, cfg, tr, window_s)
    p90 = statistics.quantiles(turn, n=10)[-1] if len(turn) > 1 else turn[0]
    log(f"window: frames {d.warm}..{d.end_idx - 1} ({frames} frames, "
        f"{len(ctx.spans['map'])} mapping events) in {window_s:.4f} s; "
        f"frame turnaround samples {len(turn)}, median "
        f"{statistics.median(turn):.3f} ms, p90 {p90:.3f} ms; set-up "
        f"{setup_s:.3f} s; graphs {d.counters['window_end']['graphs']}")
    g0 = d.counters["window_start"]["graphs"]
    g1 = d.counters["window_end"]["graphs"]
    captured_in_window = sum(g1[s]["captures"] - g0[s]["captures"]
                             for s in g1)
    if captured_in_window:
        log(f"note: {captured_in_window} graph(s) captured inside the "
            "window")
    e2e = {"frames_per_s": (frames / window_s, "frames/s"),
           "frame_ms_p90": (p90, "ms"),
           "peak_mem_mib": (peak / 2**20, "MiB"),
           "setup_s": (setup_s, "s")}
    metrics = {}
    if args.trace:
        for name, mod in registry.metrics_for(
                args.workload, mode=registry.mode_of(cfg)).items():
            v = mod.read(ctx)
            if v is not None and math.isfinite(v):
                metrics[name] = {"value": v, "unit": mod.UNIT}
    else:
        metrics = {k: {"value": v, "unit": u} for k, (v, u) in e2e.items()}
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
              "count": 1, "memory_peak_bytes": int(peak)}
    if tr:
        device["busy_s"] = tr["busy_s"]
        device["window_s"] = tr["window_s"]

    # the program's state goes before the reference runs
    captures = d.captures
    d.prof = None
    del eng, d, ds
    gc.collect()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    numbers, lines = judge(cfg, wl, captures, stream, dev, start_params,
                           bool(args.readings))
    correct = is_correct(numbers)
    result = {"correct": correct, "attempted": frames,
              "failed": 0, "metrics": metrics, "device": device}
    if tr:
        result["breakdown"] = {"device_ops": tr["device_ops"],
                               "idle_gaps": tr["idle_gaps"]}
    result["check"] = numbers
    return result, lines


def compared(vals: dict, limits: dict) -> dict:
    """The numbers that the workload's limits name, each with its limit
    ('sampled', limit 0, where the window reached no sampled frame or
    event)."""
    numbers = {k: {"value": v, "limit": limits[k]}
               for k, v in vals.items() if k in limits}
    if "sampled" in vals:
        numbers["sampled"] = {"value": vals["sampled"], "limit": 0.0}
    return numbers


def is_correct(numbers: dict) -> bool:
    return all(v["value"] <= v["limit"] for v in numbers.values())


def judge(cfg, wl, captures, stream, dev, start_params, readings: bool):
    """The numbers compared, each with its limit (workload 'limits'), and
    the lines that show them: the cell's mode (registry.mode_of) follows
    the captures (its `judge`, reference/check.judge), and with
    `readings` the control, the reference in float64 and the tracking
    faults, put in the program's place, go through the same limits."""
    from benchmark import registry

    got = registry.mode(registry.mode_of(cfg)).judge(
        cfg, captures, stream, dev, start_params, readings)
    limits = wl["limits"]
    numbers = compared(got.vals, limits)
    lines = got.head + ["readings not compared: " + json.dumps(
        {k: v for k, v in got.vals.items() if k not in numbers})]
    lines += [f"{name}: correct {is_correct(compared(v, limits))}; "
              + json.dumps(v) for name, v in got.sides]
    lines += got.detail
    lines += [f"check {k}: {v['value']!r} limit {v['limit']!r}"
              for k, v in numbers.items()]
    return numbers, lines


if __name__ == "__main__":
    sys.exit(main())
