#!/usr/bin/env python3
"""Smoke test of the PyTorch port (nice_slam_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi) and builds every
   CUDA kernel from nice_slam_torch/csrc (one nvcc per source, together).
2. Kernel phase: the fused decode forward (K1) and backward (K2) against
   their plain PyTorch versions on the card, at N = 9,600 (tracking),
   48,000 (mapping) and 700 (ragged), in the fine and colour stages, with
   and without weight gradients.  Tolerances: forward max abs err
   <= 1e-4 * max(1, max|ref|); dp and dc elementwise rtol 1e-3, atol 1e-4
   against autograd of the plain version, where a missing point is
   accepted only if one of its ReLU pre-activations lies within 1e-4 of
   zero (a ReLU that flips between the two summation orders), and at most
   max(2, N/1000) such points; weight gradients per array cosine > 0.9999
   and norm ratio within 1e-3 (summation order over 48k points), taken
   with the cotangent of the points that have a pre-activation within
   1e-4 of zero set to zero in both runs (one flipped ReLU moves a whole
   sum).  The reported max_abs_err of K2 is over the other points.
3. Main path: SlamEngine on configs/Synthetic/synthetic.yaml at its full
   width (240x320, tracking 200 px x 50 iters, mapping 1000 px x 60 iters,
   iters_first 500, 32+16 samples, hidden 32, c_dim 32, coarse mapper on)
   for 11 frames (synthetic.n_frames: 11, so frame 10 is the last frame
   and its colour refinement runs).  Decoders come from the repository's
   pretrained/decoders_tpu.npz as the config says; the grids are random
   from the config's seed.  Fails unless the kernel launch counts match
   the schedule and the ATE is finite and under 0.25 m.
4. Profile: torch.profiler over one more tracked frame and mapping event
   of the trained engine gives the device busy share and the top kernels.
5. Timing phase at N = 48,000 (colour stage, weight gradients on): each
   kernel with CUDA events beside its plain version and its bound.  There
   is no single PyTorch call that computes the fused decode, so
   library_ms is null.

The last two lines are a JSON object of the kernels and the contract line
{"ok": true, "device": {...}}.  Any failed phase exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

# published peaks of the H100 SXM (NVIDIA data sheet): fp32 outside the
# tensor cores and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

REPO = os.path.dirname(os.path.abspath(__file__))
SYN_CFG = os.path.join(REPO, "configs", "Synthetic", "synthetic.yaml")


class SmokeFailure(Exception):
    pass


def fail_if(cond: bool, msg: str):
    if cond:
        raise SmokeFailure(msg)


# ---------------------------------------------------------------------------
# Work and bytes of the fused decode, from its shapes

HID, EMB = 32, 93
LAYER_IN = [EMB, HID, HID, HID + EMB, HID]
DEC_C = {"middle": 32, "fine": 64, "color": 32}
DEC_O = {"middle": 1, "fine": 1, "color": 4}


def _macs_fwd(dec: str) -> int:
    c, o = DEC_C[dec], DEC_O[dec]
    return 3 * EMB + sum(n * HID for n in LAYER_IN) + 5 * c * HID + HID * o


def _n_weights(dec: str) -> int:
    c, o = DEC_C[dec], DEC_O[dec]
    return (3 * EMB + sum(n * HID for n in LAYER_IN) + 5 * HID
            + 5 * c * HID + 5 * HID + HID * o + o)


def decode_work(n: int, with_color: bool, direction: str, train: bool):
    """(flops, bytes) of one call on n points.  The backward recomputes the
    forward (its inputs hold no activations), then takes the input VJPs
    (W^T, V^T, Wo^T, B^T products) and, with train, the weight-gradient
    products."""
    decs = ["middle", "fine"] + (["color"] if with_color else [])
    macs = 0
    for d in decs:
        f = _macs_fwd(d)
        if direction == "fwd":
            macs += f
        else:
            macs += 2 * f                 # recompute + input VJP
            if train:
                macs += f                 # dW, dV, dWo, dB
    flops = 2 * macs * n
    wbytes = 4 * sum(_n_weights(d) for d in decs)
    n_c = 3 if with_color else 2
    if direction == "fwd":
        nbytes = n * 4 * (3 + HID * n_c + 4) + wbytes
    else:
        nbytes = (n * 4 * (3 + HID * n_c + 4)          # p, c, g in
                  + n * 4 * (3 + HID * n_c)            # dp, dc out
                  + wbytes * (2 if train else 1))      # weights in, grads out
    return flops, nbytes


def bound_ms(flops: float, nbytes: float):
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes")


# ---------------------------------------------------------------------------
# Phase 2: kernels against the plain version

def make_inputs(torch, n: int, seed: int, dev):
    g = torch.Generator(device="cpu").manual_seed(seed)
    # points inside the synthetic scene's bound, features at the scale
    # of trained grids
    p = torch.rand(n, 3, generator=g) * 5.0 - 0.5
    cm = torch.randn(n, HID, generator=g) * 0.1
    cf = torch.randn(n, HID, generator=g) * 0.1
    cc = torch.randn(n, HID, generator=g) * 0.1
    go = torch.randn(n, 4, generator=g)
    return [t.to(dev).contiguous() for t in (p, cm, cf, cc, go)]


def relu_margin(torch, fd, with_color, p, cm, cf, cc, ws):
    """Per point, the smallest |pre-activation| over its decoders' units."""
    from nice_slam_torch.ops.fused_decode import _mlp_forward, _unpack

    mins = []
    cfull = torch.cat([cf, cm], dim=-1)
    for d, c in ((0, cm), (1, cfull)) + (((2, cc),) if with_color else ()):
        _, (_, _, zs, _) = _mlp_forward(p, c, *_unpack(ws, d), save=True)
        mins.append(torch.stack([z.abs().amin(dim=1) for z in zs]).amin(0))
    return torch.stack(mins).amin(0)


def check_kernels(torch, fd, ws, dev, log):
    """Returns (max abs err of K1, max abs err of K2)."""
    err_f = err_b = 0.0
    seed = 0
    for n in (9600, 48000, 700):
        for stage in ("fine", "color"):
            with_color = stage == "color"
            for train in (False, True):
                seed += 1
                p, cm, cf, cc, go = make_inputs(torch, n, seed, dev)
                cc_in = cc if with_color else cm
                # forward through the wrapper (kernel) and the oracle
                with torch.no_grad():
                    out = fd.fused_nice_decode(with_color, train, p, cm, cf,
                                               cc_in, *ws)
                    torch.cuda.synchronize()
                    ref = fd.reference_nice_decode(with_color, p, cm, cf,
                                                   cc_in, *ws)
                e = float((out - ref).abs().max())
                tol = 1e-4 * max(1.0, float(ref.abs().max()))
                fail_if(not math.isfinite(e) or e > tol,
                        f"K1 n={n} {stage}: max abs err {e} > {tol}")
                err_f = max(err_f, e)

                # backward through the wrapper (kernel) and autograd of
                # the oracle
                def grads(fn, cot):
                    xs = [t.clone().requires_grad_(True)
                          for t in (p, cm, cf, cc_in)]
                    wr = [w.clone().requires_grad_(train) for w in ws]
                    o = fn(with_color, xs[0], xs[1], xs[2], xs[3], wr)
                    want = xs + (wr if train else [])
                    return torch.autograd.grad((o * cot).sum(), want,
                                               allow_unused=True)

                def kern(c, a, b, d, e_, w):
                    return fd.fused_nice_decode(c, train, a, b, d, e_, *w)

                def plain(c, a, b, d, e_, w):
                    return fd.reference_nice_decode(c, a, b, d, e_, *w)

                with torch.no_grad():
                    # points with every ReLU pre-activation >= 1e-4 from 0
                    steady = relu_margin(torch, fd, with_color, p, cm, cf,
                                         cc, ws) >= 1e-4
                gk = grads(kern, go)
                torch.cuda.synchronize()
                gr = grads(plain, go)
                names = ["dp", "dc_mid", "dc_fine"] + (
                    ["dc_color"] if with_color else [])
                for k, name in enumerate(names):
                    a, b = gk[k], gr[k]
                    err_b = max(err_b, float((a - b)[steady].abs().max()))
                    bad = ~torch.isclose(a, b, rtol=1e-3, atol=1e-4)
                    rows = bad.any(dim=1).nonzero().flatten()
                    if rows.numel() == 0:
                        continue
                    unexplained = int(steady[rows].sum())
                    fail_if(unexplained > 0
                            or rows.numel() > max(2, n // 1000),
                            f"K2 n={n} {stage} train={train}: {name} misses "
                            f"at {rows.numel()} points ({unexplained} "
                            "without a ReLU near zero), max abs err "
                            f"{float((a - b).abs().max())}")
                    log(f"  K2 n={n} {stage} {name}: {rows.numel()} points "
                        "differ by a ReLU flip (pre-activation < 1e-4)")
                if train:
                    # weight gradients sum over all points, so a flipped
                    # ReLU moves whole sums: compare them on the points
                    # whose pre-activations all lie >= 1e-4 from zero (the
                    # others' cotangent zeroed in both runs)
                    go_s = go * steady[:, None]
                    gk = grads(kern, go_s)
                    torch.cuda.synchronize()
                    gr = grads(plain, go_s)
                    for k in range(len(ws)):
                        a, b = gk[4 + k], gr[4 + k]
                        b = torch.zeros_like(ws[k]) if b is None else b
                        a = torch.zeros_like(ws[k]) if a is None else a
                        nb, na = float(b.norm()), float(a.norm())
                        if nb == 0.0:
                            fail_if(na != 0.0, f"K2 n={n} {stage}: weight "
                                    f"grad {k} should be 0, norm {na}")
                            continue
                        cos = float((a * b).sum()) / max(na * nb, 1e-30)
                        fail_if(cos <= 0.9999 or abs(na / nb - 1) > 1e-3,
                                f"K2 n={n} {stage}: weight grad {k} "
                                f"cosine {cos} norm ratio {na / nb}")
                log(f"kernel check n={n} stage={stage} train={train}: ok "
                    f"(fwd err {err_f:.3g}, bwd err {err_b:.3g})")
    return err_f, err_b


# ---------------------------------------------------------------------------
# Phase 3: the main path

def expected_launches(cfg, n_img: int):
    """Fused-decode launches of the strict schedule over n_img frames:
    every fine/colour-stage mapping iteration (forward + backward), every
    tracking iteration (forward + backward) and the two init_select
    renders of each frame from the third on (forward)."""
    m, t = cfg["mapping"], cfg["tracking"]

    def fused_iters(n, mid, fine):
        n_mid = min(int(n * mid) + 1, n)
        n_fine = max(min(int(n * fine) + 1, n) - n_mid, 0)
        return n - n_mid                  # fine + colour iterations

    ratios = (m["middle_iter_ratio"], m["fine_iter_ratio"])
    events = [fused_iters(m["iters_first"], *ratios)]
    track_fwd = track_bwd = 0
    cur = 1
    every = m["every_frame"]
    while cur < n_img:
        g_end = min(((cur - 1) // every + 1) * every, n_img - 1)
        for idx in range(cur, g_end + 1):
            track_fwd += t["iters"]
            track_bwd += t["iters"]
            if (t["const_speed_assumption"] and t["init_select"]
                    and idx >= 2):
                track_fwd += 2
        if g_end == n_img - 1 and m["color_refine"]:
            events.append(5 * fused_iters(m["iters"], 0.0, 0.0))
        else:
            events.append(fused_iters(m["iters"], *ratios))
        cur = g_end + 1
    return track_fwd + sum(events), track_bwd + sum(events)


def run_main_path(torch, fd, log):
    from nice_slam_torch.config import load_config
    from nice_slam_torch.engine import SlamEngine

    n_frames = 11
    cfg = load_config(SYN_CFG, overrides={
        "synthetic": {"n_frames": n_frames},
        "data": {"output": os.path.join(REPO, "output", "chip_smoke")}})
    eng = SlamEngine(cfg, device="cuda")
    # the dataset renders frames on the host: render them before timing
    for i in range(n_frames):
        eng.dataset[i]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fd.reset_launch_counts()
    t0 = time.perf_counter()
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = fd.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    ate = eng.ate()["rmse"]
    exp_f, exp_b = expected_launches(cfg, n_frames)
    log(f"main path: {n_frames} frames in {wall:.3f} s = "
        f"{n_frames / wall:.4f} frames/s, ATE rmse {ate:.5f} m, peak "
        f"device memory {peak / 2**20:.1f} MiB, timings {eng.timings}")
    log(f"main path launches: K1 {counts['fused_decode_fwd']} (schedule "
        f"{exp_f}), K2 {counts['fused_decode_bwd']} (schedule {exp_b})")
    fail_if(counts["fused_decode_fwd"] == 0 or counts["fused_decode_bwd"] == 0,
            "a kernel of the main path was never launched")
    fail_if(counts["fused_decode_fwd"] != exp_f
            or counts["fused_decode_bwd"] != exp_b,
            "launch counts differ from the schedule")
    fail_if(not math.isfinite(ate) or ate > 0.25,
            f"ATE {ate} not finite or above 0.25 m")
    return counts, eng


def profile_window(torch, eng, log):
    """Device busy share of the main path's work, read with torch.profiler
    over one tracked frame and one mapping event of the trained engine
    (the last frame again).  The profiler adds host time, so the idle
    share it gives is an upper bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from nice_slam_torch.tracking import track_step

    s = eng.specs
    idx = eng.n_img - 1
    colors, depths, _ = eng._load_frames(idx, idx)
    st = eng.map_state
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        track_step(st.params, st.grids, eng.bound, eng.est_c2w_dev, idx,
                   colors[0], depths[0], s.camera, s.track, s.render,
                   s.model, gen=eng.gen)
        eng._map(idx, colors[0], depths[0], s.mapper, eng.iters,
                 eng.lr_factor, False, record=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # kernel rows only: an operator's row repeats its kernels' time
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    dev_s = sum(r[1] for r in rows) / 1e6
    if dev_s == 0.0:
        log("profile: the profiler recorded no device time; device busy "
            "share not measured")
        return
    log(f"profile (one tracked frame + one mapping event, profiler on): "
        f"wall {wall:.4f} s, device kernel time {dev_s:.4f} s, busy "
        f"share {dev_s / wall:.4f}, idle share <= {1 - dev_s / wall:.4f}")
    for key, us, count in sorted(rows, key=lambda r: -r[1])[:8]:
        log(f"  {us / 1e3:10.3f} ms  {count:6d} x  {key[:90]}")


# ---------------------------------------------------------------------------
# Phase 4: timing

def cuda_time_ms(torch, fn, warmup=3, reps=15):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def time_kernels(torch, fd, ws, dev, n, with_color, train, log):
    p, cm, cf, cc, go = make_inputs(torch, n, 99, dev)
    cc_in = cc if with_color else cm
    flat = fd.pack_flat(ws)
    res = {}
    with torch.no_grad():
        res["fwd_ms"] = cuda_time_ms(torch, lambda: fd._launch_fwd(
            with_color, p, cm, cf, cc_in, flat))
        res["fwd_plain_ms"] = cuda_time_ms(torch, lambda: fd.reference_nice_decode(
            with_color, p, cm, cf, cc_in, *ws))
        res["bwd_ms"] = cuda_time_ms(torch, lambda: fd._launch_bwd(
            with_color, train, p, cm, cf, cc_in, go, flat))
        res["bwd_plain_ms"] = cuda_time_ms(torch, lambda: fd.plain_nice_decode_bwd(
            with_color, train, p, cm, cf, cc_in, go, ws))
    for d in ("fwd", "bwd"):
        fl, by = decode_work(n, with_color, d, train)
        res[f"{d}_bound_ms"], res[f"{d}_bound_by"] = bound_ms(fl, by)
    log(f"timing n={n} with_color={with_color} train={train}: "
        + ", ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                    for k, v in res.items()))
    return res


def main() -> int:
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        from nice_slam_torch.models.decoders import ModelSpec, init_model
        from nice_slam_torch.models.pretrain import load_npz_decoders
        from nice_slam_torch.ops import cuda_build
        from nice_slam_torch.ops import fused_decode as fd
    except ImportError as e:
        print(f"chip_smoke: cannot import the port: {e}", file=sys.stderr)
        return 1

    def log(msg):
        print(msg, flush=True)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    logs = cuda_build.build_all()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if any(k in line for k in ("registers", "spill", "smem",
                                       "Function properties")):
                log(f"  [{name}] {line.strip()}")

    ws = [w.contiguous() for w in fd.pack_nice_weights(load_npz_decoders(
        os.path.join(REPO, "pretrained", "decoders_tpu.npz"),
        init_model(torch.Generator(device=dev).manual_seed(0), ModelSpec(),
                   device=dev)))]
    err_f, err_b = check_kernels(torch, fd, ws, dev, log)

    counts, eng = run_main_path(torch, fd, log)
    profile_window(torch, eng, log)

    t_map = time_kernels(torch, fd, ws, dev, 48000, True, True, log)
    time_kernels(torch, fd, ws, dev, 9600, True, False, log)
    src = "nice_slam_torch/csrc/fused_decode.cu"
    kernels = [
        {"name": "fused_decode_fwd", "route": "cuda", "source": src,
         "replaces": "nice_slam_tpu/ops/pallas/fused_decode.py:274",
         "launches": counts["fused_decode_fwd"], "max_abs_err": err_f,
         "ms": t_map["fwd_ms"], "plain_ms": t_map["fwd_plain_ms"],
         "bound_ms": t_map["fwd_bound_ms"],
         "bound_by": t_map["fwd_bound_by"], "library_ms": None},
        {"name": "fused_decode_bwd", "route": "cuda", "source": src,
         "replaces": "nice_slam_tpu/ops/pallas/fused_decode.py:304",
         "launches": counts["fused_decode_bwd"], "max_abs_err": err_b,
         "ms": t_map["bwd_ms"], "plain_ms": t_map["bwd_plain_ms"],
         "bound_ms": t_map["bwd_bound_ms"],
         "bound_by": t_map["bwd_bound_by"], "library_ms": None},
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
