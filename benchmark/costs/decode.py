"""Operations and bytes of the NICE decoders, from their shapes alone.

Frozen copy of `_n_weights`, `_macs`, `decode_work` and `bound_ms` from
the repository's chip_smoke.py (held equal to them by
benchmark/tests/test_bench_costs.py), plus `step_flops`: the least work of
one decoder evaluation for the whole-step share of the peak, which counts
no recomputation and covers the decoders the fused kernels do not run
(the middle stage's middle decoder and the coarse mapper's).

Peaks: NVIDIA's data sheet for the H100 SXM, dense rates: fp32 outside
the tensor cores 67 TFLOP/s, TF32 on the tensor cores 495 TFLOP/s (the
3xTF32 products that keep fp32 accuracy run at a third of it), HBM3
3.35 TB/s, all at the full 700 W power limit.
"""

from __future__ import annotations

PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12

HID, EMB = 32, 93
LAYER_IN = [EMB, HID, HID, HID + EMB, HID]
DEC_C = {"middle": 32, "fine": 64, "color": 32}
DEC_O = {"middle": 1, "fine": 1, "color": 4}
DECS = ("middle", "fine", "color")
# the coarse decoder: no point input, the feature skip after block 2
COARSE_C = 32
COARSE_IN = [COARSE_C, HID, HID, HID + COARSE_C, HID]


def _n_weights(dec: str) -> int:
    c, o = DEC_C[dec], DEC_O[dec]
    return (3 * EMB + sum(n * HID for n in LAYER_IN) + 5 * HID
            + 5 * c * HID + 5 * HID + HID * o + o)


def _macs(dec: str, direction: str, live: bool):
    """(tensor-core MAC, SIMT MAC) per point of one decoder, as the fused
    kernels compute them: the backward recomputes the forward, takes dc
    only for the first 32 feature columns and the weight-gradient products
    only when live."""
    c, o = DEC_C[dec], DEC_O[dec]
    trunk = sum(n * HID for n in LAYER_IN)
    tc = trunk + 5 * c * HID
    simt = 3 * EMB + HID * o
    if direction == "bwd":
        tc, simt = tc + trunk + 5 * HID * HID, simt + 3 * EMB + HID * o
        if live:
            tc += trunk + 5 * c * HID
            simt += 3 * EMB + HID * o
    return tc, simt


def decode_work(n: int, with_color: bool, direction: str, live: int = 0):
    """(tensor-core flops, SIMT flops, bytes) of one fused-decode launch on
    n points; live: bit d set = decoder d takes weight gradients."""
    decs = DECS[:3 if with_color else 2]
    tc = simt = 0
    for d, name in enumerate(decs):
        t, s_ = _macs(name, direction, bool(live >> d & 1))
        tc, simt = tc + t, simt + s_
    wbytes = 4 * sum(_n_weights(d) for d in decs)
    n_c = len(decs)
    if direction == "fwd":
        nbytes = n * 4 * (3 + HID * n_c + 4) + wbytes
    else:
        gbytes = 4 * sum(_n_weights(d) for k, d in enumerate(decs)
                         if live >> k & 1)
        nbytes = (n * 4 * (3 + HID * n_c + 4)
                  + n * 4 * (3 + HID * n_c)
                  + wbytes + gbytes)
    return 2 * tc * n, 2 * simt * n, nbytes


def bound_ms(tc_flops: float, simt_flops: float, nbytes: float,
             tensor_cores: bool = False):
    """(ms, 'operations' | 'bytes'): fp32 on the CUDA cores, or with
    tensor_cores the width-32 products at the 3xTF32 rate."""
    t_ops = ((tc_flops / (PEAK_TF32_FLOPS / 3) if tensor_cores
              else tc_flops / PEAK_FP32_FLOPS)
             + simt_flops / PEAK_FP32_FLOPS) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes")


def launch_bound_ms(kind: str, direction: str) -> float:
    """Least time (ms, 3xTF32) of one K1 ('fwd') or K2 ('bwd') launch of a
    kind as the port's counters name it: 'color n=48000' forward,
    'color wgrad n=48000' / 'fine no-wgrad n=48000' backward.  A K2
    launch with weight gradients in the colour stage trains the colour
    decoder only (the fine decoder is fixed, the middle one untrained:
    mapping.fix_fine, train_middle_decoder False)."""
    parts = kind.split()
    stage, n = parts[0], int(parts[-1].split("=")[1])
    with_color = stage == "color"
    live = 0
    if direction == "bwd" and parts[1] == "wgrad":
        live = 4 if with_color else 2
    return bound_ms(*decode_work(n, with_color, direction, live),
                    tensor_cores=True)[0]


def _least_macs(dec: str, direction: str, live: bool, need_dp: bool):
    """(tensor-core MAC, SIMT MAC) per point of one decoder, counting what
    any implementation has to compute: the forward once; in the backward
    the data gradients (dh W^T through the trunk, dc for 32 feature
    columns, dp through the embedding when the points need one) and the
    weight gradients when live, no recomputation."""
    if dec == "coarse":
        trunk = sum(n * HID for n in COARSE_IN)
        if direction == "fwd":
            return trunk, HID
        # every input takes a gradient: the feature enters at block 0
        # and again through the skip
        return trunk + (trunk if live else 0), HID
    c, o = DEC_C[dec], DEC_O[dec]
    trunk = sum(n * HID for n in LAYER_IN)
    if direction == "fwd":
        return trunk + 5 * c * HID, 3 * EMB + HID * o
    # the embedding's two entries (block 0 and the skip) take a gradient
    # only when the points need one
    tc = trunk - 2 * EMB * HID + 5 * HID * min(c, 32)
    simt = HID * o
    if need_dp:
        tc += 2 * EMB * HID
        simt += 3 * EMB
    if live:
        tc += trunk + 5 * c * HID
        simt += 3 * EMB + HID * o
    return tc, simt


STAGE_DECS = {"coarse": ("coarse",), "middle": ("middle",),
              "fine": ("middle", "fine"),
              "color": ("middle", "fine", "color")}


def step_flops(stage: str, n: int, direction: str, live=(),
               need_dp: bool = False):
    """(tensor-core flops, SIMT flops) of one evaluation of a stage's
    decoders on n points; `live`: the decoders that take weight
    gradients."""
    tc = simt = 0
    for dec in STAGE_DECS[stage]:
        t, s_ = _least_macs(dec, direction, dec in live, need_dp)
        tc, simt = tc + t, simt + s_
    return 2 * tc * n, 2 * simt * n


def step_ops_ms(tc_flops: float, simt_flops: float) -> float:
    """Least time in ms of that work from operations alone, 3xTF32."""
    return (tc_flops / (PEAK_TF32_FLOPS / 3)
            + simt_flops / PEAK_FP32_FLOPS) * 1e3


def schedule_least_ms(cfg: dict, n_frames: int, n_events: int) -> float:
    """NICE's least time: the decoder work of n_frames tracked frames
    (from the third on, with init_select's two renders) and n_events
    steady mapping events without bundle adjustment."""
    t, m, r = cfg["tracking"], cfg["mapping"], cfg["rendering"]
    per_ray = r["N_samples"] + r["N_surface"]
    n_t = t["pixels"] * per_ray
    frame = t["iters"] * (
        step_ops_ms(*step_flops("color", n_t, "fwd"))
        + step_ops_ms(*step_flops("color", n_t, "bwd", need_dp=True)))
    if t["const_speed_assumption"] and t["init_select"]:
        frame += 2 * step_ops_ms(*step_flops("color", n_t, "fwd"))
    wn = m["mapping_window_size"]
    rays = m["pixels"] // wn * wn
    n_m, n_c = rays * per_ray, rays * r["N_samples"]
    n = m["iters"]
    n_mid = min(int(n * m["middle_iter_ratio"]) + 1, n)
    n_fine = max(min(int(n * m["fine_iter_ratio"]) + 1, n) - n_mid, 0)
    n_col = n - n_mid - n_fine
    ev = 0.0
    for stage, iters, live in (("middle", n_mid, ()), ("fine", n_fine, ()),
                               ("color", n_col, ("color",))):
        ev += iters * (step_ops_ms(*step_flops(stage, n_m, "fwd"))
                       + step_ops_ms(*step_flops(stage, n_m, "bwd", live)))
    if cfg.get("coarse"):
        ev += n * (step_ops_ms(*step_flops("coarse", n_c, "fwd"))
                   + step_ops_ms(*step_flops("coarse", n_c, "bwd")))
    return n_frames * frame + n_events * ev
