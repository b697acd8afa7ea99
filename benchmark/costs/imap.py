"""Operations of iMAP*'s decoder over a window's schedule, from the
configuration's shapes alone, whatever implements them.

The decoder (models/decoders.py's iMAP* spec, upstream
src/conv_onet/config.py:28-32): the Fourier embedding sin(p B) (3 x 93),
four 256-wide ReLU layers (93 -> 256, then 256 -> 256), a head to rgb and
density (256 -> 4).  One evaluation's least work counts the forward once
and, in the backward, the data gradients down through every layer, the
gradient into the embedding's output where B trains or the points need
one, the points' (through B) where they need one, and the weight
gradients of every layer and of B where the weights train: no
recomputation.  The hidden layers' products count at the 3xTF32 rate and
the embedding's and the head's (3 and 4 wide) at fp32's, with the peaks
of costs/decode.py, so a later tensor-core kernel cannot read over 100%.
"""

from __future__ import annotations

from benchmark.costs.decode import step_ops_ms

EMB, HID, OUT = 93, 256, 4
HIDDEN_IN = (EMB, HID, HID, HID)


def point_macs(direction: str, train: bool = False,
               need_dp: bool = False):
    """(3xTF32 MAC, fp32 MAC) of one point through the decoder: 'fwd', or
    'bwd' with the weights' gradients (`train`) and the points'
    (`need_dp`)."""
    hidden = sum(n * HID for n in HIDDEN_IN)
    if direction == "fwd":
        return hidden, 3 * EMB + HID * OUT
    tc = hidden - EMB * HID                  # dh through layers 1..3
    simt = HID * OUT                         # dh through the head
    if train or need_dp:
        tc += EMB * HID                      # into the embedding's output
    if need_dp:
        simt += 3 * EMB                      # to the points through B
    if train:
        tc += hidden                         # the hidden layers' weights
        simt += HID * OUT + 3 * EMB          # the head's and B
    return tc, simt


def pass_ms(n_points: int, direction: str, train: bool = False,
            need_dp: bool = False) -> float:
    """Least time in ms of one evaluation on n_points."""
    tc, simt = point_macs(direction, train, need_dp)
    return step_ops_ms(2 * tc * n_points, 2 * simt * n_points)


def render_ms(cfg: dict, rays: int, train: bool, need_dp: bool,
              backward: bool = True) -> float:
    """One render of `rays` rays: the first pass (N_samples + N_surface
    depths) forward, the second (N_importance more) forward, and the
    backward through the pass whose output the loss reads."""
    r = cfg["rendering"]
    first = r["N_samples"] + r["N_surface"]
    last = first + r["N_importance"]
    ms = pass_ms(rays * first, "fwd")
    if r["N_importance"] > 0:
        ms += pass_ms(rays * last, "fwd")
    if backward:
        ms += pass_ms(rays * last, "bwd", train, need_dp)
    return ms


def schedule_least_ms(cfg: dict, n_frames: int, n_events: int) -> float:
    """Least time of the decoder work of n_frames tracked frames (from the
    third on: `iters` renders with the camera's gradient and, with
    init_select, two forward renders) and n_events steady mapping events
    (three passes of max(iters // 3, 1) iterations: a render with the
    weights' gradients, the points' under BA, and the regulation's
    densities forward and backward)."""
    t, m, r = cfg["tracking"], cfg["mapping"], cfg["rendering"]
    frame = t["iters"] * render_ms(cfg, t["pixels"], False, True)
    if t["const_speed_assumption"] and t["init_select"]:
        frame += 2 * render_ms(cfg, t["pixels"], False, False,
                               backward=False)
    wn = m["mapping_window_size"]
    rays = m["pixels"] // wn * wn
    ba = bool(m["BA"])
    it = render_ms(cfg, rays, True, ba)
    if not cfg["occupancy"]:
        n_reg = rays * r["N_samples"]
        it += pass_ms(n_reg, "fwd") + pass_ms(n_reg, "bwd", True, ba)
    ev = 3 * max(m["iters"] // 3, 1) * it
    return n_frames * frame + n_events * ev
