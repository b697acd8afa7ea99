"""The comparison that decides `correct`: the reference follows the
captured tracked frames, and the first two steps of every stage of the
captured mapping event (NICE, reference/follow.py; iMAP*'s first pass,
reference/follow_imap.py), from the program's own state; each number
compared is the widest gap between what the program produced and what
the reference computes.

- `start`: the widest absolute gap between the decoders the program
  built at construction and the reference's own (the mode's: NICE's
  load of the same npz, iMAP*'s draw from the seed; exact).
- `track_first`: the widest relative gap of a sampled frame's first
  tracking loss (at the pose init_select kept, before any step).
- `track_loss`: the same over its first, last and best tracking loss.
- `track_pose`: the widest absolute gap of an entry of a sampled frame's
  kept [R | t] (metres for t).
- `track_near`: the same against the nearest of the reference's
  post-step poses (the kept step's choice left out).
- `track_init`: the widest entry gap of [R | t] between the program's
  first pre-step camera and the reference's start pose (the
  constant-speed extrapolation and init_select's choice).
- `track_iter_loss`: over the sampled frames' iterations, the widest
  relative gap of the loss at the program's pre-step camera, the
  reference's computed there with the program's draws.
- `track_step`: over the same iterations, the largest share of a step's
  first-moment mass (the reference's |m|, built from its own gradients
  at the program's cameras) on camera entries whose step departs from
  the reference's by more than half a nominal step.
- `track_flip`: the same as a share of the entries that move.
- `track_kept`: the widest entry gap of the kept [R | t] from the
  nearest of the program's own post-step cameras (its pre-step cameras
  from the second on, and its camera after the last step): the keep
  choice and the write-back, free of rounding's drift.
- `map_loss`: the widest relative gap of the event's loss at each
  followed iteration, the reference's computed at the program's state
  there.
- `map_step`: over the followed steps and the leaf groups whose Adam
  moments start in that stage (the middle grid; the fine grid; the
  colour grid, the colour decoder and, under BA, the window cameras;
  iMAP*: B, the hidden layers, the head and, under BA, the cameras),
  the largest share of the step's first-moment mass on entries whose
  step departs from the reference's by more than half a nominal step.
- `map_flip`: the same as a share of the entries that move.

A cell's workload file names the numbers it compares, with their limits;
the others are printed as readings.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from types import SimpleNamespace

import torch

from benchmark.reference import follow, plain


@contextlib.contextmanager
def precision(tf32: bool):
    """float32 matrix products in full fp32, or in TF32 for the control."""
    m, c = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def _dev_tree(tree, device, dtype=None):
    if isinstance(tree, dict):
        return {k: _dev_tree(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_dev_tree(v, device, dtype) for v in tree]
    return tree.to(device=device, dtype=dtype or tree.dtype)


def _rel(a, b) -> float:
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def _worse(a: float, b: float) -> float:
    """The larger of two gaps, a NaN read as infinite."""
    return max(math.inf if x != x else x for x in (a, b))


def _widest(gaps) -> float:
    return functools.reduce(_worse, gaps, 0.0)


def _gen(state, device):
    g = torch.Generator(device=device)
    g.set_state(state)
    return g


def start_gap(program_params: dict, npz_path: str) -> float:
    """Widest |program - npz| over the decoders' weights."""
    ref = plain.flatten(plain.load_decoders(npz_path, "cpu"))
    prog = plain.flatten(program_params)
    if set(ref) != set(prog):
        return float("inf")
    return max(float(torch.max(torch.abs(prog[k].float() - ref[k])))
               for k in ref)


def _frames(stream, device, dtype):
    """Frame i's (colour, depth) on the device, each made once."""
    cache = {}

    def frame(i):
        if i not in cache:
            c, d, _ = stream.frame(int(i))
            cache[i] = (torch.as_tensor(c, device=device, dtype=dtype),
                        torch.as_tensor(d, device=device, dtype=dtype))
        return cache[i]
    return frame


def follow_all(cfg, captures, stream, device, tf32: bool = False,
               dtype=torch.float32, follower=follow, **fault) -> dict:
    """The reference's outputs for every capture, in float32 (TF32 with
    `tf32`; float64 with that `dtype`, for the look at a number's
    conditioning; a tracking fault planted with `fault`, see
    follow.follow_tracking).  `follower` is the mode's module of
    followers: reference/follow.py (NICE) or reference/follow_imap.py
    (iMAP*)."""
    frame = _frames(stream, device, dtype)

    def dev(t):
        return t.to(device=device, dtype=dtype)

    out = {}
    with precision(tf32):
        for (kind, idx), cap in sorted(captures.items()):
            bound = dev(cap.bound)
            gen = _gen(cap.gen_state, device)
            if kind == "track":
                color, depth = frame(idx)
                out[(kind, idx)] = follower.follow_tracking(
                    cfg, _dev_tree(cap.params, device, dtype),
                    _dev_tree(cap.grids, device, dtype), bound, idx,
                    dev(cap.extra["pre"]), dev(cap.extra["pre_pre"]),
                    color, depth, gen, **fault)
                continue
            states = cap.extra["states"]
            if any(it not in states
                   for it in follower.snapshot_iterations(cfg)):
                out[(kind, idx)] = None
                continue
            states = {it: {"tree": _dev_tree(st["tree"], device, dtype),
                           "gen": st["gen"]} for it, st in states.items()}
            out[(kind, idx)] = follower.follow_mapping(
                cfg, bound, idx, dev(cap.extra["cur"]),
                dev(cap.extra["kf_c2w"]),
                [int(f) for f in cap.extra["kf_frames"].tolist()],
                cap.extra["count"], cap.extra["capacity"], frame, gen,
                states, pass_gens=[_gen(g, device) for g in
                                   cap.extra.get("pass_gens", ())])
    return out


def follow_steps(cfg, captures, stream, device, follower=follow) -> dict:
    """The float32 reference step by step from the cameras each tracked
    capture holds (the program's, or those of a side put in its place):
    {key: follower.follow_tracking_steps(...)}."""
    frame = _frames(stream, device, torch.float32)
    out = {}
    with precision(False):
        for (kind, idx), cap in sorted(captures.items()):
            if kind != "track":
                continue
            color, depth = frame(idx)
            out[(kind, idx)] = follower.follow_tracking_steps(
                cfg, _dev_tree(cap.params, device),
                _dev_tree(cap.grids, device), cap.bound.to(device), idx,
                color, depth, _gen(cap.gen_state, device),
                cap.out["cams"].to(device=device, dtype=torch.float32))
    return out


def map_loss_at(cap, it) -> float:
    """A mapping capture's loss at iteration it (the program's losses are
    a tensor over every iteration; the control's, put in the program's
    place, a dict over the followed ones)."""
    return float(cap.out["losses"][it])


def map_delta(cap, key):
    """A mapping capture's step of leaf group `grp` at iteration it (key
    (it, grp)): the difference of the two captured states around it, or
    the control's step as given."""
    if "deltas" in cap.out:
        return cap.out["deltas"][key]
    it, grp = key
    states = cap.extra["states"]
    return (follow.group_tensor(states[it + 1]["tree"], grp)
            - follow.group_tensor(states[it]["tree"], grp))


def step_shares(delta, ref_step) -> tuple:
    """(mass share, entry share) of a step's entries that depart from the
    reference's step by more than half a nominal step."""
    r = ref_step["delta"]
    d = delta.to(device=r.device, dtype=r.dtype)
    bad = ~(torch.abs(d - r) <= ref_step["unit"])
    w = ref_step["weight"]
    total = float(torch.sum(w))
    mass = (float(torch.sum(w * bad)) / total if total > 0
            else float(bool(torch.any(bad))))
    moving = int(torch.sum((r != 0) | (d != 0)))
    return mass, int(torch.sum(bad)) / max(moving, 1)


def _nearest(pose, cams) -> float:
    """Widest entry gap of [R | t] (3, 4) from the nearest of the cameras'
    (infinite where none is finite)."""
    gaps = [float(torch.max(torch.abs(pose - plain.cam_to_c2w(c))))
            for c in cams]
    return min((g for g in gaps if g == g), default=math.inf)


def track_numbers(cap, r, at) -> dict:
    """A tracked capture's numbers against the reference's whole loop `r`
    (follow.follow_tracking) and its steps `at` at the capture's own
    cameras (follow.follow_tracking_steps)."""
    losses = [float(x) for x in cap.out["losses"].tolist()]
    dev, dt = r["pose"].device, r["pose"].dtype
    pose = cap.out["pose"].to(device=dev, dtype=dt)[:3]
    cams = cap.out["cams"]
    ends = torch.cat([cams[1:], cap.out["last"][None]])
    shares = [step_shares(ends[k] - cams[k], st)
              for k, st in enumerate(at["steps"])]
    cams, ends = cams.to(device=dev, dtype=dt), ends.to(device=dev,
                                                        dtype=dt)
    return {
        "track_first": _rel(losses[0], r["losses"][0]),
        "track_loss": _widest(_rel(a, b) for a, b in zip(losses,
                                                         r["losses"])),
        "track_pose": float(torch.max(torch.abs(pose - r["pose"][:3]))),
        "track_near": _nearest(pose, r["posts"]),
        "track_init": float(torch.max(torch.abs(
            plain.cam_to_c2w(cams[0]) - plain.cam_to_c2w(r["cams"][0])))),
        "track_iter_loss": _widest(
            _rel(a, b) for a, b in zip(cap.out["iter_losses"].tolist(),
                                       at["losses"])),
        "track_step": _widest(m for m, _ in shares),
        "track_flip": _widest(f for _, f in shares),
        "track_kept": _nearest(pose, ends)}


TRACK_NUMBERS = ("track_first", "track_loss", "track_pose", "track_near",
                 "track_init", "track_iter_loss", "track_step",
                 "track_flip", "track_kept")


def gaps(captures, ref: dict, steps: dict) -> dict:
    """Every number, from the captures' outputs (the program's, or a side's
    put in their place) against the reference's `ref` (follow_all of the
    program's captures) and its steps at the captures' own cameras
    (`steps`, follow_steps of the same captures)."""
    res = dict.fromkeys(TRACK_NUMBERS + ("map_loss", "map_step",
                                         "map_flip"), 0.0)
    for key, cap in captures.items():
        if key not in ref:
            continue
        r = ref[key]
        if key[0] == "track":
            for k, v in track_numbers(cap, r, steps[key]).items():
                res[k] = _worse(res[k], v)
            continue
        if r is None:
            for k in ("map_loss", "map_step", "map_flip"):
                res[k] = float("inf")
            continue
        for it, v in r["losses"].items():
            res["map_loss"] = _worse(res["map_loss"],
                                     _rel(map_loss_at(cap, it), v))
        for k, st in r["steps"].items():
            mass, flip = step_shares(map_delta(cap, k), st)
            res["map_step"] = _worse(res["map_step"], mass)
            res["map_flip"] = _worse(res["map_flip"], flip)
    return res


def as_outputs(ref: dict) -> dict:
    """A reference run's outputs in the form of the program's captures
    (the control put in the program's place)."""
    out = {}
    for key, r in ref.items():
        if key[0] == "track":
            out[key] = {"losses": torch.tensor(r["losses"]),
                        "pose": r["pose"].detach().cpu(),
                        "cams": r["cams"].detach().cpu(),
                        "iter_losses": torch.tensor(r["all_losses"]),
                        "last": r["last"].detach().cpu()}
        elif r is not None:
            out[key] = {"losses": dict(r["losses"]),
                        "deltas": {k: s["delta"]
                                   for k, s in r["steps"].items()}}
    return out


def mapping_detail(sides: dict, ref: dict) -> list:
    """One line a followed step and leaf group of each mapping capture:
    (mass share, entry share) of each side's step (the program's, the
    control's, ...: {name: captures}) against the reference `ref`; then
    each side's widest loss gap."""
    lines = []
    for key in sorted(k for k in ref if k[0] == "map"):
        if ref[key] is None:
            continue
        r = ref[key]
        caps = {name: c[key] for name, c in sides.items() if key in c}
        for k in sorted(r["steps"]):
            shares = [f"{name} {step_shares(map_delta(c, k), r['steps'][k])!r}"
                      for name, c in caps.items()]
            lines.append(f"event {key[1]} iteration {k[0]} {k[1]}: "
                         + ", ".join(shares))
        loss = [f"{name} " + repr(max(_rel(map_loss_at(c, it), v)
                                      for it, v in r["losses"].items()))
                for name, c in caps.items()]
        lines.append(f"event {key[1]} BA {r['ba']}; loss gaps "
                     + ", ".join(loss))
    return lines


def tracking_detail(captures, refs: dict) -> list:
    """One line a sampled frame: the program's [first, last, best] loss
    and each reference's, the kept pose's gap to each reference's kept
    pose and to the nearest of its post-step poses (with that step)."""
    lines = []
    for key, cap in sorted(captures.items()):
        if key[0] != "track":
            continue
        prog = [float(x) for x in cap.out["losses"].tolist()]
        pose = cap.out["pose"][:3]
        parts = [f"frame {key[1]}: program losses {prog}"]
        for name, ref in refs.items():
            r = ref[key]
            dev = r["pose"].device
            p = pose.to(device=dev, dtype=r["pose"].dtype)
            near = [float(torch.max(torch.abs(
                p - plain.cam_to_c2w(c)))) for c in r["posts"]]
            k = min(range(len(near)), key=near.__getitem__)
            kept = min(range(len(r["all_losses"])),
                       key=r["all_losses"].__getitem__)
            parts.append(
                f"{name} losses {r['losses']} kept step {kept}, pose gap "
                f"{float(torch.max(torch.abs(p - r['pose'][:3])))!r}, "
                f"nearest step {k} at {near[k]!r}")
        lines.append("; ".join(parts))
    return lines


def steps_detail(sides: dict, ref: dict, steps: dict) -> list:
    """One line a sampled frame: each side's ({name: captures}) numbers
    of the step-by-step follow (`steps`: {name: follow_steps of that
    side}) and its widest step departure, in half nominal steps, with
    its iteration."""
    lines = []
    for key in sorted(k for k in ref if k[0] == "track"):
        parts = []
        for name, caps in sides.items():
            if key not in caps:
                continue
            cap, at = caps[key], steps[name][key]
            v = track_numbers(cap, ref[key], at)
            cams = cap.out["cams"]
            ends = torch.cat([cams[1:], cap.out["last"][None]])
            gone = [float(torch.max(torch.abs(
                (ends[k] - cams[k]).to(st["delta"]) - st["delta"])
                / st["unit"])) for k, st in enumerate(at["steps"])]
            worst = max(range(len(gone)), key=gone.__getitem__)
            parts.append(f"{name} " + repr({k: v[k] for k in (
                "track_init", "track_iter_loss", "track_step",
                "track_flip", "track_kept")})
                + f" widest departure {gone[worst]!r} half-steps at step "
                f"{worst}")
        lines.append(f"frame {key[1]} steps: " + "; ".join(parts))
    return lines


# the tracking faults the readings plant in the reference put in the
# program's place (follow.follow_tracking's arguments)
TRACK_FAULTS = (
    ("lr_half", "fault: tracking's learning rate halved",
     {"lr_scale": 0.5}),
    ("entry_zero", "fault: the gradient of the camera's x translation "
     "zeroed", {"frozen_entry": 4}),
    ("kept_moved", "fault: the kept pose moved 1e-3 along x",
     {"kept_shift": 1e-3}))


def judge(cfg, captures, stream, dev, start: float, readings: bool,
          follower=follow) -> SimpleNamespace:
    """Every number of the program's captures against the reference that
    `follower` runs, with `start` (the mode's start gap) and `sampled`
    (infinite where the window reached no sampled frame or no sampled
    event): `vals`; the line naming the samples: `head`.  With
    `readings`, the control (the reference in TF32, put in the program's
    place), the reference in float64 and the reference with each of
    TRACK_FAULTS go through the same comparison: `sides`, [(name, their
    numbers)]; and the lines that set each side's steps and losses beside
    the program's: `detail`.  The cell's limits are the caller's."""
    ref = follow_all(cfg, captures, stream, dev, follower=follower)
    steps = follow_steps(cfg, captures, stream, dev, follower=follower)
    vals = gaps(captures, ref, steps)
    vals["start"] = start
    n_track = sum(1 for k in captures if k[0] == "track")
    n_map = sum(1 for k in captures if k[0] == "map")
    if n_track == 0 or n_map == 0:
        vals["sampled"] = math.inf
    head = [f"check: tracked frames "
            f"{sorted(k[1] for k in captures if k[0] == 'track')}, "
            f"mapping event {[k[1] for k in captures if k[0] == 'map']}"]
    sides, detail = [], []
    if readings:
        tracked = {k: c for k, c in captures.items() if k[0] == "track"}
        by_side, at = {"program": captures}, {"program": steps}
        raws = {"fp32": ref}
        for short, name, caps, kw in (
                ("tf32", "control (the reference in TF32)", captures,
                 {"tf32": True}),
                ("fp64", "the reference in float64", captures,
                 {"dtype": torch.float64})) + tuple(
                (short, name, tracked, kw) for short, name, kw
                in TRACK_FAULTS):
            raws[short] = follow_all(cfg, caps, stream, dev,
                                     follower=follower, **kw)
            outs = as_outputs(raws[short])
            by_side[short] = {k: dataclasses.replace(c, out=outs[k])
                              for k, c in caps.items() if k in outs}
            at[short] = follow_steps(cfg, by_side[short], stream, dev,
                                     follower=follower)
            sides.append((name, dict(gaps(by_side[short], ref, at[short]),
                                     start=0.0)))
        detail += mapping_detail(by_side, ref)
        detail += tracking_detail(captures, {
            k: raws[k] for k in ("fp32", "tf32", "fp64")})
        detail += steps_detail(by_side, ref, at)
    return SimpleNamespace(vals=vals, head=head, sides=sides, detail=detail)
