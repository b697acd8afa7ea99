"""A configuration's mode picks its check and its cost: NICE through
benchmark/modes/nice.py gives the numbers, the lines and the least time
that run.py computed before the modes (frozen below as `before_judge`
and `before_schedule_least_ms`), on the same captures of both published
configurations; an unknown mode stops with the missing file's name; and
costs/imap.py counts one point by hand."""

import dataclasses
import json
import math
import os
import shutil

import pytest
import torch

from benchmark import registry, run
from benchmark.costs import decode as cd
from benchmark.costs import imap as ci
from benchmark.reference import check
from benchmark.tests.conftest import small_run

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BEFORE_TRACK_FAULTS = (
    ("lr_half", "fault: tracking's learning rate halved",
     {"lr_scale": 0.5}),
    ("entry_zero", "fault: the gradient of the camera's x translation "
     "zeroed", {"frozen_entry": 4}),
    ("kept_moved", "fault: the kept pose moved 1e-3 along x",
     {"kept_shift": 1e-3}))


def before_judge(cfg, wl, captures, stream, dev, start_params, readings):
    """run.judge as it was before the modes, word for word."""
    ref = check.follow_all(cfg, captures, stream, dev)
    steps = check.follow_steps(cfg, captures, stream, dev)
    vals = check.gaps(captures, ref, steps)
    vals["start"] = check.start_gap(start_params,
                                    cfg["pretrained_decoders"]["tpu_npz"])
    n_track = sum(1 for k in captures if k[0] == "track")
    n_map = sum(1 for k in captures if k[0] == "map")
    if n_track == 0 or n_map == 0:
        vals["sampled"] = math.inf
    limits = wl["limits"]
    numbers = run.compared(vals, limits)
    lines = [f"check: tracked frames "
             f"{sorted(k[1] for k in captures if k[0] == 'track')}, "
             f"mapping event {[k[1] for k in captures if k[0] == 'map']}",
             "readings not compared: " + json.dumps(
                 {k: v for k, v in vals.items() if k not in numbers})]
    if readings:
        tracked = {k: c for k, c in captures.items() if k[0] == "track"}
        sides, at = {"program": captures}, {"program": steps}
        raws = {"fp32": ref}
        for short, name, caps, kw in (
                ("tf32", "control (the reference in TF32)", captures,
                 {"tf32": True}),
                ("fp64", "the reference in float64", captures,
                 {"dtype": torch.float64})) + tuple(
                (short, name, tracked, kw) for short, name, kw
                in BEFORE_TRACK_FAULTS):
            raws[short] = check.follow_all(cfg, caps, stream, dev, **kw)
            outs = check.as_outputs(raws[short])
            sides[short] = {k: dataclasses.replace(c, out=outs[k])
                            for k, c in caps.items() if k in outs}
            at[short] = check.follow_steps(cfg, sides[short], stream, dev)
            v = dict(check.gaps(sides[short], ref, at[short]), start=0.0)
            lines.append(f"{name}: correct "
                         f"{run.is_correct(run.compared(v, limits))}; "
                         + json.dumps(v))
        lines += check.mapping_detail(sides, ref)
        lines += check.tracking_detail(captures, {
            k: raws[k] for k in ("fp32", "tf32", "fp64")})
        lines += check.steps_detail(sides, ref, at)
    lines += [f"check {k}: {v['value']!r} limit {v['limit']!r}"
              for k, v in numbers.items()]
    return numbers, lines


def before_schedule_least_ms(cfg, n_frames, n_events):
    """run.schedule_least_ms as it was before the modes, word for word."""
    t, m, r = cfg["tracking"], cfg["mapping"], cfg["rendering"]
    per_ray = r["N_samples"] + r["N_surface"]
    n_t = t["pixels"] * per_ray
    frame = t["iters"] * (
        cd.step_ops_ms(*cd.step_flops("color", n_t, "fwd"))
        + cd.step_ops_ms(*cd.step_flops("color", n_t, "bwd",
                                        need_dp=True)))
    if t["const_speed_assumption"] and t["init_select"]:
        frame += 2 * cd.step_ops_ms(*cd.step_flops("color", n_t, "fwd"))
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
        ev += iters * (cd.step_ops_ms(*cd.step_flops(stage, n_m, "fwd"))
                       + cd.step_ops_ms(*cd.step_flops(stage, n_m, "bwd",
                                                       live)))
    if cfg.get("coarse"):
        ev += n * (cd.step_ops_ms(*cd.step_flops("coarse", n_c, "fwd"))
                   + cd.step_ops_ms(*cd.step_flops("coarse", n_c, "bwd")))
    return n_frames * frame + n_events * ev


@pytest.mark.parametrize("cell", ["room0.strict", "scene0000.strict"])
def test_nice_mode_gives_the_numbers_and_lines_of_before(cell, monkeypatch):
    """One run with --readings 1: the judge through the NICE mode and the
    frozen judge, on the same captures, give equal numbers and lines."""
    seen = {}
    orig = run.judge

    def keep(*a):
        seen["args"] = a
        return orig(*a)

    monkeypatch.setattr(run, "judge", keep)
    res, lines = small_run(cell, seed=2**32 + 7, readings=1)
    assert registry.mode_of(seen["args"][0]) == "nice"
    numbers, before = before_judge(*seen["args"])
    assert res["check"] == numbers
    assert lines == before


@pytest.mark.parametrize("name", ["replica_room0", "scannet_scene0000"])
def test_nice_mode_costs_the_schedule_as_before(name):
    cfg = registry.config(name)["cfg"]
    nice = registry.mode("nice")
    for n_frames, n_events in ((0, 1), (1, 0), (5, 1), (203, 40)):
        assert nice.schedule_least_ms(cfg, n_frames, n_events) == \
            before_schedule_least_ms(cfg, n_frames, n_events)


def test_an_unknown_mode_names_the_missing_file():
    assert registry.names("modes") == ["imap", "nice"]
    with pytest.raises(FileNotFoundError, match=r"modes/gaussian\.py"):
        registry.mode("gaussian")


def test_a_mode_metric_reaches_every_cell_of_its_mode(tmp_path):
    """K1's and K2's rooflines choose cells by mode: a NICE cell dropped
    in as data gets them, and its BENCHMARK.json entry, with no edit to a
    metric file; an iMAP* cell gets neither, and the whole-step share
    reads both."""
    root = tmp_path / "benchmark"
    shutil.copytree(BENCH, root, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    (root / "configs" / "scannet_scene0000_imap.json").write_text(
        json.dumps({"base": "scannet_scene0000", "set": {"nice": False}}))
    for cell, base, config in (
            ("room0.extra", "room0.strict", "replica_room0"),
            ("scene0000.imap", "scene0000.strict",
             "scannet_scene0000_imap")):
        (root / "workloads" / f"{cell}.json").write_text(json.dumps(
            dict(registry.workload(base), config=config, why="a new cell")))
    bench = registry.benchmark_json()
    bench["workloads"] += [
        {"name": "room0.extra", "config": "replica_room0"},
        {"name": "scene0000.imap", "config": "scannet_scene0000_imap"}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    assert registry.cell_mode("scene0000.imap", str(root)) == "imap"
    nice = registry.metrics_for("room0.extra", str(root))
    imap = registry.metrics_for("scene0000.imap", str(root))
    assert {"k1_roofline", "k2_roofline", "step_mfu"} <= set(nice)
    assert "step_mfu" in imap and not {"k1_roofline", "k2_roofline"} & \
        set(imap)
    assert set(registry.metrics_for("scene0000.imap", str(root),
                                    mode="nice")) == set(nice)
    for name in ("k1_roofline", "k2_roofline"):
        entry = registry.per_layer_entry(registry.metric(name, str(root)),
                                         str(tmp_path))
        assert entry["workloads"] == ["room0.strict", "scene0000.strict",
                                      "room0.extra"]


def test_imap_costs_one_point_by_hand():
    """At one point, by hand: forward 3x93 + 256x4 fp32 MACs and
    93x256 + 3x256x256 hidden ones; the tracking backward takes the
    points' gradient, the mapping backward every weight's."""
    hidden = 93 * 256 + 3 * 256 * 256
    assert hidden == 220416
    assert ci.point_macs("fwd") == (hidden, 279 + 1024)
    assert ci.point_macs("bwd", need_dp=True) == (hidden, 1024 + 279)
    assert ci.point_macs("bwd", train=True) == (2 * hidden,
                                                1024 + 1024 + 279)
    ms = ci.pass_ms(1000, "fwd")
    assert ms == (2 * hidden * 1000 / (cd.PEAK_TF32_FLOPS / 3)
                  + 2 * 1303 * 1000 / cd.PEAK_FP32_FLOPS) * 1e3
    # ScanNet's budget in iMAP* mode: 1000 px x 50 tracking iterations at
    # 32 + 12 samples, mapping 5000 px, 3 x 20 iterations, regulation at 32
    cfg = {"tracking": {"iters": 50, "pixels": 1000,
                        "const_speed_assumption": True, "init_select": True},
           "mapping": {"mapping_window_size": 10, "pixels": 5000,
                       "iters": 60, "BA": False},
           "rendering": {"N_samples": 32, "N_surface": 0,
                         "N_importance": 12},
           "occupancy": False}
    fwd = ci.pass_ms(1, "fwd")
    frame = 50 * (32000 * fwd + 44000 * fwd
                  + 44000 * ci.pass_ms(1, "bwd", need_dp=True)) \
        + 2 * (32000 + 44000) * fwd
    event = 60 * ((32000 * 5 + 44000 * 5 + 32000 * 5) * fwd
                  + (44000 * 5 + 32000 * 5) * ci.pass_ms(1, "bwd",
                                                         train=True))
    assert ci.schedule_least_ms(cfg, 1, 0) == pytest.approx(frame,
                                                            rel=1e-12)
    assert ci.schedule_least_ms(cfg, 0, 1) == pytest.approx(event,
                                                            rel=1e-12)
    # the event's least time, 0.2-0.25 s at 3xTF32
    assert 200 < ci.schedule_least_ms(cfg, 0, 1) < 250
