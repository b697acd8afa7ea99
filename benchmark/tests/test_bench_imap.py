"""An iMAP* configuration is judged with no file of its own: a small
copy of ScanNet scene0000 in iMAP* mode, built here and run through
run.run_cell with a workload given here.  The port is `correct`, its
start gap is 0 and no JAX module loads; each fault planted in the
program fails the check."""

import copy
import dataclasses
import json
import os
import subprocess
import sys
import time

import pytest
import torch

from benchmark import registry, run

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# the CPU test's own limits (scene0000.strict's): an iMAP* cell's come
# from readings on the card, in its workload file
WORKLOAD = {
    "config": "scannet_scene0000_imap", "traffic": "orbit_fixed",
    "chips": 1, "warm_frames": 6, "profile_groups": 2,
    "check": {"track_frames": 2, "track_span": 4, "map_offsets": [4]},
    "limits": {"start": 0.0, "track_init": 3e-05, "track_step": 0.01,
               "track_kept": 1e-05, "map_loss": 7e-06, "map_step": 0.00016}}


def imap_conf() -> dict:
    """ScanNet scene0000 merged as `run.py <scene>.yaml --imap` merges it
    (the port's load_config with nice=False), at 48 x 64 with few pixels
    and iterations: three passes of 3 in a steady event."""
    from nice_slam_torch.config import load_config

    conf = copy.deepcopy(registry.config("scannet_scene0000"))
    cfg = load_config(os.path.join(ROOT, "configs", "ScanNet",
                                   "scene0000.yaml"), nice=False)
    cfg["data"].update(input_folder=None, output=None)
    cfg["tpu"] = conf["cfg"]["tpu"]
    cfg["cam"].update(H=48, W=64, fx=32.0, fy=32.0, cx=31.5, cy=23.5,
                      crop_edge=0)
    cfg["tracking"].update(iters=3, pixels=60, ignore_edge_W=4,
                           ignore_edge_H=4)
    cfg["mapping"].update(iters=9, iters_first=12, pixels=100)
    conf.update(name="scannet_scene0000_imap", cfg=cfg)
    return conf


def imap_run(seed: int, engine_hook=None):
    args = run.parse(["--workload", "scene0000.imap", "--seed", str(seed),
                      "--seconds", "2", "--trace", "0"])
    return run.run_cell(args, copy.deepcopy(WORKLOAD), torch.device("cpu"),
                        time.perf_counter(), engine_hook=engine_hook,
                        conf=imap_conf())


def test_imap_port_is_correct_from_its_seeded_start_without_jax():
    """In a fresh interpreter: the mode is iMAP*'s, the run is correct,
    `start` is 0 (the reference's own draw of the decoder), the check
    follows a mapping event, and no module of JAX or the JAX package
    loads."""
    code = (
        "import sys, json; sys.path.insert(0, %r)\n"
        "from benchmark.tests.test_bench_imap import imap_run\n"
        "from benchmark import run\n"
        "res, lines = imap_run(3000000001)\n"
        "print(json.dumps({'res': res, 'lines': lines,\n"
        "                  'forbidden': run.forbidden_modules()}))\n"
        % ROOT)
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    res, lines = out["res"], out["lines"]
    assert out["forbidden"] == []
    assert res["correct"], lines
    assert res["check"]["start"]["value"] == 0.0
    assert "sampled" not in res["check"]
    assert any("mapping event [10]" in line for line in lines), lines


def _specs(**changes):
    """Set fields of the engine's render / mapper / track specs."""
    def plant(eng, mp):
        s = eng.specs
        kw = {part: dataclasses.replace(getattr(s, part), **fields)
              for part, fields in changes.items()}
        eng.specs = dataclasses.replace(s, **kw)
    return plant


def _regulation_dropped(eng, mp):
    """The regulation's densities count for nothing (still drawn)."""
    import nice_slam_torch.mapping as mapping

    orig = mapping.regulation_sigma
    mp.setattr(mapping, "regulation_sigma",
               lambda *a, **k: orig(*a, **k) * 0.0)


def _tracking_lr_half(eng, mp):
    import nice_slam_torch.tracking as tracking

    orig = tracking.adam_step_

    def step(cam, g, m, v, st, tables, lr, *a, **k):
        return orig(cam, g, m, v, st, tables, lr * 0.5, *a, **k)

    mp.setattr(tracking, "adam_step_", step)


def _b_frozen(eng, mp):
    """The Fourier matrix B takes no gradient and no step."""
    import nice_slam_torch.mapping as mapping

    orig = mapping._lr_tree

    def lr_tree(*a, **k):
        lr, frozen = orig(*a, **k)
        frozen = copy.copy(frozen)
        frozen["params"] = copy.deepcopy(frozen["params"])
        frozen["params"]["imap"]["embed"]["B"] = True
        return lr, frozen

    mp.setattr(mapping, "_lr_tree", lr_tree)


def _adam_kept_across_passes(eng, mp):
    """Adam's moments and step counter run on from an event's first pass
    into its second and third, where each pass should start a fresh
    Adam."""
    import nice_slam_torch.mapping as mapping
    from nice_slam_torch.ops.tree import tree_map

    orig_load, orig_event = mapping._load_map_buffers, eng.mapping_event
    fresh = [False]

    def event(*a, **k):
        fresh[0] = True
        return orig_event(*a, **k)

    def load(b, *a, **k):
        if fresh[0]:
            fresh[0] = False
            return orig_load(b, *a, **k)
        kept = tree_map(torch.clone, (b.m, b.v, b.step))
        orig_load(b, *a, **k)
        tree_map(lambda d, x: d.copy_(x), (b.m, b.v, b.step), kept)

    mp.setattr(mapping, "_load_map_buffers", load)
    eng.mapping_event = event


# each fault, and the numbers of which one at least must catch it
FAULTS = {
    "importance samples dropped": (_specs(render={"n_importance": 0}),
                                   ("map_loss",)),
    "regulation dropped": (_regulation_dropped, ("map_loss",)),
    "occupancy compositing in place of density": (
        _specs(render={"occupancy": True}), ("map_loss",)),
    "tracking's learning rate halved": (_tracking_lr_half,
                                        ("track_step",)),
    "the colour weight changed": (_specs(mapper={"w_color_loss": 0.1}),
                                  ("map_loss",)),
    "B frozen": (_b_frozen, ("map_step",)),
    "Adam kept across an event's passes": (_adam_kept_across_passes,
                                           ("map_step",)),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_imap_fault_is_not_correct(fault, monkeypatch):
    """The fault is planted once the engine is built."""
    plant, numbers = FAULTS[fault]
    res, lines = imap_run(41, engine_hook=lambda eng: plant(eng,
                                                           monkeypatch))
    assert not res["correct"], lines
    check = res["check"]
    assert any(check[n]["value"] > check[n]["limit"] for n in numbers), \
        lines
