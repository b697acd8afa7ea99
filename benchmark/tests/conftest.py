"""Shared pieces of the benchmark's CPU tests: a small copy of a
configuration and one run of a cell on the CPU through the harness (the
program's plain PyTorch path), with the look for a card skipped."""

from __future__ import annotations

import copy
import time

import pytest
import torch

from benchmark import registry, run


def small_conf(name: str = "replica_room0") -> dict:
    """The configuration at 48 x 64 with few pixels and iterations: every
    other key as published."""
    conf = copy.deepcopy(registry.config(name))
    c = conf["cfg"]
    c["cam"].update(H=48, W=64, fx=32.0, fy=32.0, cx=31.5, cy=23.5)
    c["tracking"].update(iters=3, pixels=60, ignore_edge_W=4,
                         ignore_edge_H=4)
    c["mapping"].update(iters=6, iters_first=12, pixels=100)
    return conf


def small_run(cell: str = "room0.strict", seed: int = 3000000001,
              readings: int = 0, trace: int = 0, engine_hook=None,
              seconds: float = 2.0, early: bool = True):
    """(result, check lines) of one run of `cell` at the small size on the
    CPU, its window long enough to reach the check's samples; `early`
    moves the window to frame 6 (before bundle adjustment starts), which
    shortens the set-up."""
    wl = copy.deepcopy(registry.workload(cell))
    if early:
        wl.update(warm_frames=6 if "strict" in cell else 11)
    wl["check"]["track_span"] = 4
    wl["check"]["map_offsets"] = [4]
    args = run.parse(["--workload", cell, "--seed", str(seed),
                      "--seconds", str(seconds), "--trace", str(trace),
                      "--readings", str(readings)])
    return run.run_cell(args, wl, torch.device("cpu"), time.perf_counter(),
                        engine_hook=engine_hook,
                        conf=small_conf(wl["config"]))


@pytest.fixture(scope="session")
def sound_run():
    """The cell as committed: its window after bundle adjustment has
    started."""
    return small_run(early=False)
