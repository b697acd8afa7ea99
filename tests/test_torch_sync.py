"""The port's strict / loose / free schedules against the JAX engine's.

Tracking and mapping are stubbed by recorders on both engines, so only
the schedule runs: which frames each tracking call covers, which frame
each mapping event maps, which frame's images it receives (told apart by
their GT pose) and frames_done when it fires.  The port has one loop, the
per-frame loop, whatever tpu.grouped_tracking says; it must produce
exactly the JAX engine's per-frame records, from frame 0 and after
resuming at frame 6 (a group start) or frame 7 (mid-group), and from
frame 0 map the same frames as the JAX grouped loop (fuse_track_map off,
the three-dispatch reference path).  Then one real loose run of the port
on the CPU (13 frames, ATE < 0.35 m, the JAX package's bound for a lagged
run) and a gt_camera run (est == GT)."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nice_slam_tpu.config import load_config as jax_load_config  # noqa: E402
from nice_slam_tpu.engine import SlamEngine as JaxSlamEngine  # noqa: E402
from test_slam import TEST_CFG  # noqa: E402

from nice_slam_torch.config import load_config  # noqa: E402
from nice_slam_torch.engine import SlamEngine  # noqa: E402


def _cfg(loader, sync, every, grouped, n_frames=13):
    return loader(overrides={
        **TEST_CFG, "sync_method": sync,
        "synthetic": {"n_frames": n_frames},
        "mapping": {**TEST_CFG["mapping"], "every_frame": every},
        "tpu": {"seed": 0, "grouped_tracking": grouped,
                "fuse_track_map": False},
        "tracking": {**TEST_CFG["tracking"], "iters": 2, "pixels": 60}})


def _recorder(eng, poses, events):
    """Stub eng's tracking and mapping with recorders of the schedule."""
    def frame_of(gt_pose):
        return int(np.argmin(np.abs(poses - np.asarray(gt_pose)).sum((1, 2))))

    def track(idx, *a, **k):
        if idx > 0 and not eng.gt_camera:
            events.append(("track", idx, idx))

    def track_group(cur, g_end, *a, **k):
        events.append(("track", cur, g_end))
        return np.float32(0.0)

    def mapping_event(idx, color, depth, gt_pose, *a, **k):
        events.append(("map", idx, frame_of(gt_pose), eng.frames_done))

    eng.track = track
    if isinstance(eng, JaxSlamEngine):
        eng._track_group = track_group
    eng.mapping_event = mapping_event


def _schedules(eng, poses, starts):
    events = []
    _recorder(eng, poses, events)
    out = {}
    for start in starts:
        events.clear()
        eng.frames_done = start
        eng._frame_cache = {}
        eng.run()
        out[start] = list(events)
    return out


@pytest.fixture(scope="module")
def poses():
    ds = SlamEngine(_cfg(load_config, "strict", 5, True), output="unused",
                    device="cpu").dataset
    return np.stack([np.asarray(ds[i][3]) for i in range(len(ds))])


STARTS = (0, 6, 7)


@pytest.mark.parametrize("every", [5, 4])
@pytest.mark.parametrize("sync", ["strict", "loose", "free"])
def test_schedules_equal_jax(poses, sync, every, tmp_path):
    got = {}
    for grouped in (True, False):
        for pkg, loader, engine, kw in (
                ("jax", jax_load_config, JaxSlamEngine, {}),
                ("torch", load_config, SlamEngine, {"device": "cpu"})):
            eng = engine(_cfg(loader, sync, every, grouped),
                         output=str(tmp_path / pkg), **kw)
            got[pkg, grouped] = _schedules(eng, poses, STARTS)
    # the port ignores the knob and runs the JAX per-frame loop
    for grouped in (True, False):
        assert got["torch", grouped] == got["jax", False], (sync, every,
                                                            grouped)
    maps = {k: [e[1:3] for e in v[0] if e[0] == "map"]
            for k, v in got.items()}
    assert len({tuple(v) for v in maps.values()}) == 1, maps


def _port_events(sync, grouped, every=5):
    eng = SlamEngine(_cfg(load_config, sync, every, grouped),
                     output="unused", device="cpu")
    ds = eng.dataset
    poses = np.stack([np.asarray(ds[i][3]) for i in range(len(ds))])
    return _schedules(eng, poses, (0,))[0]


def _per_frame(seq):
    """A sequence of ("track", first, last) and ("map", idx) records with
    every tracking call split into one record per frame."""
    return [r for e in seq for r in (
        [("track", i, i) for i in range(e[1], e[2] + 1)]
        if e[0] == "track" else [e])]


def test_loose_event_fires_mid_group():
    """tests/test_slam.py:479-482 (JAX's grouped loop), frame by frame:
    every 5, lag 2: the event of frame 5 fires after tracking frame 7."""
    ev = [e[:2] if e[0] == "map" else e for e in _port_events("loose", True)]
    assert ev == _per_frame([("map", 0), ("track", 1, 5), ("track", 6, 7),
                             ("map", 5), ("track", 8, 10), ("track", 11, 12),
                             ("map", 12)]), ev


def test_free_event_fires_at_group_end():
    """tests/test_slam.py:484-489 (JAX's grouped loop), frame by frame:
    every 5, lag 5: frame 5's event after tracking frame 10; the final
    event wins over frame 10's."""
    ev = [e[:2] if e[0] == "map" else e for e in _port_events("free", True)]
    assert ev == _per_frame([("map", 0), ("track", 1, 5), ("track", 6, 10),
                             ("map", 5), ("track", 11, 12), ("map", 12)]), ev


def test_three_modes_three_interleavings():
    """tests/test_slam.py:414-431 on the per-frame loop with TEST_CFG's
    every_frame 4: (tracker frames done, mapped frame) pairs (4, 4) strict,
    (6, 4) loose, (8, 4) free."""
    pairs = {sync: [(e[3], e[1]) for e in _port_events(sync, False, 4)
                    if e[0] == "map"]
             for sync in ("strict", "loose", "free")}
    assert (4, 4) in pairs["strict"]
    assert (6, 4) in pairs["loose"]
    assert (8, 4) in pairs["free"]
    assert len({tuple(p) for p in pairs.values()}) == 3, pairs


def test_gt_camera_sets_gt_poses(tmp_path):
    """tracking.gt_camera: the per-frame loop, poses set to GT and never
    optimised (tests/test_slam.py:221-232)."""
    cfg = load_config(overrides={**TEST_CFG,
                                 "synthetic": {"n_frames": 5},
                                 "tracking": {**TEST_CFG["tracking"],
                                              "gt_camera": True},
                                 "mapping": {**TEST_CFG["mapping"],
                                             "iters_first": 40,
                                             "iters": 10}})
    eng = SlamEngine(cfg, output=str(tmp_path), device="cpu")
    eng.run()
    assert eng.frames_done == 5
    np.testing.assert_allclose(eng.est_c2w[:5], eng.gt_c2w[:5])


def test_loose_run_converges(tmp_path):
    """A real loose run of the port on the CPU, as
    tests/test_slam.py:491-502 runs the JAX engine: 13 frames, ATE finite
    and < 0.35 m; the final event writes its checkpoint."""
    cfg = load_config(overrides={**TEST_CFG, "sync_method": "loose",
                                 "synthetic": {"n_frames": 13}})
    eng = SlamEngine(cfg, output=str(tmp_path), device="cpu")
    eng.run()
    assert eng.frames_done == 13
    assert eng.map_lag == 2
    rmse = eng.ate()["rmse"]
    assert np.isfinite(rmse) and rmse < 0.35, rmse
    assert os.path.exists(tmp_path / "ckpts" / "00012.npz")


def test_smoke_schedule_matches_engine(poses):
    """chip_smoke.py's map_events, from which it counts the kernel
    launches of its loose, free and resume phases, equals the frames the
    port maps: loose over 11 frames, free over 12, loose resumed at frame
    6 (every_frame 5)."""
    import runpy

    cs = runpy.run_path(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py"), run_name="not_main")
    for sync, n_frames, start, want in (("loose", 11, 0, [0, 5, 10]),
                                        ("free", 12, 0, [0, 5, 11]),
                                        ("loose", 11, 6, [5, 10])):
        eng = SlamEngine(_cfg(load_config, sync, 5, True, n_frames),
                         output="unused", device="cpu")
        ev = _schedules(eng, poses, (start,))[start]
        got = [e[1] for e in ev if e[0] == "map"]
        assert got == cs["map_events"](n_frames, 5, eng.map_lag, start) \
            == want, (sync, start, got)
