"""The readings of the program's own spans (benchmark/program.py:
load_frame_ms, map_prepare_ms, coarse_ms, host_idle_ms, the sub-window's
idle by span and the clock check) on synthetic span lists: each gives
the value its definition says, and None where the program records no
spans (an engine without a recording tracer, as before the tracer
existed); and a traced run of the cell on the CPU at the small size
reads the program's spans."""

import copy
import time
from types import SimpleNamespace

import pytest
import torch

from benchmark import harness, program, registry, run
from nice_slam_torch.utils import profiling

MS = 1_000_000   # ns


def _span(index, name, id, t0, t1, parent=None, d=None, thread=1,
          anchor=0):
    d0, d1 = d if d is not None else (None, None)
    return {"index": index, "name": name, "id": id, "parent": parent,
            "thread": thread, "t0": t0 * MS, "t1": t1 * MS,
            "d0": None if d0 is None else d0 * MS,
            "d1": None if d1 is None else d1 * MS,
            "anchor": None if d is None else anchor * MS, "counts": {}}


def _program(sub=None):
    """Frames 10 and 11 of a window, an event at frame 10 (and frame 5's,
    out of the window)."""
    spans = [
        _span(0, "frame", 10, 0, 100),
        _span(1, "frame.load", 10, 0, 8, 0),
        _span(2, "frame.read", 10, 0, 6, 1),
        _span(3, "track", 10, 8, 30, 0, (9, 31)),
        _span(4, "track.iters", 10, 10, 28, 3, (11, 29)),
        _span(5, "map.event", 10, 30, 100, 0, (31, 101)),
        _span(6, "map.prepare", 10, 30, 36, 5, (31, 38)),
        _span(7, "map.middle", 10, 36, 60, 5, (38, 62)),
        _span(8, "map.coarse", 10, 60, 90, 5, (62, 92)),
        _span(9, "map.prepare", 10, 60, 64, 8, (62, 65)),
        _span(10, "frame", 11, 100, 120),
        _span(11, "frame.load", 11, 100, 104, 10),
        _span(12, "map.prepare", 5, 0, 50, None, (0, 50)),
        _span(13, "frame.load", 5, 0, 50, None),
    ]
    return {"spans": spans, "frames": [10, 11], "events": [10],
            "dropped": 0, "sub": sub}


def _read(name, prog):
    return program.READINGS[name](prog)


def test_readers_read_the_window_spans():
    p = _program()
    assert _read("load_frame_ms", p) == pytest.approx((8 + 4) / 2)
    # the mapper's selection and the coarse mapper's, device spans
    assert _read("map_prepare_ms", p) == pytest.approx(7 + 3)
    assert _read("coarse_ms", p) == pytest.approx(30)
    # no profiled sub-window
    assert _read("host_idle_ms", p) is None


def test_device_ms_falls_back_to_the_host_span():
    assert program.device_ms(_span(0, "x", 0, 1, 4)) == pytest.approx(3)
    assert program.device_ms(_span(0, "x", 0, 1, 4, d=(2, 7))) == \
        pytest.approx(5)


def test_every_reader_is_none_without_program_spans():
    for name in ("load_frame_ms", "map_prepare_ms", "coarse_ms",
                 "host_idle_ms"):
        assert _read(name, None) is None
    # an engine whose timer cannot record is not asked to
    old = SimpleNamespace(timer=SimpleNamespace(totals={}))
    assert not program.attach(old, True)
    assert not program.attach(SimpleNamespace(), True)


def test_recording_only_under_trace():
    started = []
    eng = SimpleNamespace(timer=SimpleNamespace(
        start_recording=lambda n: started.append(n)))
    assert not program.attach(eng, False) and started == []
    assert program.attach(eng, True) and started == [profiling.CAPACITY]


def test_idle_goes_to_the_innermost_span():
    p = _program()
    # device busy 0-9, 12-20, 33-37, 40-95, 99-100 (ms); idle 9-12
    # (track to 10, then track.iters), 20-33 (track.iters to 28, track to
    # 30, then map.prepare), 37-40 (map.middle), 95-99 (map.event)
    dev = [("k", a * 1e3, b * 1e3) for a, b in
           ((0, 9), (12, 20), (33, 37), (40, 95), (99, 100))]
    idle = program.idle_by_span(p["spans"], dev)
    assert idle == pytest.approx({
        "track": 1 + 2, "track.iters": 2 + 8, "map.prepare": 3,
        "map.middle": 3, "map.event": 4})
    p["sub"] = {"idle_ms": idle, "frames": 2,
                "clock_ms": {"start": [], "end": [], "launch": [],
                             "anchor": []}}
    # all but the replay loops' idle, a frame
    assert _read("host_idle_ms", p) == pytest.approx((3 + 3 + 4) / 2)
    lines = program.table(p)
    assert any("inside a named span below `frame`: 100.00%" in x
               for x in lines)


def test_idle_outside_every_span_and_in_frame():
    spans = [_span(0, "frame", 1, 0, 10), _span(1, "track", 1, 2, 5, 0)]
    dev = [("k", a * 1e3, b * 1e3) for a, b in ((0, 1), (3, 4), (12, 13))]
    idle = program.idle_by_span(spans, dev)
    # idle 1-3 (frame, then track) and 4-12 (track, frame, outside)
    assert idle == pytest.approx({"frame": 1 + 5, "track": 1 + 1,
                                  program.OUTSIDE: 2})
    sub = {"idle_ms": idle, "frames": 1,
           "clock_ms": {"start": [0.01, 0.05], "end": [0.002, 0.003],
                        "launch": [None, 0.04], "anchor": [1.0, 2.0]}}
    ctx = SimpleNamespace(program={"spans": spans, "frames": [1],
                                   "events": [], "dropped": 0, "sub": sub})
    assert _read("host_idle_ms", ctx.program) == pytest.approx(8)
    lines = program.table(ctx.program)
    assert any("below `frame`: 20.00%" in x for x in lines)
    assert "0.0100 to 0.0500 ms" in lines[-1]
    assert "0.0020 to 0.0030 ms" in lines[-1]
    # the latest start: its host's first launch, its anchor, its end
    assert lines[-1].endswith("first graph launch comes 0.0400 ms after the "
                              "span opens on the host, its anchor 2.0000 ms "
                              "before, its end 0.0030 ms")


def test_clock_check_reads_the_records_at_each_loops_ends():
    spans = [_span(0, "track.iters", 1, 0, 5, d=(10, 15)),
             _span(1, "track.iters", 2, 20, 25, d=(30, 35), anchor=19),
             _span(2, "track.iters", 3, 0, 5, d=(500, 505)),
             _span(3, "track.iters", 4, 0, 5)]
    dev = [("k", a * 1e3, b * 1e3) for a, b in
           ((0, 9), (10.05, 12), (12.5, 14.9), (29, 31), (32, 34.99),
            (36, 40))]
    # the record running at a span's start counts, from its start; spans
    # outside the sub-window or without a device span are left out
    # the host's graph launches (us), and another call between
    cpu = [("cudaGraphLaunch", 300, 310), ("cudaMemcpyAsync", 21e3, 21.1e3),
           ("cudaGraphLaunch", 22e3, 22.01e3)]
    got = program.clock_ms(spans, dev, cpu)
    assert got["start"] == pytest.approx([0.05, -1.0])
    assert got["end"] == pytest.approx([0.1, 0.01])
    assert got["launch"] == pytest.approx([0.3, 2.0])
    assert got["anchor"] == pytest.approx([0.0, 1.0])
    # without the host's records, no launch
    assert program.clock_ms(spans, dev)["launch"] == [None, None]


def test_a_traced_run_reads_the_program():
    """The cell at the small size on the CPU, its window at frame 6: the
    readings of the window's frames and events (the CPU has no device
    records, so no sub-window)."""
    from benchmark.tests.conftest import small_conf

    wl = copy.deepcopy(registry.workload("room0.strict"))
    wl.update(warm_frames=6)
    wl["check"].update(track_span=4, map_offsets=[4])
    args = run.parse(["--workload", "room0.strict", "--seed", "3000000001",
                      "--seconds", "1", "--trace", "1"])
    got = {}

    def hook(eng):
        # the stream ends the run from inside the frame's read once the
        # window is done: read the spans there, as run.py's traced run
        # would hand them on
        got["on"] = program.attach(eng, True)
        load = eng._load_frame

        def load_frame(idx):
            try:
                return load(idx)
            except harness.StopWindow:
                d = eng.dataset.driver
                got["fps"] = (d.end_idx - d.warm) / (d.t_we - d.t_ws)
                got["program"] = program.collect(eng, d)
                raise

        eng._load_frame = load_frame

    res, _ = run.run_cell(args, wl, torch.device("cpu"), time.perf_counter(),
                          engine_hook=hook, conf=small_conf())
    prog, fps = got["program"], got["fps"]
    assert got["on"]
    assert res["correct"] and fps > 0
    assert prog["frames"] == list(range(6, 6 + len(prog["frames"])))
    assert prog["events"] and all(e % 5 == 0 for e in prog["events"])
    assert prog["dropped"] == 0 and prog["sub"] is None
    for name in ("load_frame_ms", "map_prepare_ms", "coarse_ms"):
        assert _read(name, prog) > 0, name
    assert _read("host_idle_ms", prog) is None
