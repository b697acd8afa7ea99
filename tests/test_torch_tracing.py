"""The port's tracer (nice_slam_torch/utils/profiling.StageTimer) on the
CPU, at a small size: recording off leaves the stages as they were and
keeps nothing; recording on gives one span tree a frame (`frame` >
`frame.load`, `track`, `map.event`, ...) and one a pipelined mapping
event on the mapper's thread, every child inside its parent with its id;
the runner's counters and the graph captures show in the spans; a span's
host clock is torch.profiler's; the spans join torch_trace's Chrome
trace; and a run that records equals one that does not, bit for bit.
The tests marked `cuda` check, on a card, that recording adds no
synchronisation and that the device spans sit where the profiler puts
the kernels."""

import json
import threading
import time

import pytest

torch = pytest.importorskip("torch")

from test_torch_graphs import _cfg, DoubleGraphs  # noqa: E402

from nice_slam_torch.config import load_config  # noqa: E402
from nice_slam_torch.engine import SlamEngine  # noqa: E402
from nice_slam_torch.ops.tree import tree_leaves  # noqa: E402
from nice_slam_torch.parallel.pipelined import PipelinedSlamEngine  # noqa: E402,E501
from nice_slam_torch.utils.profiling import StageTimer, torch_trace  # noqa: E402,E501

N_FRAMES = 7        # events at frames 0, 3 and 6 (every_frame 3)
EVENTS = [0, 3, 6]
REPLAY_LOOPS = {"track.iters", "map.middle", "map.fine", "map.color",
                "map.coarse.iters"}


def _engine(tmp_path, name, device="cpu"):
    cfg = _cfg(mapping={"color_refine": False})
    return SlamEngine(cfg, output=str(tmp_path / name), device=device)


def _run(eng, record):
    if record:
        eng.timer.start_recording(4096)
    eng.run()
    return eng.timer.stop_recording() if record else None


def _tree(spans):
    by = {s["index"]: s for s in spans}
    kids = {i: [] for i in by}
    for s in spans:
        if s["parent"] is not None:
            kids[s["parent"]].append(s)
    return by, kids


def _names(kids, s):
    return [c["name"] for c in kids[s["index"]]]


@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    """A strict run with recording on and the same run with it off."""
    tmp = tmp_path_factory.mktemp("tracing")
    off = _engine(tmp, "off")
    _run(off, False)
    on = _engine(tmp, "on")
    spans = _run(on, True)
    return off, on, spans


def test_recording_off_keeps_no_records_and_the_stages(recorded):
    off, on, _ = recorded
    assert not off.timer.recording
    assert off.timer.stop_recording() == []
    # the stages as they were: io every frame, track every tracked frame,
    # map every event, the final checkpoint
    want = {"io": N_FRAMES, "track": N_FRAMES - 1, "map": len(EVENTS),
            "ckpt": 1}
    for eng in (off, on):
        assert set(eng.timings) == {"track", "map", "ckpt", "io"}
        assert dict(eng.timer.counts) == want
        assert all(v > 0 for v in eng.timings.values())


def test_a_recorded_run_equals_one_that_does_not_record(recorded):
    off, on, _ = recorded
    for a, b in zip([off.est_c2w_dev] + tree_leaves(off.map_state.params)
                    + tree_leaves(off.map_state.grids),
                    [on.est_c2w_dev] + tree_leaves(on.map_state.params)
                    + tree_leaves(on.map_state.grids)):
        assert torch.equal(a, b)
    assert off.stats() == on.stats()


def test_each_frame_is_a_tree(recorded):
    _, eng, spans = recorded
    by, kids = _tree(spans)
    roots = [s for s in spans if s["parent"] is None]
    assert [s["name"] for s in roots] == ["frame"] * N_FRAMES
    assert [s["id"] for s in roots] == list(range(N_FRAMES))
    cam = eng.specs.camera
    for root in roots:
        names = _names(kids, root)
        assert names[0] == "frame.load"
        assert ("track" in names) == (root["id"] > 0)
        load = kids[root["index"]][0]
        assert _names(kids, load) == ["frame.read", "frame.upload"]
        upload = kids[load["index"]][1]
        # f32 colour and depth (the synthetic reader sends no uint8)
        assert upload["counts"] == {"bytes_to_device": cam.H * cam.W * 16}
    for s in spans:
        if s["name"] == "track":
            assert _names(kids, s)[-2:] == ["track.iters", "track.wait"]
            assert "track.init_select" in _names(kids, s) or s["id"] < 2
            it = next(c for c in kids[s["index"]]
                      if c["name"] == "track.iters")
            # the CPU runner runs every iteration eagerly
            assert it["counts"] == {"replays": 0, "captures": 0,
                                    "eager_steps": eng.specs.track.iters}


def test_each_event_has_its_stages_and_the_coarse_mapper(recorded):
    _, _, spans = recorded
    by, kids = _tree(spans)
    events = [s for s in spans if s["name"] == "map.event"]
    assert [s["id"] for s in events] == EVENTS
    for ev in events:
        assert by[ev["parent"]]["name"] == "frame"
        names = _names(kids, ev)
        assert names[0] == "map.prepare" and names[-1] == "map.wait"
        assert {"map.middle", "map.fine", "map.color", "map.writeback",
                "map.coarse"} <= set(names)
        coarse = next(c for c in kids[ev["index"]]
                      if c["name"] == "map.coarse")
        assert _names(kids, coarse) == ["map.prepare", "map.coarse.iters",
                                        "map.writeback"]
        loops = [c for c in kids[ev["index"]] if c["name"] in REPLAY_LOOPS]
        assert sum(c["counts"]["eager_steps"] for c in loops) == (
            ev["counts"]["eager_steps"]
            - sum(c["counts"]["eager_steps"] for c in kids[ev["index"]]
                  if c["name"] == "map.coarse"))
    assert {s["name"] for s in spans} >= {"ckpt"}


def test_children_lie_within_their_parents_and_share_their_ids(recorded):
    _, _, spans = recorded
    by, _ = _tree(spans)
    for s in spans:
        assert s["t0"] <= s["t1"]
        # the CPU has no device span
        assert s["d0"] is None and s["d1"] is None
        if s["parent"] is None:
            continue
        p = by[s["parent"]]
        assert p["t0"] <= s["t0"] and s["t1"] <= p["t1"], (s, p)
        assert s["id"] == p["id"] and s["thread"] == p["thread"]


def test_runner_counters_and_captures_show_in_the_spans(tmp_path):
    """Through the CUDAGraph test double: a signature's warm-up and
    capture are `graphs.capture` spans (id: the signature's first key
    element), and every later iteration counts as a replay of its
    loop."""
    eng = _engine(tmp_path, "double")
    eng._track_graphs = DoubleGraphs()
    eng._map_graphs = DoubleGraphs(max_iters=eng._map_graphs.max_iters)
    spans = _run(eng, True)
    by, kids = _tree(spans)
    caps = [s for s in spans if s["name"] == "graphs.capture"]
    assert {s["id"] for s in caps} == {"track", "init_select", "map"}
    st = {k: eng._track_graphs.stats()[k] + eng._map_graphs.stats()[k]
          for k in ("captures", "eager_steps", "replays")}
    # a capture span per warm-up and per capture
    assert len(caps) == st["captures"] + st["eager_steps"]
    for s in caps:
        assert by[s["parent"]]["name"] in REPLAY_LOOPS | {
            "track.init_select"}
    iters = eng.specs.track.iters
    tracked = [s for s in spans if s["name"] == "track.iters"]
    assert len(tracked) == N_FRAMES - 1
    for s in tracked:
        c = s["counts"]
        assert c["replays"] + c["eager_steps"] == iters
        assert c["captures"] == (1 if s["id"] == 1 else 0)
        # after frame 1 the tracking loop only replays
        assert c["replays"] == (iters - 1 if s["id"] == 1 else iters)
    total = sum(s["counts"]["replays"] for s in spans
                if s["name"] in {"track", "map.event"})
    assert total == st["replays"]


def test_pipelined_mapper_spans_nest_on_its_thread(tmp_path):
    cfg = load_config(overrides={
        "dataset": "synthetic", "synthetic": {"n_frames": 7},
        "cam": {"H": 24, "W": 32, "fx": 24.0, "fy": 24.0, "cx": 15.5,
                "cy": 11.5, "crop_edge": 0},
        "grid_len": {"coarse": 1.0, "middle": 0.32, "fine": 0.16,
                     "color": 0.16, "bound_divisible": 0.32},
        "mapping": {"bound": [[-0.5, 4.5], [-0.5, 3.5], [-0.5, 4.5]],
                    "every_frame": 3, "keyframe_every": 3,
                    "iters_first": 6, "iters": 3, "pixels": 60,
                    "mapping_window_size": 3, "ckpt_freq": 10000,
                    "mesh_freq": 10000, "color_refine": False},
        "tracking": {"iters": 2, "pixels": 40, "ignore_edge_W": 4,
                     "ignore_edge_H": 4},
        "tpu": {"seed": 0, "pipelined": True}})
    eng = PipelinedSlamEngine(cfg, output=str(tmp_path), device="cpu")
    spans = _run(eng, True)
    by, kids = _tree(spans)
    main = threading.get_ident()
    frames = [s for s in spans if s["name"] == "frame"]
    assert [s["id"] for s in frames] == list(range(N_FRAMES))
    assert all(s["thread"] == main and s["parent"] is None for s in frames)
    events = [s for s in spans if s["name"] == "map.event"]
    assert [s["id"] for s in events] == EVENTS
    for ev in events:
        # a tree of its own on the mapper's thread
        assert ev["parent"] is None and ev["thread"] != main
        assert {"map.prepare", "map.coarse", "map.wait"} <= set(
            _names(kids, ev))
    for s in spans:
        if s["parent"] is not None:
            p = by[s["parent"]]
            assert s["thread"] == p["thread"] and s["id"] == p["id"]
            assert p["t0"] <= s["t0"] and s["t1"] <= p["t1"]
    # the snapshots after each join refresh the tracker's copy
    assert [s["id"] for s in spans if s["name"] == "track.refresh"] == [
        None, 3, 6]


def test_stages_keep_the_self_time_rule_while_recording():
    """A keyed span nested in another counts only to itself, a span
    without a key takes nothing from its parent's stage, and recording
    turns off with the spans open."""
    timer = StageTimer()
    timer.start_recording(16)
    t0 = time.perf_counter()
    with timer.span("map.event", key="map"):
        with timer.span("map.prepare"):
            time.sleep(0.01)
        with timer.span("vis", key="vis"):
            time.sleep(0.03)
    elapsed = time.perf_counter() - t0
    assert timer.totals["vis"] >= 0.03
    assert timer.totals["map"] >= 0.01
    assert abs(timer.totals["map"] + timer.totals["vis"] - elapsed) < 1e-3
    assert dict(timer.counts) == {"map": 1, "vis": 1}
    with timer.span("frame", id=9):
        spans = timer.stop_recording()
    assert [s["name"] for s in spans] == ["map.event", "map.prepare", "vis"]
    assert [s["parent"] for s in spans] == [None, 0, 0]


def test_span_opens_a_child_of_the_threads_innermost_span():
    """`profiling.span` needs no timer: a child of the calling thread's
    innermost open span, on that span's timer while it records, with the
    runner it is given for its counters; a null context outside every
    span, under a timer that does not record, and on another thread."""
    from nice_slam_torch.graphs import StepGraphs
    from nice_slam_torch.utils.profiling import span

    graphs = StepGraphs("cpu")
    idle, timer = StageTimer(), StageTimer()
    with span("alone"):
        pass
    with idle.span("root", id=1, key="map"), span("quiet"):
        pass
    timer.start_recording(16)
    with span("alone"):
        pass
    with timer.span("root", id=4):
        with span("child", graphs=graphs):
            graphs.eager_steps += 2
            with span("grandchild", id=5):
                pass
        other = threading.Thread(target=lambda: span("elsewhere").__enter__())
        other.start()
        other.join()
    spans = timer.stop_recording()
    assert [(s["name"], s["parent"], s["id"]) for s in spans] == [
        ("root", None, 4), ("child", 0, 4), ("grandchild", 1, 5)]
    assert spans[1]["counts"] == {"replays": 0, "eager_steps": 2,
                                  "captures": 0}
    assert spans[2]["counts"]["eager_steps"] == 0
    assert idle.counts == {"map": 1} and timer.dropped == 0


def test_a_new_recording_adopts_no_open_span():
    """A span left open when recording stops ends into nothing, and is no
    parent in the next recording."""
    timer = StageTimer()
    timer.start_recording(8)
    with timer.span("old", id=1):
        assert timer.stop_recording() == []
        timer.start_recording(8)
        with timer.span("new"):
            pass
    spans = timer.stop_recording()
    assert [(s["name"], s["parent"], s["id"]) for s in spans] == [
        ("new", None, None)]


def test_capacity_drops_later_spans():
    timer = StageTimer()
    with pytest.raises(ValueError):
        timer.start_recording(0)
    timer.start_recording(3)
    for i in range(5):
        with timer.span("s", id=i):
            timer.count("n", i)
    spans = timer.stop_recording()
    assert [(s["id"], s["counts"]) for s in spans] == [
        (0, {"n": 0}), (1, {"n": 1}), (2, {"n": 2})]
    assert timer.dropped == 2


def test_span_clock_is_the_profilers():
    """Under torch.profiler a span's host start lies within 1 ms before
    a record_function opened just inside it."""
    from torch.profiler import ProfilerActivity, profile, record_function

    timer = StageTimer()
    timer.start_recording(64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        # the first record_function of a process looks its operator up:
        # a one-time cost between a span's stamp and the annotation's
        with record_function("warm"):
            pass
        for i in range(20):
            with timer.span("probe", id=i), record_function(f"rf{i}"):
                torch.ones(8).sum()
    spans = {s["id"]: s for s in timer.stop_recording()}
    starts = {e.name(): e.start_ns()
              for e in prof.profiler.kineto_results.events()
              if e.name().startswith("rf")}
    assert len(starts) == 20
    for i, s in spans.items():
        gap = starts[f"rf{i}"] - s["t0"]
        assert 0 <= gap < 1_000_000, (i, gap)


def test_torch_trace_writes_the_spans_beside_the_operators(tmp_path):
    from torch.profiler import record_function

    timer = StageTimer()
    with torch_trace(str(tmp_path), timer):
        with record_function("warm"):   # the operator's one-time look-up
            pass
        with timer.span("probe", id=5), record_function("rf"):
            torch.ones(8).sum()
    assert not timer.recording
    events = json.load(open(tmp_path / "trace.json"))["traceEvents"]
    span = [e for e in events if e.get("cat") == "program"]
    assert [(e["name"], e["pid"], e["args"]["id"]) for e in span] == [
        ("probe", "program", 5)]
    rf = next(e for e in events if e.get("name") == "rf")
    assert 0 <= rf["ts"] - span[0]["ts"] < 1000
    assert rf["ts"] + rf["dur"] <= span[0]["ts"] + span[0]["dur"] + 1


# ---------------------------------------------------------------------------
# On a card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _sync_warnings(eng, record) -> int:
    """Synchronisation warnings over frames 6-15 of a run whose frames
    0-5 (events 0 and 5) captured every graph: ten tracked frames and the
    events at frames 10 and 15."""
    import warnings

    eng.run(n_frames=6)
    if record:
        eng.timer.start_recording(4096)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            eng.run(n_frames=16)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    if record:
        assert [s["id"] for s in eng.timer.stop_recording()
                if s["name"] == "map.event"] == [10, 15]
    return len(caught)


@pytest.mark.cuda
def test_recording_adds_no_synchronisation_on_cuda(tmp_path, card):
    """As many synchronisation warnings with recording on as off, after a
    first run that does the process's one-time work."""
    counts = []
    for record in (False, False, True):
        cfg = _cfg(synthetic={"n_frames": 20},
                   mapping={"every_frame": 5, "color_refine": False})
        eng = SlamEngine(cfg, output=str(tmp_path / str(len(counts))),
                         device="cuda")
        counts.append(_sync_warnings(eng, record))
    assert counts[1] == counts[2], counts


@pytest.mark.cuda
def test_device_spans_meet_the_profilers_kernels_on_cuda(tmp_path, card):
    """Each track.iters device span starts within 0.2 ms of the first
    kernel the profiler records from its start on."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cfg = _cfg(synthetic={"n_frames": 9}, mapping={"color_refine": False})
    eng = SlamEngine(cfg, output=str(tmp_path), device="cuda")
    eng.run(n_frames=5)
    eng.timer.start_recording(4096)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.run()
        torch.cuda.synchronize()
    spans = eng.timer.stop_recording()
    kernels = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                     for e in prof.profiler.kineto_results.events()
                     if e.device_type() == DeviceType.CUDA)
    loops = [s for s in spans if s["name"] == "track.iters"]
    assert len(loops) == 4 and all(s["d0"] is not None for s in loops)
    for s in loops:
        first = next(k for k in kernels if k[1] >= s["d0"])
        assert abs(first[0] - s["d0"]) < 200_000, (s, first)
