"""Profiling: the port's one tracer (`StageTimer`, which keeps
SlamEngine.timings and, while it records, the engine's spans) and a
torch.profiler trace (the port of the JAX package's utils/profiling.py,
whose `xla_trace` becomes `torch_trace`).

    with torch_trace("LOGDIR", engine.timer) as prof:   # LOGDIR/trace.json
        engine.run()
    prof.key_averages()                     # the profile, when wanted

`torch_trace(None)` does nothing and yields None.  The trace holds the
host's operators and, on a GPU, the device's kernels (CUPTI); with a
timer, also the program's spans, as Chrome "X" events on the same clock.

Spans.  `timer.span(name, id=..., key=..., graphs=...)` opens a span of
the calling thread; `span(name, ...)` opens a child of the thread's
innermost open span on that span's timer, so the tracking and mapping
code opens its spans without a timer at hand.  With a `key` a span is
also a stage: its host seconds add to `timings[key]`, less those of the
stages nested in it on the same thread (the self-time rule: the panels
drawn inside a mapping event count under 'vis', not 'map').  While the
timer records (`start_recording`), a span also keeps its name, its id
(the parent's when not given), its parent on the thread, its host start
and end on `time.time_ns()` (the clock of torch.profiler's host events),
a CUDA-event pair on the thread's current stream of its device (from a
pool made when recording starts), the deltas of its `StepGraphs`
runner's counters (replays, eager steps, captures; the parent's runner
when not given) and what `count` adds to it.  Off, a span without a key
is a null context.  Device events become host-clock times through
anchors (`anchor`: a host stamp and a CUDA event recorded on a stream
the caller has just synchronised), so recording adds no synchronisation;
`stop_recording` waits for the recorded events and returns the spans."""

from __future__ import annotations

import bisect
import contextlib
import itertools
import json
import os
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch

_NULL = contextlib.nullcontext()
# the spans a recording keeps (torch_trace's, the benchmark's)
CAPACITY = 1 << 16
# the runner counters whose deltas a span keeps
_GRAPH_COUNTERS = ("replays", "eager_steps", "captures")
# per thread, "spans": the records of the open spans, of any timer
_open = threading.local()


def span(name: str, id=None, graphs=None):
    """A child of the calling thread's innermost open span, on that span's
    timer while it records; a null context otherwise.  `graphs`: the
    StepGraphs runner whose counters' deltas the span keeps (the
    parent's when None)."""
    stack = _open.__dict__.get("spans")
    rec = stack[-1] if stack else None
    if rec is None or not rec.timer._on:
        return _NULL
    return _Span(rec.timer, name, id, None, graphs)


class _Record:
    __slots__ = ("timer", "session", "index", "name", "id", "parent",
                 "thread", "t0", "t1", "dev", "stream", "ev0", "ev1", "graphs",
                 "g0", "counts")


class _Stage:
    """A stage while the timer does not record: host seconds only."""

    __slots__ = ("timer", "key", "frame")

    def __init__(self, timer, key):
        self.timer = timer
        self.key = key

    def __enter__(self):
        self.frame = self.timer._open_stage()

    def __exit__(self, *exc):
        self.timer._close_stage(self.key, self.frame)
        return False


class _Span:
    """A span while the timer records (a stage too, with a key)."""

    __slots__ = ("timer", "name", "id", "key", "graphs", "rec", "frame")

    def __init__(self, timer, name, id, key, graphs):
        self.timer = timer
        self.name = name
        self.id = id
        self.key = key
        self.graphs = graphs

    def __enter__(self):
        t = self.timer
        stack = _open.__dict__.setdefault("spans", [])
        self.rec = t._begin(self.name, self.id, self.graphs,
                            stack[-1] if stack else None)
        stack.append(self.rec)
        self.frame = t._open_stage() if self.key is not None else None

    def __exit__(self, *exc):
        t = self.timer
        if self.frame is not None:
            t._close_stage(self.key, self.frame)
        t._end(self.rec)
        _open.spans.pop()
        return False


class StageTimer:
    """Host seconds by stage (`totals`, `counts`) and, while recording,
    the spans of every thread.  Nesting is per thread: the pipelined
    engine's tracker and mapper open spans at once, each into its own
    stack (so the mapper's spans form a tree of their own), and the totals
    are kept under a lock.  `devices`: those whose streams the spans'
    CUDA events go on (a pool each while recording); the first takes a
    span's events unless the span's runner names another."""

    def __init__(self, *devices):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()
        # per thread: "open", [start, seconds of the stages nested in it]
        # of each open stage
        self._local = threading.local()
        self.devices = [torch.device(d) for d in devices]
        self._on = False
        self._pool: dict = {}
        # counts the recordings: a span left open by an earlier recording
        # is no parent in a later one and does not end into it
        self._session = 0
        self._capacity = 0
        self.dropped = 0

    @property
    def recording(self) -> bool:
        return self._on

    @property
    def device(self):
        return self.devices[0] if self.devices else None

    # -- spans and stages ----------------------------------------------------

    def span(self, name: str, id=None, key: Optional[str] = None,
             graphs=None):
        if self._on:
            return _Span(self, name, id, key, graphs)
        if key is None:
            return _NULL
        return _Stage(self, key)

    def time(self, name: str):
        """The stage `name`: a span of that name under the same key."""
        return self.span(name, key=name)

    def count(self, name: str, n: int) -> None:
        """Add n to the counter `name` of this thread's innermost open
        span, while recording."""
        if not self._on:
            return
        stack = _open.__dict__.get("spans")
        rec = stack[-1] if stack else None
        if rec is not None and rec.timer is self:
            rec.counts[name] = rec.counts.get(name, 0) + n

    def _open_stage(self) -> list:
        frame = [time.perf_counter(), 0.0]
        self._local.__dict__.setdefault("open", []).append(frame)
        return frame

    def _close_stage(self, key: str, frame: list) -> None:
        stack = self._local.open
        stack.pop()
        dt = time.perf_counter() - frame[0]
        with self._lock:
            self.totals[key] += dt - frame[1]
            self.counts[key] += 1
        if stack:
            stack[-1][1] += dt

    # -- recording -----------------------------------------------------------

    def start_recording(self, capacity: int) -> None:
        """Record the next `capacity` spans (later ones are dropped and
        counted in `dropped`).  On each of the timer's cards, the CUDA
        events of the spans and of the anchors are made here: a CUDA event
        exists from its first record, so each is recorded once on the
        device's current stream (which waits for nothing)."""
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, not {capacity}")
        self._records: List[_Record] = []
        self._ids = itertools.count()
        self._anchors: list = []
        self._capacity = capacity
        self.dropped = 0
        self._session += 1
        # by device index: the spans' events (two a span, by its index)
        # and the anchors' (taken from the end)
        self._pool, self._anchor_pool = {}, {}
        for dev in self.devices:
            if dev.type != "cuda":
                continue
            stream = torch.cuda.current_stream(dev)
            if stream.device_index in self._pool:
                continue
            evs = [torch.cuda.Event(enable_timing=True)
                   for _ in range(2 * capacity + capacity // 8 + 64)]
            for ev in evs:
                ev.record(stream)
            self._pool[stream.device_index] = evs[:2 * capacity]
            self._anchor_pool[stream.device_index] = evs[2 * capacity:]
        self._on = True

    def stop_recording(self) -> List[dict]:
        """Stop recording; wait for the recorded CUDA events, free the
        pool and return the finished spans in the order they opened: dicts
        of index, name, id, parent (an index or None), thread, t0 and t1
        (host ns), d0 and d1 (the device span in host-clock ns, None where
        not measured: on the CPU, or on a device with no anchor), anchor
        (the host ns of the anchor that placed the device span) and
        counts."""
        if not self._on:
            return []
        self._on = False
        records = sorted(self._records, key=lambda r: r.index)
        anchors = self._anchors
        for dev in self._pool:
            torch.cuda.synchronize(dev)
        by_dev = defaultdict(list)
        for a in sorted(anchors, key=lambda a: a[0]):
            by_dev[a[1]].append(a)
        by_dev = {d: ([a[0] for a in v], v) for d, v in by_dev.items()}
        out = [_as_dict(r, by_dev) for r in records if r.t1 is not None]
        self._records, self._anchors = [], []
        self._pool, self._anchor_pool = {}, {}
        return out

    def anchor(self, device) -> None:
        """Tie the device clock to the host clock: call right after
        synchronising the calling thread's current stream on `device`,
        while recording."""
        if not (self._on and device.type == "cuda"):
            return
        stream = torch.cuda.current_stream(device)
        pool = self._anchor_pool.get(stream.device_index)
        if not pool:
            return
        ev = pool.pop()
        t = time.time_ns()
        ev.record(stream)
        self._anchors.append((t, stream.device_index, ev))

    def _begin(self, name, id, graphs, parent) -> Optional[_Record]:
        i = next(self._ids)
        if i >= self._capacity:
            with self._lock:
                self.dropped += 1
            return None
        rec = _Record()
        rec.timer = self
        rec.session = self._session
        rec.index = i
        rec.name = name
        if parent is not None and (parent.timer is not self
                                   or parent.session != self._session):
            parent = None
        if parent is not None:
            id = parent.id if id is None else id
            graphs = parent.graphs if graphs is None else graphs
        rec.id = id
        rec.parent = None if parent is None else parent.index
        rec.thread = threading.get_ident()
        rec.graphs = graphs
        rec.counts = {}
        rec.g0 = (None if graphs is None
                  else tuple(getattr(graphs, c) for c in _GRAPH_COUNTERS))
        rec.t1 = rec.ev1 = rec.ev0 = rec.dev = None
        rec.t0 = time.time_ns()
        dev = graphs.device if graphs is not None else self.device
        if self._pool and dev.type == "cuda" \
                and not torch.cuda.is_current_stream_capturing():
            stream = torch.cuda.current_stream(dev)
            pool = self._pool.get(stream.device_index)
            if pool is not None:
                rec.ev0, rec.ev1 = pool[2 * i], pool[2 * i + 1]
                rec.ev0.record(stream)
                rec.dev, rec.stream = stream.device_index, stream
        self._records.append(rec)
        return rec

    def _end(self, rec: Optional[_Record]) -> None:
        if rec is None or not self._on or rec.session != self._session:
            return
        if rec.dev is not None:
            # the span ends on the stream it started on
            rec.ev1.record(rec.stream)
        rec.t1 = time.time_ns()
        if rec.g0 is not None:
            for c, v in zip(_GRAPH_COUNTERS, rec.g0):
                rec.counts[c] = getattr(rec.graphs, c) - v


def _as_dict(r: _Record, anchors_by_dev) -> dict:
    d0 = d1 = t = None
    times, anchors = anchors_by_dev.get(r.dev, ((), ()))
    if anchors:
        # the anchor nearest in host time
        k = bisect.bisect_left(times, r.t0)
        cand = anchors[max(k - 1, 0):k + 1]
        t, _, ev = min(cand, key=lambda a: abs(a[0] - r.t0))
        d0 = t + round(ev.elapsed_time(r.ev0) * 1e6)
        d1 = t + round(ev.elapsed_time(r.ev1) * 1e6)
    return {"index": r.index, "name": r.name, "id": r.id,
            "parent": r.parent, "thread": r.thread, "t0": r.t0, "t1": r.t1,
            "d0": d0, "d1": d1, "anchor": t, "counts": r.counts}


def _chrome_events(spans: List[dict], base_ns: int = 0) -> list:
    """The spans as Chrome trace "X" events in microseconds from
    `base_ns`: host spans under the process "program", device spans under
    "program (device)", one row a thread."""
    out = []
    for s in spans:
        args = {"id": s["id"], **s["counts"]}
        out.append({"ph": "X", "cat": "program", "name": s["name"],
                    "pid": "program", "tid": s["thread"],
                    "ts": (s["t0"] - base_ns) / 1e3,
                    "dur": (s["t1"] - s["t0"]) / 1e3, "args": args})
        if s["d0"] is not None:
            out.append({"ph": "X", "cat": "program", "name": s["name"],
                        "pid": "program (device)", "tid": s["thread"],
                        "ts": (s["d0"] - base_ns) / 1e3,
                        "dur": (s["d1"] - s["d0"]) / 1e3, "args": args})
    return out


@contextlib.contextmanager
def torch_trace(logdir: Optional[str], timer: Optional[StageTimer] = None):
    """Profile the block with torch.profiler (host operators, and the
    device's kernels when CUDA is available) and write the Chrome trace
    to logdir/trace.json.  With `timer` (an engine's), the timer records
    up to CAPACITY spans over the block, unless it already records, and
    its spans join the trace.  Yields the profiler; a no-op when logdir
    is None."""
    if logdir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    mine = timer is not None and not timer.recording
    if mine:
        timer.start_recording(CAPACITY)
    spans = []
    try:
        with profile(activities=acts) as prof:
            yield prof
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    finally:
        if mine:
            spans = timer.stop_recording()
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    if spans:
        with open(path) as f:
            trace = json.load(f)
        trace["traceEvents"] += _chrome_events(
            spans, int(trace.get("baseTimeNanoseconds", 0)))
        with open(path, "w") as f:
            json.dump(trace, f)
