"""One run of a cell: set-up, the measured window over the engine's own
`run`, the spans and counters the per-layer metrics read, the profiled
sub-window, and the captures that the reference check follows.

The engine takes its frames through `dataset=`: `StreamDataset` hands
out the cell's frame stream and marks every frame boundary (the engine
taking frame idx), after waiting for the calling thread's current stream
only.  The window starts when frame `warm_frames` is taken, after every
graph signature has been captured, and ends at the first boundary of a
group of every_frame frames once `seconds` have passed; then a run with
`trace` profiles `profile_groups` more groups, and the stream stops the
engine with `StopWindow`.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import registry


# the host annotations the harness puts around the engine's calls, which
# label the trace's idle gaps
ANNOTATIONS = ("engine.track", "engine.mapping_event", "engine.load_frame",
               "stream.frame")


class StopWindow(Exception):
    """Raised from the dataset to end the engine's run."""


class Spans:
    """Spans of one kind: CUDA-event pairs on the calling thread's current
    stream (host-clock pairs on the CPU), made in set-up."""

    def __init__(self, device, n: int):
        self.cuda = device.type == "cuda"
        self.n = n
        self.pairs = []
        self._pool = ([(torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
                       for _ in range(n)] if self.cuda else [])

    def start(self, tag):
        if len(self.pairs) >= self.n:
            return None
        if self.cuda:
            ev = self._pool[len(self.pairs)]
            ev[0].record()
        else:
            ev = [time.perf_counter(), None]
        self.pairs.append((tag, ev))
        return ev

    def stop(self, ev):
        if ev is None:
            return
        if self.cuda:
            ev[1].record()
        else:
            ev[1] = time.perf_counter()

    def ms(self, origin=None) -> list:
        """[(tag, start ms, end ms)], from `origin` (a CUDA event, or a
        host time on the CPU)."""
        out = []
        for tag, (a, b) in self.pairs:
            if self.cuda:
                t0 = origin.elapsed_time(a) if origin is not None else 0.0
                out.append((tag, t0, t0 + a.elapsed_time(b)))
            else:
                o = origin if origin is not None else a
                out.append((tag, (a - o) * 1e3, (b - o) * 1e3))
        return out


@dataclass
class Capture:
    """What one sampled tracked frame or mapping event read and wrote, as
    pinned host copies made on the stream that ran it."""
    kind: str
    idx: int
    gen_state: torch.Tensor = None
    params: dict = None
    grids: dict = None
    bound: torch.Tensor = None
    extra: dict = field(default_factory=dict)
    out: dict = field(default_factory=dict)


def _host_like(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype,
                       pin_memory=t.device.type == "cuda")


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _tree_copy(dst, src):
    if isinstance(dst, dict):
        for k in dst:
            _tree_copy(dst[k], src[k])
    elif isinstance(dst, (list, tuple)):
        for d, s in zip(dst, src):
            _tree_copy(d, s)
    else:
        dst.copy_(src.detach(), non_blocking=True)


class Driver:
    """The clock, the spans and the captures of one run of `eng`."""

    def __init__(self, eng, workload: dict, seconds: float, trace: bool,
                 seed: int):
        self.eng = eng
        self.wl = workload
        self.seconds = float(seconds)
        self.trace = trace
        self.dev = eng.device
        self.cuda = self.dev.type == "cuda"
        self.every = eng.every_frame
        self.warm = int(workload["warm_frames"])
        self.groups = int(workload.get("profile_groups", 2))
        self.takes = {}
        self.t_ws = self.t_we = None
        self.end_idx = None
        self.phase = "setup"
        self.prof = None
        self.prof_end = None
        self.prof_t = None
        # spans only of the window's frames and events
        n_ev = 4096
        self.track_spans = Spans(self.dev, n_ev)
        self.map_spans = Spans(self.dev, n_ev)
        self.first_event = Spans(self.dev, 1)
        self.win_ev = ((torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
                       if self.cuda else None)
        self.counters = {}
        # the check's sample: tracked frames drawn from the seed, and the
        # mapping event at every offset
        rng = np.random.default_rng([seed, 17])
        ck = workload["check"]
        span = range(self.warm, self.warm + int(ck["track_span"]))
        self.track_sample = sorted(int(i) for i in rng.choice(
            span, size=int(ck["track_frames"]), replace=False))
        self.map_samples = [self.warm + int(o) for o in ck["map_offsets"]]
        self.captures = {}
        self._bufs = [self._make_bufs()
                      for _ in range(len(self.track_sample))]
        # the sampled event's states before the iterations the check
        # follows from, with the grids its steps read (the mode's)
        mode = registry.mode(registry.mode_of(eng.cfg))
        self.map_its = mode.snapshot_iterations(eng.cfg)
        self.state_grids = mode.STATE_GRIDS
        self._state_bufs = [self._make_state_bufs() for _ in self.map_its
                            for _ in self.map_samples]
        self._in_sampled_event = None

    # -- buffers and captures ----------------------------------------------

    def _make_bufs(self):
        st = self.eng.map_state
        return {"params": _tree_map(_host_like, st.params),
                "grids": {n: _host_like(g) for n, g in st.grids.items()}}

    def _make_state_bufs(self):
        st = self.eng.map_state
        wn = int(self.eng.cfg["mapping"]["mapping_window_size"])
        return {"params": _tree_map(_host_like, st.params),
                "grids": {n: _host_like(g) for n, g in st.grids.items()
                          if n in self.state_grids},
                "cams": _host_like(torch.empty(wn, 7, device=self.dev))}

    def _state(self, tree) -> dict:
        """Pinned host copies of a mapping loop's {"params", "grids",
        "cams"} (the grids its stages read) and the generator's state."""
        bufs = self._state_bufs.pop()
        _tree_copy(bufs, {"params": tree["params"],
                          "grids": {n: tree["grids"][n]
                                    for n in bufs["grids"]},
                          "cams": tree["cams"]})
        return {"tree": bufs, "gen": self.eng.gen.get_state().clone()}

    def _snapshot(self, kind, idx, params, grids, bound, gen) -> Capture:
        bufs = self._bufs.pop()
        _tree_copy(bufs["params"], params)
        _tree_copy(bufs["grids"], {n: grids[n] for n in bufs["grids"]})
        cap = Capture(kind, idx, gen_state=gen.get_state().clone(),
                      params=bufs["params"], grids=bufs["grids"],
                      bound=self._host(bound))
        self.captures[(kind, idx)] = cap
        return cap

    def _host(self, t):
        h = _host_like(t)
        h.copy_(t.detach(), non_blocking=True)
        return h

    def _track_buffers(self, color, depth):
        """The tracking loop's static buffers of the frame just tracked:
        every iteration's pre-step camera (`cams`) and loss (`losses`),
        and the camera after the last step (`cam`)."""
        from nice_slam_torch import tracking

        dev = self.eng.est_c2w_dev.device
        return tracking._track_buffers(
            self.eng._track_graphs, self.eng.specs.track, color.to(dev),
            depth.to(dev))[1]

    # -- the engine's entry points, wrapped on the instance ----------------

    def install(self):
        eng = self.eng
        orig_track, orig_event, orig_map = (eng.track, eng.mapping_event,
                                            eng._map)
        orig_load = eng._load_frame

        def load_frame(*a, **k):
            with record_function("engine.load_frame"):
                return orig_load(*a, **k)

        def track(idx, color, depth, gt_pose):
            cap = None
            if idx in self.track_sample and self.phase == "window":
                params, grids, bound, gen = eng._tracking_map()
                cap = self._snapshot("track", idx, params, grids, bound, gen)
                traj = eng.est_c2w_dev
                cap.extra = {"pre": self._host(traj[idx - 1]),
                             "pre_pre": self._host(traj[idx - 2])}
            ev = (self.track_spans.start(idx) if self.phase == "window"
                  else None)
            with record_function("engine.track"):
                out = orig_track(idx, color, depth, gt_pose)
            self.track_spans.stop(ev)
            if cap is not None:
                b = self._track_buffers(color, depth)
                n = eng.specs.track.iters
                cap.out = {"losses": self._host(
                    eng.tracking_stats[-1]["losses"]),
                    "pose": self._host(eng.est_c2w_dev[idx]),
                    "cams": self._host(b.cams[:n]),
                    "iter_losses": self._host(b.losses[:n]),
                    "last": self._host(b.cam)}
            return out

        def mapping_event(idx, color, depth, gt_pose, first=False):
            ev = None
            if first and idx == 0:
                ev = self.first_event.start(idx)
            elif self.phase == "window":
                ev = self.map_spans.start(idx)
            if idx in self.map_samples and self.phase == "window":
                store = eng.store
                cap = Capture("map", idx,
                              gen_state=eng.gen.get_state().clone(),
                              bound=self._host(eng.map_state.bound))
                cap.extra = {"cur": self._host(eng.map_side()[0][idx]),
                             "kf_c2w": self._host(store.est_c2w),
                             "kf_frames": self._host(store.frame_idx),
                             "count": int(store.count),
                             "capacity": int(store.capacity),
                             "states": {}, "pass_gens": [],
                             "pass_losses": []}
                self.captures[("map", idx)] = cap
                self._in_sampled_event = cap
            try:
                with record_function("engine.mapping_event"):
                    return orig_event(idx, color, depth, gt_pose,
                                      first=first)
            finally:
                cap = self._in_sampled_event
                if cap is not None and len(cap.extra["pass_losses"]) > 1:
                    # every mapper call's losses, numbered as its states
                    self._wait()
                    cap.out["losses"] = torch.cat(cap.extra["pass_losses"])
                self._in_sampled_event = None
                if ev is not None:
                    (self.first_event if first and idx == 0
                     else self.map_spans).stop(ev)

        def _map(*a, **k):
            cap = self._in_sampled_event
            parts = cap.extra["pass_losses"] if cap is not None else None
            base = sum(int(p.shape[0]) for p in parts or ())
            if cap is None or (parts and not any(i >= base
                                                 for i in self.map_its)):
                return orig_map(*a, **k)
            # the event's mapper calls (NICE's one; iMAP*'s three passes;
            # not the coarse mapper) show their state before each
            # iteration to on_iter, numbered on from the calls before
            prior = k.get("on_iter")
            states = cap.extra["states"]
            cap.extra["pass_gens"].append(eng.gen.get_state().clone())

            def on_iter(it, tree, *rest, **kw):
                if base + it in self.map_its and base + it not in states:
                    states[base + it] = self._state(tree)
                if prior is not None:
                    prior(it, tree, *rest, **kw)

            k["on_iter"] = on_iter
            losses = orig_map(*a, **k)
            parts.append(self._host(losses))
            if len(parts) == 1:
                cap.out["losses"] = parts[0]
            return losses

        eng.track, eng.mapping_event, eng._map = track, mapping_event, _map
        eng._load_frame = load_frame

    # -- the clock ---------------------------------------------------------

    def _wait(self):
        if self.cuda:
            torch.cuda.current_stream(self.dev).synchronize()

    def _read_counters(self, tag):
        from nice_slam_torch.ops import fused_decode as fd
        self.counters[tag] = {"fwd": fd.fwd_launch_kinds(),
                              "bwd": fd.bwd_launch_kinds(),
                              "graphs": self.eng.graph_stats()}

    def take(self, idx: int) -> None:
        """The engine takes frame idx."""
        self._wait()
        t = time.perf_counter()
        self.takes[idx] = t
        if self.phase == "setup" and idx == self.warm:
            self.phase = "window"
            self.t_ws = t
            self._read_counters("window_start")
            if self.cuda:
                self.win_ev[0].record()
            return
        boundary = (idx - 1) % self.every == 0
        if (self.phase == "window" and boundary
                and t - self.t_ws >= self.seconds):
            self.t_we, self.end_idx = t, idx
            if self.cuda:
                self.win_ev[1].record()
            self._read_counters("window_end")
            if not self.trace:
                self.phase = "done"
                raise StopWindow
            self.phase = "profile"
            self.prof_end = idx + self.groups * self.every
            self._start_profile()
            return
        if self.phase == "profile" and idx == self.prof_end:
            self._stop_profile()
            self.phase = "done"
            raise StopWindow

    def _start_profile(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self._read_counters("profile_start")
        self.prof.start()
        self.prof_t = [time.perf_counter(), None]

    def _stop_profile(self):
        self._wait()
        self.prof_t[1] = time.perf_counter()
        self.prof.stop()
        self._read_counters("profile_end")


class StreamDataset:
    """The cell's frames as a dataset reader hands them: (idx, colour
    float32 in [0, 1] from 8 bits, depth float32, pose), len() the
    published sequence length, colour uploaded as uint8."""

    transfer_color_uint8 = True

    def __init__(self, stream, n_img: int):
        self.stream = stream
        self.n_img = n_img
        self.driver: Optional[Driver] = None

    def __len__(self):
        return self.n_img

    def __getitem__(self, idx: int):
        if self.driver is not None:
            self.driver.take(idx)
        with record_function("stream.frame"):
            color, depth, pose = self.stream.frame(idx)
        return idx, color, depth, pose
