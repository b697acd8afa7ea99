"""Pipelined tracker and mapper, running at the same time (the counterpart
of the JAX package's nice_slam_tpu/parallel/pipelined.py).

The reference runs its tracker and mapper as concurrent processes around
shared tensors (src/NICE_SLAM.py:288-307); this engine runs its mapping
events on a thread of their own (`MapperThread`) while the loop tracks the
next frame group, with copies of the map playing the role of
Tracker.update_para_from_mapping (Tracker.py:130-142).  The schedule is
the JAX engine's (:115-171), one mapping event of lag:

    map(0) on M; snapshot -> T
    for each frame group [b_prev + 1 .. b]:
        track the group's frames on T against the CURRENT snapshot
        join the PREVIOUS event; pull its map and its BA pose  (M -> T)
        hand this boundary's mapping event for frame b to M
    join the last event; final snapshot

The tracker's map therefore lags by exactly one mapping event, and event b
runs while group b + 1 is tracked: the overlap that the JAX engine gets
from non-blocking dispatch (`_map_barrier = False`).  Which snapshot each
frame is tracked on and which event each snapshot pulls is fixed by the
loop, not by the threads, so a run equals the sequential order of the same
steps bit for bit.  The port tracks each frame of a group with its
per-frame `track`: grouping is TPU dispatch fusion, and against a fixed
snapshot it gives the same poses.

On two cards the tracker owns devices[0] and the mapper devices[1]; on one
card (or the CPU) both share it, and on a card the mapper runs on a CUDA
stream of its own, so the card runs both sides at once (the reference's
loose mode also shared one GPU).  The snapshot, the map-side trajectory
and the tracker's trajectory are always distinct storage: the mapping step
writes BA poses into its trajectory and keyframe store in place (mapping.py
`_one_map_optimize`), and `Tensor.to` returns the same tensor when the
device already matches, so every copy here is explicit (the torch form of
the aliasing the JAX package met on one chip, tests/test_parallel.py:162).
The snapshot is the tracker's copy of the map (`_load_track_map`), copied
into in place, so the tracker's CUDA graphs read it where they were
captured; each side has its own graph runner (the tracker's on
devices[0] with `gen_track`) and memory pool.

What each side touches.  The loop's thread: the tracker's trajectory, its
snapshot and generator (`gen_track`, seeded with tpu.seed + 1),
`tracking_stats`, `gt_c2w` and `frames_done`.  The mapper's thread: the
map, the keyframe store, the engine's generator, `kf_frame_ids`,
`selected_keyframes`, the checkpoints and meshes, and the map side's
trajectory, GT poses and frame count, handed over by the loop with each
event (`map_side`).  Both: the stage timer and `written` (panels), each
under a lock; the timer's spans nest per thread, so the mapper's events
are span trees of their own (`map.event`, on the mapper's stream), and
each join re-anchors the device clock.  The mapper's thread starts only
after the previous event has been joined, and the loop reads the map only
between a join and the next hand-over.

Panels (enable_visualizer): mapping_only=True draws the mapping panels on
the mapper's thread, as the JAX engine (:121-124); the per-iteration
tracking panels render against the tracker's snapshot; the per-frame
tracking hook of inside=False needs the per-frame loop and is refused, as
in JAX.  tracking.gt_camera has no tracking to overlap and runs the
sequential engine's per-frame loop on the mapping device.  The engine runs
from frame 0 (the JAX engine's run ignores a resume point too), and
refuses a process group of more than one rank: pipelining and
data-parallel mapping are exclusive.
"""

from __future__ import annotations

import threading
from typing import Optional, Sequence

import torch

from nice_slam_torch.engine import SlamEngine
from nice_slam_torch.graphs import StepGraphs


def group_end(cur: int, every_frame: int, n: int) -> int:
    """Last frame of the group starting at `cur`: the next every_frame
    boundary, capped at the final frame (nice_slam_tpu/engine.py:911)."""
    return min(((cur - 1) // every_frame + 1) * every_frame, n - 1)


def default_devices(device: str = "cuda") -> list:
    """The first two cards for 'cuda' (one when there is one), else
    [device]."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return [dev]
    return [torch.device("cuda", i)
            for i in range(min(2, torch.cuda.device_count()))]


def _copy_to(x: torch.Tensor, dev) -> torch.Tensor:
    """A copy of x on dev, never x itself."""
    return x.detach().to(dev, copy=True)


class MapperThread:
    """Runs one job at a time on a thread of its own and, on a CUDA
    device, on a stream of its own there.

    `submit(job, *held)`: the job's stream first waits for the work the
    caller has queued on `device` so far (the uploads and copies the job
    reads), and `held` (those tensors) stay referenced until `join`, so
    that the caching allocator does not give their blocks to the caller's
    stream while the job still reads them.  `join()` waits for the job,
    raises its exception if it raised, and makes the caller's current
    stream on `device` wait for the job's work."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = (torch.cuda.Stream(device) if device.type == "cuda"
                       else None)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._held: tuple = ()

    def submit(self, job, *held) -> None:
        if self._thread is not None:
            raise RuntimeError("a mapping event is still running")
        ready = (torch.cuda.current_stream(self.device).record_event()
                 if self.stream is not None else None)
        self._held = held

        def body():
            try:
                if self.stream is None:
                    job()
                    return
                with torch.cuda.device(self.device), \
                        torch.cuda.stream(self.stream):
                    self.stream.wait_event(ready)
                    job()
            except BaseException as e:   # re-raised by join()
                self._error = e

        self._thread = threading.Thread(target=body, name="mapper")
        self._thread.start()

    def join(self) -> None:
        if self._thread is None:
            return
        self._thread.join()
        self._thread = None
        self._held = ()
        err, self._error = self._error, None
        if err is not None:
            raise err
        if self.stream is not None:
            torch.cuda.current_stream(self.device).wait_stream(self.stream)


class PipelinedSlamEngine(SlamEngine):
    """Tracker on devices[0], mapper on devices[1] (on devices[0] when one
    is given), the mapper on its own thread.  Use via
    cfg['tpu']['pipelined'] (run_torch.py picks this class) or
    directly."""

    def __init__(self, cfg: dict, dataset=None, output: Optional[str] = None,
                 mesher_hook=None, devices: Optional[Sequence] = None,
                 device: str = "cuda"):
        devs = [torch.device(d) for d in (devices or
                                          default_devices(device))]
        super().__init__(cfg, dataset=dataset, output=output,
                         device=devs[1] if len(devs) > 1 else devs[0],
                         mesher_hook=mesher_hook)
        if self.world > 1:
            raise ValueError(
                "the pipelined engine runs in one process; a process group "
                f"of {self.world} ranks means data-parallel mapping")
        self.dev_track = devs[0]
        self.dev_map = self.device
        # the map, the keyframe store and the mapper's generator stay on
        # the mapping device; the tracker has its trajectory, its
        # generator and a snapshot of the map on its own (with GT poses
        # the trajectory stays with the map: nothing is tracked)
        if not self.gt_camera:
            self.est_c2w_dev = _copy_to(self.est_c2w_dev, self.dev_track)
        # (trajectory, GT poses, frames done) handed to the latest event
        self._side = None
        self.gen_track = torch.Generator(device=self.dev_track)
        self.gen_track.manual_seed(int(cfg["tpu"]["seed"]) + 1)
        self._track_graphs = StepGraphs(self.dev_track)
        self.timer.devices.append(self.dev_track)
        self._worker = None
        self._snapshot(None)

    def _tracking_map(self):
        return self._params_t, self._grids_t, self._bound_t, self.gen_track

    def map_side(self):
        if self.gt_camera:
            return super().map_side()
        return self._side

    def _snapshot(self, idx: Optional[int]) -> None:
        """Copy the mapper's map into the tracker's copy on the tracking
        device (the analogue of Tracker.update_para_from_mapping) and fold
        the BA-refined pose of frame `idx` into the tracker's
        trajectory."""
        with self.timer.span("track.refresh", id=idx,
                             graphs=self._track_graphs):
            self._load_track_map(self.dev_track)
        if idx is not None:
            self.est_c2w_dev[idx] = self._side[0][idx].to(self.dev_track)

    def _submit_event(self, idx: int, color, depth, gt_pose,
                      first: bool = False) -> None:
        """Hand the mapping event of frame idx to the mapper: the
        tracker's trajectory, GT poses and frame count as they stand (the
        JAX engine's copy, :160), then the event on the mapper's
        thread."""
        traj = _copy_to(self.est_c2w_dev, self.dev_map)
        self._side = (traj, self.gt_c2w.copy(), self.frames_done)
        self._worker.submit(
            lambda: self.mapping_event(idx, color, depth, gt_pose,
                                       first=first),
            traj, color, depth)

    def _join_event(self) -> None:
        """Wait for the event in flight; its error is raised here.  The
        mapper's stream has been synchronised by the event itself."""
        self._worker.join()
        self.timer.anchor(self.dev_track)

    def run(self, n_frames: Optional[int] = None, progress: bool = False):
        if self.gt_camera:
            return super().run(n_frames=n_frames, progress=progress,
                               start=0)
        if self._frame_hook is not None:
            raise ValueError(
                "the pipelined engine tracks in frame groups and cannot "
                "host a per-frame panel hook; use "
                "enable_visualizer(mapping_only=True)")
        n = min(n_frames or self.n_img, self.n_img)
        self._worker = MapperThread(self.dev_map)
        try:
            with self.timer.span("frame", id=0):
                color, depth, gt_pose = self._load_frame(0)
                self._set_gt_pose(0, gt_pose)
                self._submit_event(0, color, depth, gt_pose, first=True)
                self._join_event()
            self._snapshot(None)
            self.frames_done = 1
            cur, prev_event = 1, None
            while cur < n:
                g_end = group_end(cur, self.every_frame, n)
                # 1) track the group against the current (stale) snapshot,
                # while the previous event runs on the mapper
                for idx in range(cur, g_end + 1):
                    with self.timer.span("frame", id=idx):
                        color, depth, gt_pose = self._load_frame(idx)
                        self.track(idx, color.to(self.dev_track),
                                   depth.to(self.dev_track), gt_pose)
                # 2) join the previous event; pull its map and pose
                if prev_event is not None:
                    self._join_event()
                    self._snapshot(prev_event)
                # 3) hand this boundary's mapping event to the mapper
                if g_end % self.every_frame == 0 or g_end == n - 1:
                    self._submit_event(g_end, color, depth, gt_pose)
                    prev_event = g_end
                self.frames_done = g_end + 1
                cur = g_end + 1
            if prev_event is not None:
                self._join_event()
                self._snapshot(prev_event)
        finally:
            # on an error, no mapper is left running (its own error, if
            # any, is raised here with the loop's as its context)
            self._worker.join()
        return self
