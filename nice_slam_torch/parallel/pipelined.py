"""Pipelined tracker and mapper on two devices (the counterpart of the JAX
package's nice_slam_tpu/parallel/pipelined.py).

The reference runs its tracker and mapper as concurrent processes around
shared tensors (src/NICE_SLAM.py:288-307); this engine gives the tracker
one device and the mapper another, with copies of the map playing the
role of Tracker.update_para_from_mapping (Tracker.py:130-142).  The
schedule is the JAX engine's (:115-171), one mapping event of lag:

    map(0) on M; snapshot -> T
    for each frame group [b_prev + 1 .. b]:
        track the group's frames on T against the CURRENT snapshot
        pull the PREVIOUS event's map and its BA pose        (M -> T)
        run this boundary's mapping event for frame b          (M)
    final snapshot

The tracker's map therefore lags by exactly one mapping event.  The port
tracks each frame of a group with its per-frame `track`: grouping is TPU
dispatch fusion, and against a fixed snapshot it gives the same poses.

Given one device, both sides share it (the JAX package's degraded mode,
:47-52, :166-171).  The snapshot, the map-side trajectory and the
tracker's trajectory are then still distinct storage: the mapping step
writes BA poses into its trajectory and keyframe store in place
(mapping.py `_one_map_optimize`), and `Tensor.to` returns the same tensor
when the device already matches, so every copy here is explicit (the
torch form of the aliasing the JAX package met on one chip,
tests/test_parallel.py:162).

The tracker draws from a generator of its own on its device (seeded with
tpu.seed + 1); the mapper keeps the engine's.  On two devices the two
sides run one after the other on the host; the overlap is what the
device queues give between host synchronisations.  tracking.gt_camera
has no tracking to overlap and runs the sequential engine's per-frame
loop.  Panels (enable_visualizer): mapping_only=True draws the mapping
panels, as the JAX engine (:121-124); the per-iteration tracking panels
render against the tracker's snapshot; the per-frame tracking hook of
inside=False needs the per-frame loop and is refused, as in JAX.  The
engine runs from frame 0 (the JAX engine's run ignores a
resume point too), and refuses a process group of more than one rank:
pipelining and data-parallel mapping are exclusive.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from nice_slam_torch.engine import SlamEngine
from nice_slam_torch.ops.tree import tree_map


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


class PipelinedSlamEngine(SlamEngine):
    """Tracker on devices[0], mapper on devices[1] (on devices[0] when one
    is given).  Use via cfg['tpu']['pipelined'] (run_torch.py picks this
    class) or directly."""

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
        # generator and a snapshot of the map on its own
        self.est_c2w_dev = _copy_to(self.est_c2w_dev, self.dev_track)
        # the map side's trajectory after its latest event
        self._est_m = None
        self.gen_track = torch.Generator(device=self.dev_track)
        self.gen_track.manual_seed(int(cfg["tpu"]["seed"]) + 1)
        self._snapshot(None)

    def _tracking_map(self):
        return self._params_t, self._grids_t, self._bound_t, self.gen_track

    def _snapshot(self, idx: Optional[int]) -> None:
        """Copy the mapper's map to the tracking device (the analogue of
        Tracker.update_para_from_mapping) and fold the BA-refined pose of
        frame `idx` into the tracker's trajectory."""
        st = self.map_state
        self._params_t = tree_map(lambda x: _copy_to(x, self.dev_track),
                                  st.params)
        self._grids_t = tree_map(lambda x: _copy_to(x, self.dev_track),
                                 st.grids)
        self._bound_t = _copy_to(st.bound, self.dev_track)
        if idx is not None:
            self.est_c2w_dev[idx] = self._est_m[idx].to(self.dev_track)

    def mapping_event(self, idx: int, color, depth, gt_pose,
                      first: bool = False) -> None:
        """The engine's mapping event on the map side's copy of the
        trajectory, taken from the tracker's just before (the JAX engine's
        swap, :177-186)."""
        est_t = self.est_c2w_dev
        self.est_c2w_dev = _copy_to(est_t, self.dev_map)
        try:
            super().mapping_event(idx, color, depth, gt_pose, first=first)
        finally:
            self._est_m = self.est_c2w_dev
            self.est_c2w_dev = est_t
        if self.gt_camera:
            # the sequential loop: the event's pose lands at once
            self._snapshot(idx)

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
        color, depth, gt_pose = self._load_frame(0)
        self._set_gt_pose(0, gt_pose)
        self.mapping_event(0, color, depth, gt_pose, first=True)
        self._snapshot(None)
        self.frames_done = 1
        cur, prev_event = 1, None
        while cur < n:
            g_end = group_end(cur, self.every_frame, n)
            # 1) track the group against the current (stale) snapshot
            for idx in range(cur, g_end + 1):
                color, depth, gt_pose = self._load_frame(idx)
                self.track(idx, color.to(self.dev_track),
                           depth.to(self.dev_track), gt_pose)
            # 2) pull the previous event's map and pose
            if prev_event is not None:
                self._snapshot(prev_event)
            # 3) this boundary's mapping event, on the mapper's device
            if g_end % self.every_frame == 0 or g_end == n - 1:
                self.mapping_event(g_end, color, depth, gt_pose)
                prev_event = g_end
            self.frames_done = g_end + 1
            cur = g_end + 1
        if prev_event is not None:
            self._snapshot(prev_event)
        return self
