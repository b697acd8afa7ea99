"""The SLAM engine of the PyTorch port: strict NICE-SLAM on one device.

Under `sync_method: strict` the reference's three processes reduce to a
sequential interleave (SURVEY §3.5), which is what the JAX package's
grouped loop runs (nice_slam_tpu/engine.py `_run_grouped`) and what this
engine runs:

    map(0, iters_first x lr_first_factor)
    for each frame group [cur, g_end] ending on an every_frame boundary
    (or the last frame): track the group against the frozen map, then run
    the mapping event of g_end (mapping + BA, keyframe insertion, the
    coarse mapper; the last frame's event is the colour refinement)

Keyframes are inserted every keyframe_every frames and at the last two;
local BA starts once more than four keyframes exist.  The trajectory, the
map and the keyframe store stay on the device.

Not in this slice (the JAX package has them): loose/free sync, iMAP*,
meshing, checkpoint save/resume, the visualizer, the parallel modes, the
Gauss-Newton pose polish and occupancy-guided sampling.  The constructor
raises when a config asks for one of them.  The JAX package's TPU
dispatch knobs (tpu.*) are accepted and ignored.
"""

from __future__ import annotations

import os
import time
from dataclasses import replace
from typing import Optional

import numpy as np
import torch

from nice_slam_torch.config import SlamSpecs, specs_from_config
from nice_slam_torch.keyframes import KeyframeStore, add_keyframe, make_store
from nice_slam_torch.mapping import mapping_step, stage_iters_of
from nice_slam_torch.models.decoders import check_supported
from nice_slam_torch.state import make_map_state
from nice_slam_torch.tracking import track_frames_group
from nice_slam_torch.utils.datasets import get_dataset


def check_slice(cfg: dict) -> None:
    """Raise for config options this slice of the port does not run."""
    missing = []
    if cfg.get("sync_method", "strict") != "strict":
        missing.append(f"sync_method={cfg['sync_method']!r} (only strict)")
    if not cfg.get("nice", True):
        missing.append("iMAP* mode (nice=False / --imap)")
    r, t, m = cfg["rendering"], cfg["tracking"], cfg["mapping"]
    if r.get("N_importance", 0) > 0:
        missing.append("rendering.N_importance > 0")
    if r.get("occupancy_guided", False):
        missing.append("rendering.occupancy_guided")
    if not cfg.get("occupancy", True):
        missing.append("density compositing (occupancy=False)")
    if t.get("pose_GN_iters", 0) > 0 or m.get("pose_GN_iters", 0) > 0:
        missing.append("Gauss-Newton pose refinement (pose_GN_iters > 0)")
    if t.get("gt_camera", False):
        missing.append("tracking.gt_camera")
    tpu = cfg.get("tpu", {})
    for knob in ("pipelined", "data_parallel", "grid_sharded", "multihost"):
        if tpu.get(knob):
            missing.append(f"tpu.{knob} (parallel modes)")
    if missing:
        raise NotImplementedError(
            "not in this slice of the PyTorch port: " + "; ".join(missing))


class SlamEngine:
    def __init__(self, cfg: dict, dataset=None, output: Optional[str] = None,
                 device: str = "cuda"):
        check_slice(cfg)
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("device='cuda' but no CUDA device; pass "
                                   "device='cpu' to run the plain version")
            # fp32 throughout: TF32 GEMMs feed the ATE tail
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.cfg = cfg
        self.specs: SlamSpecs = specs_from_config(cfg)
        check_supported(self.specs.model)
        self.dataset = dataset if dataset is not None else get_dataset(cfg)
        self.n_img = len(self.dataset)
        self.output = output or cfg["data"]["output"]
        self.verbose = bool(cfg.get("verbose", False))

        m = cfg["mapping"]
        self.every_frame = m["every_frame"]
        self.keyframe_every = m["keyframe_every"]
        self.iters = m["iters"]
        self.iters_first = m["iters_first"]
        self.lr_factor = m["lr_factor"]
        self.lr_first_factor = m["lr_first_factor"]
        self.color_refine = m["color_refine"]
        # per-event selected-window record (save_selected_keyframes_info,
        # reference Mapper.py:274-287): {event idx -> window frame ids}
        self.save_selected_kf = bool(
            m.get("save_selected_keyframes_info", False))
        self.selected_keyframes = {}

        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(cfg["tpu"]["seed"]))
        self.map_state = make_map_state(
            self.gen, self.specs.model, m["bound"], cfg["grid_len"],
            cfg["grid_len"]["bound_divisible"], device=self.device)
        self._load_pretrained_decoders()

        cap = cfg["tpu"].get("keyframe_capacity") or (
            self.n_img // self.keyframe_every + 4)
        cam = self.specs.camera
        self.store: KeyframeStore = make_store(cap, cam.H, cam.W,
                                               device=self.device)
        self.kf_frame_ids: list = []
        self._warned_kf_capacity = False
        self._warned_bad_pose = False
        self.est_c2w_dev = torch.zeros(self.n_img, 4, 4, device=self.device)
        self.gt_c2w = np.zeros((self.n_img, 4, 4), np.float32)
        self.frames_done = 0
        self.timings = {"track": 0.0, "map": 0.0, "io": 0.0}

    def _load_pretrained_decoders(self):
        """Decoder weights from the repository's npz when present, else the
        calibrated random init."""
        npz = self.cfg.get("pretrained_decoders", {}).get("tpu_npz")
        if npz and os.path.exists(npz):
            from nice_slam_torch.models.pretrain import load_npz_decoders
            self.map_state.params = load_npz_decoders(
                npz, self.map_state.params)
            if self.verbose:
                print(f"loaded pretrained decoders from {npz}")
        else:
            print(f"warning: no pretrained decoders at {npz!r}; the "
                  "decoders keep their random init")

    # -- helpers -----------------------------------------------------------

    @property
    def bound(self) -> torch.Tensor:
        return self.map_state.bound

    @property
    def est_c2w(self) -> np.ndarray:
        """Host copy of the device trajectory."""
        return self.est_c2w_dev.detach().cpu().numpy()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _safe_est_pose(self, gt_pose, idx: int):
        """Non-finite GT poses (a ScanNet artifact) must not seed the
        trajectory; the ATE eval masks such frames."""
        p = np.asarray(gt_pose)
        if np.isfinite(p).all():
            return p
        if not self._warned_bad_pose:
            print(f"warning: non-finite GT pose at frame {idx}; using "
                  "identity for trajectory initialization")
            self._warned_bad_pose = True
        return np.eye(4, dtype=np.float32)

    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a),
                               dtype=torch.float32).to(self.device)

    def _load_frames(self, lo: int, hi: int):
        """Frames lo..hi inclusive as stacked device tensors."""
        t0 = time.perf_counter()
        items = [self.dataset[i] for i in range(lo, hi + 1)]
        colors = self._to_dev(np.stack([it[1] for it in items]))
        depths = self._to_dev(np.stack([it[2] for it in items]))
        gts = np.stack([np.asarray(it[3], np.float32) for it in items])
        self.timings["io"] += time.perf_counter() - t0
        return colors, depths, gts

    @staticmethod
    def group_end(cur: int, every_frame: int, n: int) -> int:
        """Last frame of the group starting at `cur`: the next every_frame
        boundary, capped at the final frame."""
        return min(((cur - 1) // every_frame + 1) * every_frame, n - 1)

    # -- mapping -----------------------------------------------------------

    def _map(self, idx, color, depth, mapspec, n_iters, lr_f, ba,
             insert_kf=False, gt_pose=None, coarse_spec=None,
             coarse_iters=0, coarse_lr_factor=1.0, record=True):
        s = self.specs
        st = self.map_state
        st.params, st.grids, losses, sel = mapping_step(
            st.params, st.grids, self.bound, self.store, self.est_c2w_dev,
            idx, color, depth, lr_f, s.camera,
            stage_iters_of(mapspec, n_iters), mapspec, s.render, s.model,
            ba, gen=self.gen, insert_kf=insert_kf,
            gt_pose=(self._to_dev(gt_pose) if insert_kf else None),
            coarse_spec=coarse_spec,
            coarse_stage_iters=(stage_iters_of(coarse_spec, coarse_iters)
                                if coarse_spec is not None else ()),
            coarse_lr_factor=coarse_lr_factor)
        if self.save_selected_kf and record:
            self.selected_keyframes[idx] = sel
        return losses

    def mapping_event(self, idx: int, color, depth, gt_pose,
                      first: bool = False) -> None:
        """One mapping wake-up (Mapper.py:542-657): the mapper (+BA,
        keyframe insertion) and the coarse mapper."""
        t0 = time.perf_counter()
        final = idx == self.n_img - 1
        mapspec = self.specs.mapper
        coarse = self.specs.coarse_mapper
        c_iters = self.iters_first if first else self.iters
        c_lr = self.lr_first_factor if first else self.lr_factor
        if first:
            outer, n_iters, lr_f = 1, self.iters_first, self.lr_first_factor
        elif final and self.color_refine:
            # colour refinement (Mapper.py:579-586): window x2, colour stage
            # only, colour decoder frozen, no frustum selection, 5 passes
            outer, n_iters, lr_f = 5, self.iters, self.lr_factor
            mapspec = replace(mapspec, window_size=mapspec.window_size * 2,
                              middle_iter_ratio=0.0, fine_iter_ratio=0.0,
                              fix_color=True, frustum_selection=False)
        else:
            outer, n_iters, lr_f = 1, self.iters, self.lr_factor

        due = ((idx % self.keyframe_every == 0 or idx >= self.n_img - 2)
               and idx not in self.kf_frame_ids)
        want_insert = due and len(self.kf_frame_ids) < self.store.capacity
        if due and not want_insert and not self._warned_kf_capacity:
            print(f"warning: keyframe store full ({self.store.capacity}) "
                  f"— dropping keyframe {idx} and later ones; raise "
                  "tpu.keyframe_capacity")
            self._warned_kf_capacity = True
        ba = len(self.kf_frame_ids) > 4 and mapspec.ba
        if outer == 1:
            self._map(idx, color, depth, mapspec, n_iters, lr_f, ba,
                      insert_kf=want_insert, gt_pose=gt_pose,
                      coarse_spec=coarse, coarse_iters=c_iters,
                      coarse_lr_factor=c_lr)
        else:
            for _ in range(outer):
                self._map(idx, color, depth, mapspec, n_iters, lr_f, ba)
            # then keyframe insertion and the coarse mapper, in the order
            # of the single-pass event
            if want_insert:
                add_keyframe(self.store, color, depth, self.est_c2w_dev[idx],
                             self._to_dev(gt_pose), idx)
            if coarse is not None:
                self._map(idx, color, depth, coarse, c_iters, c_lr, False,
                          record=False)
        if want_insert:
            self.kf_frame_ids.append(idx)
        self._sync()
        self.timings["map"] += time.perf_counter() - t0

    # -- main loop ---------------------------------------------------------

    def run(self, n_frames: Optional[int] = None, progress: bool = False):
        """Process frames [0, n) with the strict grouped schedule."""
        n = min(n_frames or self.n_img, self.n_img)
        s = self.specs
        bar = None
        if progress:
            try:
                from tqdm import tqdm
                bar = tqdm(total=n, desc="slam")
            except ImportError:
                pass
        colors, depths, gts = self._load_frames(0, 0)
        self.gt_c2w[0] = gts[0]
        self.est_c2w_dev[0] = self._to_dev(self._safe_est_pose(gts[0], 0))
        self.mapping_event(0, colors[0], depths[0], gts[0], first=True)
        self.frames_done = 1
        if bar:
            bar.update(1)
        cur = 1
        while cur < n:
            g_end = self.group_end(cur, self.every_frame, n)
            colors, depths, gts = self._load_frames(cur, g_end)
            self.gt_c2w[cur:g_end + 1] = gts
            t0 = time.perf_counter()
            st = self.map_state
            track_frames_group(
                st.params, st.grids, self.bound, self.est_c2w_dev, cur,
                colors, depths, s.camera, s.track, s.render, s.model,
                gen=self.gen)
            self._sync()
            self.timings["track"] += time.perf_counter() - t0
            if g_end == n - 1 or g_end % self.every_frame == 0:
                self.mapping_event(g_end, colors[-1], depths[-1], gts[-1])
            self.frames_done = g_end + 1
            if bar:
                bar.update(g_end + 1 - cur)
            cur = g_end + 1
        if bar:
            bar.close()
        return self

    def ate(self):
        from nice_slam_torch.utils.trajectory import ate_stats

        n = self.frames_done
        return ate_stats(self.gt_c2w[:n], self.est_c2w[:n])
