"""The SLAM engine of the PyTorch port, on one device.

The reference's three processes (tracker, mapper, coarse mapper) reduce to
a deterministic interleave, as in the JAX package (nice_slam_tpu/engine.py):

    map(0, iters_first x lr_first_factor)
    for idx in 1..n-1: track(idx); map frame idx - map_lag when it lies on
    the every_frame cadence; the last frame maps itself (for NICE the
    colour refinement)

map_lag is 0 under `sync_method: strict`, every_frame // 2 under `loose`
(the reference's bounded lag, Tracker.py:168-175) and every_frame under
`free` (the tracker never waits).  `run()` drives that per-frame loop in
every mode; it is the JAX package's per-frame loop, whose event sequence
its grouped loop reproduces.

Keyframes are inserted every keyframe_every frames and at the last two;
local BA starts once more than four keyframes exist (with
mapping.pose_GN_iters > 0 it ends with Gauss-Newton steps on the window
cameras; tracking.pose_GN_iters polishes each tracked pose the same way).
An occupancy-guided run (rendering.occupancy_guided) keeps an occupancy
proxy among its grids, refreshed after each NICE mapping pass.  iMAP* mode
(`nice: False`) runs each non-first event as three passes of iters // 3,
has no colour refinement and no pretrained decoders.  NICE decoders come
from the repository's npz, else from the reference's ConvONet .pt files
(pretrained_decoders.coarse / middle_fine), else keep their random init.
`stats()` gives each tracked frame's first, last and best tracking loss.
Checkpoints
(<output>/ckpts/{idx:05d}.npz, the JAX package's format) are written every
ckpt_freq frames and at the last frame; `resume()` continues from one.
A `mesher_hook` (utils/mesher.engine_mesher_hook) runs after the
checkpoint every mesh_freq frames and at the last frame.  The trajectory,
the map and the keyframe store stay on the device.

Parallel modes.  In a process group of more than one rank
(parallel/multihost.py) the engine learns its rank and the world size:
rank r runs on cuda:(LOCAL_RANK mod device_count), its mapping is
data-parallel (parallel/data_parallel.py: each rank renders its slice of
the union ray batch, the gradients are summed over the group) or, under
tpu.grid_sharded [n_data, n_model] with n_data x n_model ranks, the NICE
mapper's grids are cut into X-slabs over the `model` ranks and its rays
over the `data` ranks (parallel/grid_sharded.py; the coarse mapper and
iMAP* stay dense on every rank).  Only rank 0 writes checkpoints and
meshes (nice_slam_tpu/engine.py:157-160, 767-772).  World 1 is the dense
path.  tpu.pipelined runs the tracker and the mapper at the same time,
the mapper on a thread of its own (parallel/pipelined.py); its mapping
events read the trajectory, GT poses and frame count handed to them
through `map_side()`.

`enable_visualizer()` draws the reference's debug panels (utils/
visualizer.py) into <output>/tracking_vis and <output>/mapping_vis: per
optimisation iteration at the config's (vis_freq, vis_inside_freq), or
with inside=False one panel a selected frame and mapping event.  Drawing
panels changes no result: a run with them equals one without, bit for
bit.  Their render time counts under the stage 'vis', not 'track' or
'map'.

CUDA graphs.  On a card each optimiser iteration of tracking and of the
mapper is a captured CUDA graph replayed `iters` times (graphs.py: one
runner a side, `_track_graphs` and `_map_graphs`), the counterpart of
the JAX package's jitted `lax.scan` bodies, in NICE and iMAP* mode, with
occupancy-guided sampling and with the panels; so are init_select's
candidate renders and each Gauss-Newton iteration of tracking and BA.
Data-parallel and grid-sharded mapping have collectives inside the step
(gloo all_reduces, which a capture cannot hold): each of their
iterations is a segmented step of the mapping runner, graphs cut at the
collectives, which run eagerly between the replays.  The tracker reads
its own copy of the map (`_params_t`, `_grids_t`, `_bound_t`, the
occupancy proxy among the grids), at addresses that do not move,
refreshed in place when the map changes.  `graph_stats()` reads the
runners.

The JAX package's TPU dispatch knobs (tpu.grouped_tracking, fuse_lagged,
barrier_every_groups, prefetch, fuse_track_map) and tpu.mesh_shape
(run_torch.py reads it to launch local ranks) are accepted and ignored.
"""

from __future__ import annotations

import os
import threading
from dataclasses import replace
from typing import Callable, Optional

import numpy as np
import torch

from nice_slam_torch.config import SlamSpecs, specs_from_config
from nice_slam_torch.graphs import StepGraphs
from nice_slam_torch.keyframes import KeyframeStore, add_keyframe, make_store
from nice_slam_torch.mapping import mapping_step, stage_iters_of
from nice_slam_torch.ops.se3 import cam_from_tensor, to_homogeneous
from nice_slam_torch.ops.tree import tree_leaves, tree_map
from nice_slam_torch.parallel.multihost import rank_device, rank_world
from nice_slam_torch.state import make_map_state
from nice_slam_torch.tracking import track_step
from nice_slam_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from nice_slam_torch.utils.datasets import get_dataset, quantize_color_u8
from nice_slam_torch.utils.profiling import StageTimer


def check_slice(cfg: dict) -> None:
    """Raise ValueError for tpu.pipelined together with tpu.data_parallel
    or tpu.grid_sharded (the JAX pipelined engine refuses any mesh,
    nice_slam_tpu/parallel/pipelined.py:72-76)."""
    tpu = cfg.get("tpu", {})
    for mode in ("data_parallel", "grid_sharded"):
        if tpu.get("pipelined") and tpu.get(mode):
            raise ValueError(
                f"tpu.pipelined and tpu.{mode} are mutually exclusive: "
                "the pipelined engine keeps the map on one device; "
                "the parallel mapping modes spread it over a process group")


def grid_shard_for(cfg: dict, world: int):
    """The GridShard of tpu.grid_sharded [n_data, n_model] in a process
    group of `world` ranks, or None: one process, or n_model 1, maps dense
    with the JAX package's warning (nice_slam_tpu/engine.py:142-151).  A
    group of another size than n_data x n_model raises ValueError (the
    JAX package, which builds its mesh from the devices it sees, has no
    such case)."""
    shape = cfg.get("tpu", {}).get("grid_sharded")
    if not shape:
        return None
    n_data, n_model = int(shape[0]), int(shape[1])
    if world > 1 and world != n_data * n_model:
        raise ValueError(
            f"tpu.grid_sharded={list(shape)} needs {n_data * n_model} "
            f"ranks, the process group has {world}")
    if world == 1 or n_model < 2:
        print(f"warning: tpu.grid_sharded={list(shape)} needs "
              f"{n_data * n_model} devices (have {world}) — running dense")
        return None
    from nice_slam_torch.parallel.grid_sharded import GridShard
    return GridShard(n_data, n_model)


class SlamEngine:
    def __init__(self, cfg: dict, dataset=None, output: Optional[str] = None,
                 device: str = "cuda",
                 mesher_hook: Optional[Callable] = None):
        """Raises for the options `check_slice` names; every model width
        and embedding runs.  mesher_hook(engine, idx, final) runs after a
        mapping event's checkpoint every mesh_freq frames and at the last
        frame, on the primary rank.  In a process group of more than one
        rank, device 'cuda' means this rank's card."""
        check_slice(cfg)
        self.rank, self.world = rank_world()
        self.is_primary = self.rank == 0
        self.device = (rank_device(device, self.rank) if self.world > 1
                       else torch.device(device))
        # the mapping step's parallel hooks (None on one rank):
        # tpu.grid_sharded takes precedence over data-parallel, as in JAX
        self.gs = grid_shard_for(cfg, self.world)
        self.dp = None
        if self.world > 1 and not cfg["tpu"].get("grid_sharded"):
            from nice_slam_torch.parallel.data_parallel import RayShard
            self.dp = RayShard()
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("device='cuda' but no CUDA device; pass "
                                   "device='cpu' to run the plain version")
            # fp32 throughout: TF32 GEMMs feed the ATE tail
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.cfg = cfg
        self.specs: SlamSpecs = specs_from_config(cfg)
        self.dataset = dataset if dataset is not None else get_dataset(cfg)
        self.n_img = len(self.dataset)
        self.output = output or cfg["data"]["output"]
        self.verbose = bool(cfg.get("verbose", False))

        m = cfg["mapping"]
        self.every_frame = m["every_frame"]
        self.keyframe_every = m["keyframe_every"]
        self.ckpt_freq = m["ckpt_freq"]
        self.mesh_freq = m["mesh_freq"]
        self.mesher_hook = mesher_hook
        self.iters = m["iters"]
        self.iters_first = m["iters_first"]
        self.lr_factor = m["lr_factor"]
        self.lr_first_factor = m["lr_first_factor"]
        self.color_refine = m["color_refine"]
        self.gt_camera = bool(cfg["tracking"]["gt_camera"])
        # deterministic lag of the mapper behind the tracker, in frames
        # (nice_slam_tpu/engine.py:104-115)
        sync = cfg.get("sync_method", "strict")
        self.map_lag = {"strict": 0,
                        "loose": self.every_frame // 2,
                        "free": self.every_frame}.get(sync, 0)
        # under a lag: the frames a lagged event still needs
        self._frame_cache = {}
        # per-event selected-window record (save_selected_keyframes_info,
        # reference Mapper.py:274-287): {event idx -> window frame ids}
        self.save_selected_kf = bool(
            m.get("save_selected_keyframes_info", False))
        self.selected_keyframes = {}

        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(cfg["tpu"]["seed"]))
        self.map_state = make_map_state(
            self.gen, self.specs.model, m["bound"], cfg["grid_len"],
            cfg["grid_len"]["bound_divisible"],
            occ_guided=self.specs.render.occ_guided, device=self.device)
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
        # files this rank wrote, by kind (only the primary writes); see
        # count_written
        self.written = {"ckpt": 0, "mesh": 0}
        self._written_lock = threading.Lock()
        # host seconds by stage (the mesher hook adds its parts)
        self.timer = StageTimer()
        self.timings = self.timer.totals
        self.timings.update(track=0.0, map=0.0, ckpt=0.0, io=0.0)
        # per tracked frame: {"idx", "losses"} with the [first, last, best]
        # loss tensor on the device until stats() reads them
        self.tracking_stats: list = []
        # the panels of enable_visualizer: per-iteration visualizers of
        # tracking and mapping, or (inside=False) a per-frame and a
        # per-event hook
        self._track_vis = self._map_vis = None
        self._frame_hook = self._event_hook = None
        # the CUDA graphs of each side's iterations, and the tracker's
        # copy of the map with the map tensors it was copied from
        self._track_graphs = StepGraphs(self.device)
        self._map_graphs = StepGraphs(
            self.device, max_iters=max(self.iters_first, self.iters))
        self._params_t = self._grids_t = self._bound_t = None
        self._track_src: list = []

    def _load_pretrained_decoders(self):
        """NICE decoder weights, in the JAX package's order of sources
        (nice_slam_tpu/engine.py:206-226): the repository's npz when
        present, else the reference's ConvONet checkpoints
        (pretrained_decoders.coarse / middle_fine), else the calibrated
        random init.  iMAP* has no pretrained decoder."""
        if not self.specs.model.nice:
            return
        pt = self.cfg.get("pretrained_decoders", {})
        npz = pt.get("tpu_npz")
        if npz and os.path.exists(npz):
            from nice_slam_torch.models.pretrain import load_npz_decoders
            self.map_state.params = load_npz_decoders(
                npz, self.map_state.params)
            if self.verbose:
                print(f"loaded pretrained decoders from {npz}")
            return
        coarse_p, mf_p = pt.get("coarse"), pt.get("middle_fine")
        if ((coarse_p and os.path.exists(coarse_p))
                or (mf_p and os.path.exists(mf_p))):
            from nice_slam_torch.models.pretrain import (
                load_pretrained_decoders,
            )
            self.map_state.params = load_pretrained_decoders(
                self.map_state.params, self.specs.model, coarse_p, mf_p)
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

    def _sync(self, device=None):
        """Wait for the work this thread has queued on `device`: its
        current stream, not the whole device, whose other streams may hold
        the pipelined engine's other side."""
        device = device or self.device
        if device.type == "cuda":
            torch.cuda.current_stream(device).synchronize()

    def count_written(self, kind: str) -> None:
        """One more file of `kind` written (under a lock: the pipelined
        engine's tracker and mapper both draw panels)."""
        with self._written_lock:
            self.written[kind] = self.written.get(kind, 0) + 1

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

    def _to_dev(self, a: np.ndarray, device=None) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a),
                               dtype=torch.float32).to(device or self.device)

    def _load_frame(self, idx: int):
        """Frame idx: colour and depth on the device, the GT pose on the
        host.  8-bit-native colour (the dataset's transfer_color_uint8)
        crosses to the device as uint8 and is dequantized there, bit-exact
        with the f32 upload for 8-bit sources (the JAX engine's
        _load_frame)."""
        with self.timer.time("io"):
            _, color, depth, gt_pose = self.dataset[idx]
            if getattr(self.dataset, "transfer_color_uint8", False):
                color = torch.from_numpy(quantize_color_u8(color)).to(
                    self.device).float() / 255.0
            else:
                color = self._to_dev(color)
            return (color, self._to_dev(depth),
                    np.asarray(gt_pose, np.float32))

    # -- tracking ----------------------------------------------------------

    def _set_gt_pose(self, idx: int, gt_pose) -> None:
        self.gt_c2w[idx] = gt_pose
        self.est_c2w_dev[idx] = self._to_dev(
            self._safe_est_pose(gt_pose, idx), self.est_c2w_dev.device)

    def _tracking_map(self):
        """(params, grids, bound, generator) the tracker reads: its copy
        of the map, refreshed when a map tensor changed since the last
        copy (the pipelined engine gives its snapshot)."""
        src = self._map_tensors()
        if (len(src) != len(self._track_src)
                or any(a is not b for a, b in zip(src, self._track_src))):
            self._load_track_map(self.device)
        return self._params_t, self._grids_t, self._bound_t, self.gen

    def _map_tensors(self) -> list:
        st = self.map_state
        return tree_leaves(st.params) + list(st.grids.values()) + [st.bound]

    @torch.no_grad()
    def _load_track_map(self, device) -> None:
        """Copy the map into the tracker's copy on `device`, in place when
        the shapes match (a graph reads the copy by address), else into
        new tensors."""
        st = self.map_state
        src = self._map_tensors()
        dst = ([] if self._params_t is None else
               tree_leaves(self._params_t) + list(self._grids_t.values())
               + [self._bound_t])
        if (list(st.grids) == list(self._grids_t or {})
                and [x.shape for x in src] == [x.shape for x in dst]):
            for d, x in zip(dst, src):
                d.copy_(x)
        else:
            def copy(x):
                return x.detach().to(device, copy=True)

            self._params_t = tree_map(copy, st.params)
            self._grids_t = {n: copy(g) for n, g in st.grids.items()}
            self._bound_t = copy(st.bound)
        self._track_src = src

    def graph_stats(self) -> dict:
        """The CUDA-graph runners of tracking and mapping: graphs (of
        them the segments of segmented steps), captures, replays, eager
        steps, host calls between segments, capture seconds."""
        return {"track": self._track_graphs.stats(),
                "map": self._map_graphs.stats()}

    def map_side(self):
        """(trajectory, GT poses, frames tracked) that a mapping event
        reads, refines in place (BA) and checkpoints, and that its mesher
        and panels read: the engine's own (the pipelined engine gives the
        copies its loop handed to the mapper)."""
        return self.est_c2w_dev, self.gt_c2w, self.frames_done

    def track(self, idx: int, color, depth, gt_pose) -> None:
        """Track one frame against the frozen map; frame 0 and
        tracking.gt_camera take the GT pose and skip the optimisation."""
        if idx == 0 or self.gt_camera:
            self._set_gt_pose(idx, gt_pose)
            return
        self.gt_c2w[idx] = gt_pose
        s = self.specs
        params, grids, bound, gen = self._tracking_map()
        vis = self._track_vis
        panels = vis is not None and vis.frame_selected(idx)
        with self.timer.time("track"):
            out = track_step(params, grids, bound, self.est_c2w_dev, idx,
                             color, depth, s.camera, s.track, s.render,
                             s.model, gen=gen, return_cams=panels,
                             graphs=self._track_graphs)
            self._sync(self.est_c2w_dev.device)
        losses, cams = out if panels else (out, None)
        self.tracking_stats.append({"idx": idx, "losses": losses})
        if panels:
            # each selected iteration's pre-step camera against the map
            # the frame was tracked on (src/Tracker.py:230-231)
            for it in range(cams.shape[0]):
                if vis.iter_selected(it):
                    vis.render_panel(
                        self, idx, it, color, depth,
                        to_homogeneous(cam_from_tensor(cams[it])),
                        params=params, grids=grids, bound=bound)

    def stats(self) -> list:
        """One record per tracked frame, {"idx", "first_loss",
        "last_loss", "best_loss"} (the JAX package's engine.py:284-313);
        the losses still on the device come over in one transfer."""
        pending = [s for s in self.tracking_stats if "losses" in s]
        if pending:
            vals = torch.stack([s.pop("losses") for s in pending]).cpu()
            for s, v in zip(pending, vals.tolist()):
                s.update(first_loss=v[0], last_loss=v[1], best_loss=v[2])
        return self.tracking_stats

    # -- mapping -----------------------------------------------------------

    def _map(self, idx, color, depth, mapspec, n_iters, lr_f, ba,
             insert_kf=False, gt_pose=None, coarse_spec=None,
             coarse_iters=0, coarse_lr_factor=1.0, record=True,
             on_iter=None):
        s = self.specs
        st = self.map_state
        st.params, st.grids, losses, sel = mapping_step(
            st.params, st.grids, self.bound, self.store, self.map_side()[0],
            idx, color, depth, lr_f, s.camera,
            stage_iters_of(mapspec, n_iters), mapspec, s.render, s.model,
            ba, gen=self.gen, insert_kf=insert_kf,
            gt_pose=(self._to_dev(gt_pose) if insert_kf else None),
            coarse_spec=coarse_spec,
            coarse_stage_iters=(stage_iters_of(coarse_spec, coarse_iters)
                                if coarse_spec is not None else ()),
            coarse_lr_factor=coarse_lr_factor, dp=self.dp, gs=self.gs,
            on_iter=on_iter, graphs=self._map_graphs)
        if self.save_selected_kf and record:
            self.selected_keyframes[idx] = sel
        return losses

    def mapping_event(self, idx: int, color, depth, gt_pose,
                      first: bool = False) -> None:
        """One mapping wake-up (Mapper.py:542-657): the mapper (+BA,
        keyframe insertion) and the coarse mapper, then the checkpoint when
        one is due."""
        final = idx == self.n_img - 1
        traj, gt_c2w, tracked = self.map_side()
        mapspec = self.specs.mapper
        coarse = self.specs.coarse_mapper
        c_iters = self.iters_first if first else self.iters
        c_lr = self.lr_first_factor if first else self.lr_factor
        if first:
            outer, n_iters, lr_f = 1, self.iters_first, self.lr_first_factor
        elif final and self.color_refine and mapspec.nice:
            # colour refinement (Mapper.py:579-586): window x2, colour stage
            # only, colour decoder frozen, no frustum selection, 5 passes
            outer, n_iters, lr_f = 5, self.iters, self.lr_factor
            mapspec = replace(mapspec, window_size=mapspec.window_size * 2,
                              middle_iter_ratio=0.0, fine_iter_ratio=0.0,
                              fix_color=True, frustum_selection=False)
        elif mapspec.nice:
            outer, n_iters, lr_f = 1, self.iters, self.lr_factor
        else:
            # iMAP*: three passes of iters // 3 (nice_slam_tpu/engine.py:654)
            outer, n_iters, lr_f = 3, max(self.iters // 3, 1), self.lr_factor

        due = ((idx % self.keyframe_every == 0 or idx >= self.n_img - 2)
               and idx not in self.kf_frame_ids)
        want_insert = due and len(self.kf_frame_ids) < self.store.capacity
        if due and not want_insert and not self._warned_kf_capacity:
            print(f"warning: keyframe store full ({self.store.capacity}) "
                  f"— dropping keyframe {idx} and later ones; raise "
                  "tpu.keyframe_capacity")
            self._warned_kf_capacity = True
        ba = len(self.kf_frame_ids) > 4 and mapspec.ba
        with self.timer.time("map"):
            if outer == 1:
                self._map(idx, color, depth, mapspec, n_iters, lr_f, ba,
                          insert_kf=want_insert, gt_pose=gt_pose,
                          coarse_spec=coarse, coarse_iters=c_iters,
                          coarse_lr_factor=c_lr,
                          on_iter=self._map_panels(idx, color, depth, first,
                                                   mapspec))
            else:
                for _ in range(outer):
                    self._map(idx, color, depth, mapspec, n_iters, lr_f, ba)
                # then keyframe insertion and the coarse mapper, in the order
                # of the single-pass event
                if want_insert:
                    add_keyframe(self.store, color, depth, traj[idx],
                                 self._to_dev(gt_pose), idx)
                if coarse is not None:
                    self._map(idx, color, depth, coarse, c_iters, c_lr, False,
                              record=False)
            if want_insert:
                self.kf_frame_ids.append(idx)
            self._sync()
        if self._event_hook is not None:
            self._event_hook(self, idx, color, depth)

        if self.is_primary and (
                (idx % self.ckpt_freq == 0 and idx > 0) or final):
            # every frame up to idx is tracked by now; under strict sync
            # the loop bumps frames_done only after this event
            with self.timer.time("ckpt"):
                self._save(os.path.join(self.output, "ckpts",
                                        f"{idx:05d}.npz"),
                           traj, gt_c2w, max(tracked, idx + 1))
            self.count_written("ckpt")
        if self.mesher_hook is not None and self.is_primary and (
                (idx % self.mesh_freq == 0 and idx > 0) or final):
            self.mesher_hook(self, idx, final)
            self.count_written("mesh")

    def _map_panels(self, idx: int, color, depth, first: bool, mapspec):
        """The on_iter of a single-pass NICE mapping event that draws
        per-iteration panels, else None (JAX engine.py:667-672: frame idx
        selected, and not the first event under
        mapping.no_vis_on_first_frame).  The colour refinement and iMAP*'s
        three passes draw none.  A panel renders from the mid-optimisation
        map at the event's starting pose."""
        vis = self._map_vis
        if (vis is None or not mapspec.nice or not vis.frame_selected(idx)
                or (first and self.cfg["mapping"].get(
                    "no_vis_on_first_frame", True))):
            return None
        c2w = self.map_side()[0][idx].clone()

        def on_iter(it, tree, decode_fn=None):
            if vis.iter_selected(it):
                vis.render_panel(self, idx, it, color, depth, c2w,
                                 params=tree["params"],
                                 grids=None if decode_fn else tree["grids"],
                                 decode_fn=decode_fn)

        return on_iter

    # -- visualiser --------------------------------------------------------

    def enable_visualizer(self, mapping_only: bool = False,
                          inside: bool = True):
        """Draw the residual panels (utils/visualizer.py) into
        <output>/tracking_vis and <output>/mapping_vis, as the JAX
        package's enable_visualizer (nice_slam_tpu/engine.py:776-818).

        inside=True (the reference's semantics, src/utils/
        Visualizer.py:24-107): panels {idx:05d}_{it:04d} PER OPTIMISATION
        ITERATION at the config's (tracking / mapping.vis_freq,
        vis_inside_freq): a selected frame's tracking iterations render
        their pre-step cameras against the frozen map (the pipelined
        engine's snapshot), a selected mapping event's iterations render
        the mid-optimisation map before their step.

        inside=False: one panel (it 0) every tracking.vis_freq-th frame,
        after its mapping event, and one every mapping.vis_freq-th mapping
        event, after it.  mapping_only leaves out the tracking panels.

        Prints one line naming the forms the panels take (npz, and jpg
        where matplotlib imports).  Only the primary rank writes; every
        rank renders."""
        from nice_slam_torch.utils.visualizer import (
            Visualizer,
            make_engine_vis_hook,
            panel_forms,
        )

        t, m = self.cfg["tracking"], self.cfg["mapping"]
        tdir = os.path.join(self.output, "tracking_vis")
        mdir = os.path.join(self.output, "mapping_vis")
        if inside:
            if not mapping_only:
                self._track_vis = Visualizer(
                    tdir, t.get("vis_freq", 50), t.get("vis_inside_freq", 25))
            self._map_vis = Visualizer(
                mdir, m.get("vis_freq", 50), m.get("vis_inside_freq", 25))
        else:
            if not mapping_only:
                self._frame_hook = make_engine_vis_hook(
                    tdir, t.get("vis_freq", 50))
            self._event_hook = make_engine_vis_hook(
                mdir, m.get("vis_freq", 50), by_call_count=True)
        if self.is_primary:
            print(panel_forms([mdir] if mapping_only else [tdir, mdir]))
        return self

    # -- main loop ---------------------------------------------------------

    def run(self, n_frames: Optional[int] = None, progress: bool = False,
            start: Optional[int] = None):
        """Process frames [start, n).  start defaults to frames_done, so a
        resumed engine continues where its checkpoint left off."""
        n = min(n_frames or self.n_img, self.n_img)
        start = self.frames_done if start is None else start
        if start >= n:
            return self
        bar = None
        if progress:
            try:
                from tqdm import tqdm
                bar = tqdm(total=n, initial=start, desc="slam")
            except ImportError:
                pass
        for idx in range(start, n):
            color, depth, gt_pose = self._load_frame(idx)
            if self.map_lag > 0:
                self._frame_cache[idx] = (color, depth, gt_pose)
                for old in [k for k in self._frame_cache
                            if k < idx - self.map_lag - 1]:
                    del self._frame_cache[old]
            if bar:
                bar.update(1)
            if idx == 0:
                self._set_gt_pose(0, gt_pose)
                self.mapping_event(0, color, depth, gt_pose, first=True)
                self.frames_done = 1
                continue
            self.track(idx, color, depth, gt_pose)
            midx = idx - self.map_lag
            if idx == n - 1:
                # the final frame always maps itself
                self.mapping_event(idx, color, depth, gt_pose)
            elif midx > 0 and midx % self.every_frame == 0:
                # a lagged frame from before a resume point is gone: map
                # the current frame in its place (same cadence)
                mc, md, mg = self._frame_cache.get(midx,
                                                   (color, depth, gt_pose))
                self.mapping_event(midx, mc, md, mg)
            if self._frame_hook is not None:
                self._frame_hook(self, idx, color, depth)
            self.frames_done = idx + 1
        if bar:
            bar.close()
        return self

    # -- checkpoints -------------------------------------------------------

    def save(self, path: str) -> None:
        """Write the engine state in the JAX package's checkpoint format
        (nice_slam_tpu/engine.py:1112-1139)."""
        self._save(path, self.est_c2w_dev, self.gt_c2w, self.frames_done)

    def _save(self, path: str, traj, gt_c2w, frames_done: int) -> None:
        """The map and keyframes with the given trajectory, GT poses and
        count of frames done."""
        self._sync()
        extra = {"kf_frame_ids": np.asarray(self.kf_frame_ids, np.int64)}
        if self.selected_keyframes:
            # one row per event, ragged-padded with -2 to the widest window
            # (the colour refinement doubles it)
            ev = sorted(self.selected_keyframes)
            rows = [self.selected_keyframes[i].cpu().numpy().astype(np.int64)
                    for i in ev]
            mat = np.full((len(rows), max(r.shape[0] for r in rows)), -2,
                          np.int64)
            for r_i, r in enumerate(rows):
                mat[r_i, :r.shape[0]] = r
            extra["selkf_event_idx"] = np.asarray(ev, np.int64)
            extra["selkf_frames"] = mat
        save_checkpoint(path, self.map_state.params, self.map_state.grids,
                        self.bound, traj.detach().cpu().numpy(), gt_c2w,
                        self.store, frames_done, extra=extra)

    def resume(self, path: str):
        """Load a checkpoint of either package (engine.py:1141-1167).  The
        random stream is not saved: a resumed run continues the schedule,
        not the draws."""
        ck = load_checkpoint(path, self.map_state.params,
                             self.map_state.grids)

        def dev(a):
            return torch.from_numpy(np.array(a)).to(self.device)

        self.map_state.params = tree_map(dev, ck["params"])
        self.map_state.grids = tree_map(dev, ck["grids"])
        self.est_c2w_dev = dev(ck["est_c2w"]).float()
        self.gt_c2w = np.array(ck["gt_c2w"], np.float32)
        kf = ck["keyframes"]
        if kf:
            self.store = KeyframeStore(
                colors=dev(kf["colors"]), depths=dev(kf["depths"]),
                est_c2w=dev(kf["est_c2w"]), gt_c2w=dev(kf["gt_c2w"]),
                frame_idx=dev(kf["frame_idx"]).long(),
                count=int(kf["count"]))
        extra = ck["extra"]
        self.kf_frame_ids = [int(i) for i in extra["kf_frame_ids"]]
        if "selkf_event_idx" in extra:
            self.selected_keyframes = {
                int(i): dev(row) for i, row in
                zip(extra["selkf_event_idx"], extra["selkf_frames"])}
        self.frames_done = ck["idx"]
        return self

    def ate(self):
        from nice_slam_torch.utils.trajectory import ate_stats

        n = self.frames_done
        return ate_stats(self.gt_c2w[:n], self.est_c2w[:n])
