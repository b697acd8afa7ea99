"""The port's parallel modes (nice_slam_torch/parallel/) on the CPU.

- Data-parallel mapping over gloo, 2 ranks in subprocesses: one
  `dp_map_optimize` call of 3 iterations (middle, fine, colour) with BA
  and 2 Gauss-Newton iterations, on given union pixels, equals one process
  running `map_optimize` on the union (twice the pixels, on the same
  generator stream): relative Frobenius error <= 1e-5 per leaf; and the
  mirror of the JAX package's test_dp_losses_scale_with_devices
  (tests/test_parallel.py:81).
- A 2-process `run_torch.py --device cpu` run (tpu.data_parallel,
  mesh_shape [2]) of 6 frames: the ranks' trajectories and maps are
  bit-equal, the ATE is under 0.25 m and only rank 0 wrote files.
- The pipelined engine's schedule against the JAX PipelinedSlamEngine's on
  stubbed engines (JAX on two virtual CPU devices, the port on one), and a
  real degraded run: ATE < 0.5 m (tests/test_parallel.py:159) with the
  tracker's snapshot never sharing storage with the mapper's state.
- multihost: initialize_from_cfg is a no-op without a config, and the
  backend on the CPU is gloo.

Run as a script, this file is one rank of the data-parallel check
(`--dp-rank R --port P --out FILE`).
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nice_slam_torch import mapping  # noqa: E402
from nice_slam_torch.config import load_config, specs_from_config  # noqa: E402
from nice_slam_torch.engine import SlamEngine  # noqa: E402
from nice_slam_torch.keyframes import add_keyframe, make_store  # noqa: E402
from nice_slam_torch.models.decoders import ModelSpec  # noqa: E402
from nice_slam_torch.ops.tree import tree_leaves  # noqa: E402
from nice_slam_torch.parallel import multihost  # noqa: E402
from nice_slam_torch.parallel.pipelined import PipelinedSlamEngine  # noqa: E402
from nice_slam_torch.parallel.schur_ba import window_pixels  # noqa: E402
from nice_slam_torch.state import make_map_state  # noqa: E402
from nice_slam_torch.utils.datasets import get_dataset  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRID_LEN = {"coarse": 1.0, "middle": 0.32, "fine": 0.16, "color": 0.16,
            "bound_divisible": 0.32}
BOUND = [[-0.5, 4.5], [-0.5, 3.5], [-0.5, 4.5]]
WORLD = 2
RANK_PIXELS = 48          # a rank's mapping budget: 16 a window frame
RANK_GN_PIXELS = 16       # a rank's GN rays a window frame
STAGES = (("middle", 1), ("fine", 1), ("color", 1))


# ---------------------------------------------------------------------------
# Data-parallel mapping: the union identity

def _dp_setup():
    """A 3-frame window of the synthetic scene (keyframes 0 and 3, current
    frame 6, GT poses), its frustum masks and BA mask, on the CPU."""
    cfg = load_config(overrides={
        "dataset": "synthetic", "synthetic": {"n_frames": 7},
        "cam": {"H": 30, "W": 40, "fx": 30.0, "fy": 30.0, "cx": 19.5,
                "cy": 14.5, "crop_edge": 0},
        "grid_len": GRID_LEN,
        "mapping": {"bound": BOUND, "pixels": RANK_PIXELS,
                    "mapping_window_size": 3},
        "rendering": {"N_samples": 8, "N_surface": 4}})
    specs = specs_from_config(cfg)
    cam = specs.camera
    ds = get_dataset(cfg)
    state = make_map_state(torch.Generator().manual_seed(0), ModelSpec(),
                           BOUND, GRID_LEN, 0.32, device="cpu")
    store = make_store(4, cam.H, cam.W, device="cpu")
    frames = {}
    for k in (0, 3, 6):
        _, c, d, p = ds[k]
        frames[k] = (torch.as_tensor(c), torch.as_tensor(d),
                     torch.as_tensor(np.asarray(p, np.float32)))
    for k in (0, 3):
        c, d, p = frames[k]
        add_keyframe(store, c, d, p, p, k)
    c, d, p = frames[6]
    mapspec = dataclasses.replace(specs.mapper, pose_gn_iters=2,
                                  pose_gn_pixels=RANK_GN_PIXELS)
    window, masks, cams0, lr_mask = mapping.prepare_mapping(
        store, c, d, p, state.grids, state.bound, cam, mapspec, True,
        gen=torch.Generator().manual_seed(1),
        mask_names=mapping._trained_grids(mapspec, STAGES))
    # move the BA cameras off GT, so that Adam and GN have work to do
    cams0 = cams0 + 0.01 * torch.randn(
        cams0.shape, generator=torch.Generator().manual_seed(4))
    wn = window["colors"].shape[0]
    g = torch.Generator().manual_seed(2)
    pixels = [window_pixels(g, wn, WORLD * (RANK_PIXELS // wn), cam, "cpu")
              for _ in range(3)]
    return specs, state, window, masks, cams0, lr_mask, mapspec, pixels


def _flat(params, grids, cams, losses) -> dict:
    out = {f"leaf{k}": x.detach().numpy()
           for k, x in enumerate(tree_leaves(params) + tree_leaves(grids))}
    out["cams"] = cams.detach().numpy()
    out["losses"] = losses.detach().numpy()
    return out


def dp_rank_main(rank: int, port: int, out: str) -> None:
    """One rank: the union-identity call and the loss-scale call."""
    from nice_slam_torch.parallel.data_parallel import (
        RayShard,
        dp_map_optimize,
    )

    torch.set_num_threads(1)
    multihost.initialize(f"127.0.0.1:{port}", WORLD, rank, timeout_s=60,
                         device="cpu")
    specs, state, window, masks, cams0, lr_mask, mapspec, pixels = \
        _dp_setup()
    res = dp_map_optimize(
        state.params, state.grids, state.bound, window, cams0, masks,
        lr_mask, 1.0, specs.camera, STAGES, mapspec, specs.render,
        specs.model, RayShard(), ba=True,
        gen=torch.Generator().manual_seed(3), pixels=pixels)
    saved = _flat(*res)
    # one middle iteration on drawn pixels, for the loss scale
    _, _, _, loss = dp_map_optimize(
        state.params, state.grids, state.bound, window, cams0, masks,
        lr_mask, 1.0, specs.camera, (("middle", 1),), specs.mapper,
        specs.render, specs.model, RayShard(), ba=False,
        gen=torch.Generator().manual_seed(5))
    saved["scale_loss"] = loss.numpy()
    saved["backend"] = np.array(multihost.backend())
    np.savez(out, **saved)
    multihost.shutdown()


@pytest.fixture(scope="module")
def dp_ranks(tmp_path_factory):
    """Run the 2 ranks as subprocesses; returns each rank's arrays."""
    d = tmp_path_factory.mktemp("dp")
    port = multihost.free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--dp-rank", str(r),
         "--port", str(port), "--out", str(d / f"rank{r}.npz")],
        cwd=REPO, env={**os.environ, "PYTHONPATH": REPO,
                       "OMP_NUM_THREADS": "1"},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    logs = [p.communicate(timeout=240)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    out = []
    for r in range(WORLD):
        with np.load(d / f"rank{r}.npz") as z:
            out.append({k: z[k] for k in z.files})
    return out


def test_dp_step_equals_one_process_on_the_union(dp_ranks):
    specs, state, window, masks, cams0, lr_mask, mapspec, pixels = \
        _dp_setup()
    union = dataclasses.replace(mapspec, pixels=WORLD * RANK_PIXELS,
                                pose_gn_pixels=WORLD * RANK_GN_PIXELS)
    want = _flat(*mapping.map_optimize(
        state.params, state.grids, state.bound, window, cams0, masks,
        lr_mask, 1.0, specs.camera, STAGES, union, specs.render,
        specs.model, ba=True, gen=torch.Generator().manual_seed(3),
        pixels=pixels))
    before = _flat(state.params, state.grids, cams0, torch.zeros(3))
    moved = [k for k in want if k != "losses"
             and not np.array_equal(want[k], before[k])]
    # the staged Adam moved the grids, the colour decoder and the cameras
    assert "cams" in moved and len(moved) >= 5, moved
    for rank in dp_ranks:
        assert str(rank["backend"]) == "gloo"
        for k, w in want.items():
            err = np.linalg.norm(rank[k] - w) / max(np.linalg.norm(w),
                                                     1e-30)
            assert err <= 1e-5, (k, err)
    # the ranks end bit-equal
    for k in want:
        assert np.array_equal(dp_ranks[0][k], dp_ranks[1][k]), k


def test_world_one_shard_is_the_local_step():
    """Without a process group a RayShard is world 1: the hook's draws and
    reduce leave map_optimize bit-equal to the step without it."""
    from nice_slam_torch.parallel.data_parallel import RayShard

    specs, state, window, masks, cams0, lr_mask, mapspec, pixels = \
        _dp_setup()
    shard = RayShard()
    assert (shard.rank, shard.world) == (0, 1)
    out = [_flat(*mapping.map_optimize(
        state.params, state.grids, state.bound, window, cams0, masks,
        lr_mask, 1.0, specs.camera, STAGES, mapspec, specs.render,
        specs.model, ba=True, gen=torch.Generator().manual_seed(3),
        shard=s)) for s in (None, shard)]
    for k in out[0]:
        assert np.array_equal(out[0][k], out[1][k]), k
    assert shard.calls == {"middle": 1, "fine": 1, "color": 1, "gn": 4}
    assert shard.stats()["iters"]["gn"] == 2 and shard.seconds == 0.0


def _imap_window():
    """An iMAP* window (keyframe 0, current frame 3) at a small width."""
    cfg = load_config(nice=False, overrides={
        "dataset": "synthetic", "synthetic": {"n_frames": 4},
        "cam": {"H": 12, "W": 16, "fx": 12.0, "fy": 12.0, "cx": 7.5,
                "cy": 5.5, "crop_edge": 0},
        "mapping": {"bound": BOUND, "pixels": 16, "mapping_window_size": 3},
        "rendering": {"N_samples": 4, "N_importance": 2}})
    specs = specs_from_config(cfg)
    cam = specs.camera
    ds = get_dataset(cfg)
    state = make_map_state(torch.Generator().manual_seed(0), specs.model,
                           BOUND, GRID_LEN, 0.32, device="cpu")
    store = make_store(2, cam.H, cam.W, device="cpu")
    _, c, d, p = ds[0]
    add_keyframe(store, torch.as_tensor(c), torch.as_tensor(d),
                 torch.as_tensor(np.asarray(p, np.float32)),
                 torch.as_tensor(np.asarray(p, np.float32)), 0)
    _, c, d, p = ds[3]
    window, masks, cams0, lr_mask = mapping.prepare_mapping(
        store, torch.as_tensor(c), torch.as_tensor(d),
        torch.as_tensor(np.asarray(p, np.float32)), state.grids, state.bound,
        cam, specs.mapper, True, gen=torch.Generator().manual_seed(1))
    return specs, state, window, masks, cams0, lr_mask


@pytest.mark.parametrize("case", ["nice_grad_clip", "imap_steplr"])
def test_dp_step_has_no_clip_and_no_steplr(case, monkeypatch):
    """The data-parallel step takes the JAX DP step's arithmetic
    (nice_slam_tpu/parallel/data_parallel.py:92-101): no grad_clip and no
    iMAP* StepLR, at world 1 too.  NICE with grad_clip 0.01: equal bit for
    bit to the local step without the clip, and not to the local step
    with it.  iMAP*: equal to the local step with StepLR(200, 0.8)'s scale
    pinned to 1, and the scale never asked for (the local step asks at
    every Adam step; past step 200 it would be 0.8)."""
    from nice_slam_torch.parallel.data_parallel import (
        RayShard,
        dp_map_optimize,
    )

    if case == "nice_grad_clip":
        specs, state, window, masks, cams0, lr_mask, mapspec, _ = \
            _dp_setup()
        mapspec = dataclasses.replace(mapspec, pose_gn_iters=0)
        stages, jax_spec = STAGES, mapspec
        mapspec = dataclasses.replace(mapspec, grad_clip=0.01)
    else:
        specs, state, window, masks, cams0, lr_mask = _imap_window()
        mapspec = jax_spec = specs.mapper
        stages = (("color", 3),)
    scales = []
    monkeypatch.setattr(mapping, "imap_lr_scale",
                        lambda step: scales.append(step) or 1.0)

    def run(fn, spec, **kw):
        return _flat(*fn(state.params, state.grids, state.bound, window,
                         cams0, masks, lr_mask, 1.0, specs.camera, stages,
                         spec, specs.render, specs.model, ba=True,
                         gen=torch.Generator().manual_seed(3), **kw))

    dp = run(dp_map_optimize, mapspec, shard=RayShard())
    assert scales == []
    jax_arith = run(mapping.map_optimize, jax_spec)
    for k in dp:
        assert np.array_equal(dp[k], jax_arith[k]), k
    if case == "nice_grad_clip":
        local = run(mapping.map_optimize, mapspec)
        assert not all(np.array_equal(dp[k], local[k]) for k in dp)
    else:
        # the local step asks for the scale at every Adam step
        assert scales == [0, 1, 2]


def test_dp_losses_scale_with_devices(dp_ranks):
    """tests/test_parallel.py:81 on the port: the loss is summed over the
    ranks, each with `pixels` rays, so it is about world x one rank's."""
    specs, state, window, masks, cams0, lr_mask, _, _ = _dp_setup()
    _, _, _, local = mapping.map_optimize(
        state.params, state.grids, state.bound, window, cams0, masks,
        lr_mask, 1.0, specs.camera, (("middle", 1),), specs.mapper,
        specs.render, specs.model, ba=False,
        gen=torch.Generator().manual_seed(5))
    ratio = float(dp_ranks[0]["scale_loss"][0] / local[0])
    assert 0.3 * WORLD < ratio < 3.0 * WORLD, ratio


# ---------------------------------------------------------------------------
# A 2-process run through run_torch.py

def _summaries(stdout: str) -> list:
    dec = json.JSONDecoder()
    out, k = [], stdout.find("{\n")
    while k >= 0:
        obj, end = dec.raw_decode(stdout, k)
        out.append(obj)
        k = stdout.find("{\n", end)
    return out


def test_two_process_run_torch(tmp_path):
    import yaml

    out = tmp_path / "out"
    cfg = tmp_path / "dp.yaml"
    cfg.write_text(yaml.safe_dump({
        "inherit_from": os.path.join(REPO, "configs", "Synthetic",
                                     "synthetic.yaml"),
        "synthetic": {"n_frames": 6},
        "cam": {"H": 40, "W": 52, "fx": 40.0, "fy": 40.0, "cx": 25.5,
                "cy": 19.5, "crop_edge": 0},
        "grid_len": GRID_LEN,
        "mapping": {"bound": BOUND, "every_frame": 3, "iters_first": 30,
                    "iters": 8, "pixels": 96, "mapping_window_size": 3,
                    "keyframe_every": 3, "ckpt_freq": 3,
                    "color_refine": False},
        "tracking": {"iters": 4, "pixels": 64, "ignore_edge_W": 4,
                     "ignore_edge_H": 4},
        "rendering": {"N_samples": 10, "N_surface": 5},
        "meshing": {"resolution": 16},
        "tpu": {"seed": 0, "data_parallel": True, "mesh_shape": [2]},
        "data": {"output": str(out)}}))
    r = subprocess.run([sys.executable, "run_torch.py", str(cfg),
                        "--device", "cpu"], cwd=REPO, capture_output=True,
                       text=True, timeout=300,
                       env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert r.returncode == 0, r.stderr[-3000:]
    ranks = sorted(_summaries(r.stdout), key=lambda s: s["rank"])
    assert [s["rank"] for s in ranks] == [0, 1]
    assert all(s["world"] == 2 and s["backend"] == "gloo" for s in ranks)
    assert ranks[0]["traj_sha256"] == ranks[1]["traj_sha256"]
    assert ranks[0]["map_sha256"] == ranks[1]["map_sha256"]
    assert ranks[0]["frames"] == 6
    assert np.isfinite(ranks[0]["ate_rmse_m"])
    assert ranks[0]["ate_rmse_m"] < 0.25
    assert ranks[0]["written"] == {"ckpt": 2, "mesh": 1, "ate": 1}
    assert ranks[1]["written"] == {"ckpt": 0, "mesh": 0}
    assert ranks[0]["allreduce"]["iters"]["color"] > 0
    assert sorted(os.listdir(out / "ckpts")) == ["00003.npz", "00005.npz"]


# ---------------------------------------------------------------------------
# The pipelined engine

def _pipe_overrides(n_frames=13, every=4):
    return {"dataset": "synthetic", "synthetic": {"n_frames": n_frames},
            "cam": {"H": 24, "W": 32, "fx": 24.0, "fy": 24.0, "cx": 15.5,
                    "cy": 11.5, "crop_edge": 0},
            "grid_len": GRID_LEN,
            "mapping": {"bound": BOUND, "every_frame": every,
                        "keyframe_every": every, "ckpt_freq": 10000,
                        "mesh_freq": 10000, "color_refine": False},
            "tracking": {"iters": 2, "pixels": 40},
            "tpu": {"seed": 0}}


def _pipe_recorder(eng, poses, events):
    def frame_of(gt_pose):
        return int(np.argmin(np.abs(poses - np.asarray(gt_pose)).sum((1, 2))))

    def track(idx, *a, **k):
        events.append(("track", idx))

    def track_group(cur, g_end, *a, **k):
        events.extend(("track", i) for i in range(cur, g_end + 1))
        return np.float32(0.0)

    def snapshot(idx):
        events.append(("snap", idx))

    def mapping_event(idx, color, depth, gt_pose, *a, **k):
        events.append(("map", idx, frame_of(gt_pose)))

    eng.track, eng._track_group = track, track_group
    eng._snapshot, eng.mapping_event = snapshot, mapping_event


@pytest.mark.parametrize("every", [4, 5])
def test_pipelined_schedule_equals_jax(every, tmp_path):
    import jax

    from nice_slam_tpu.config import load_config as jax_load_config
    from nice_slam_tpu.parallel.pipelined import (
        PipelinedSlamEngine as JaxPipelined,
    )

    got = {}
    for pkg in ("jax", "torch"):
        if pkg == "jax":
            eng = JaxPipelined(jax_load_config(overrides=_pipe_overrides(
                every=every)), output=str(tmp_path / pkg),
                devices=jax.devices()[:2])
            assert eng.dev_track != eng.dev_map
        else:
            eng = PipelinedSlamEngine(load_config(overrides=_pipe_overrides(
                every=every)), output=str(tmp_path / pkg), device="cpu")
            assert eng.dev_track == eng.dev_map
        ds = eng.dataset
        poses = np.stack([np.asarray(ds[i][3]) for i in range(len(ds))])
        events = []
        _pipe_recorder(eng, poses, events)
        eng.run()
        got[pkg] = events
        assert eng.frames_done == 13
    assert got["torch"] == got["jax"], got
    # one event of lag: frames 1..2*every are tracked before event every's
    # map is pulled
    assert got["torch"].index(("snap", every)) > got["torch"].index(
        ("track", 2 * every))


def _storages(tree) -> set:
    return {x.untyped_storage().data_ptr() for x in tree_leaves(tree)}


def test_pipelined_degraded_run(tmp_path):
    """tests/test_parallel.py:129-159 on one device: the run stays on the
    trajectory, and at every mapping event the tracker's snapshot and
    trajectory share no storage with the mapper's map and trajectory."""
    cfg = load_config(overrides={
        "dataset": "synthetic", "synthetic": {"n_frames": 9},
        "cam": {"H": 48, "W": 64, "fx": 48.0, "fy": 48.0, "cx": 31.5,
                "cy": 23.5, "crop_edge": 0},
        "grid_len": GRID_LEN,
        "mapping": {"bound": BOUND, "every_frame": 3, "iters_first": 60,
                    "iters": 12, "pixels": 200, "mapping_window_size": 3,
                    "keyframe_every": 3, "ckpt_freq": 10000,
                    "mesh_freq": 10000, "color_refine": False},
        "tracking": {"iters": 6, "pixels": 100, "ignore_edge_W": 4,
                     "ignore_edge_H": 4},
        "rendering": {"N_samples": 14, "N_surface": 7},
        "tpu": {"seed": 0, "pipelined": True}})
    eng = PipelinedSlamEngine(cfg, output=str(tmp_path), device="cpu")
    assert eng.dev_track == eng.dev_map
    shared = []
    orig = SlamEngine.mapping_event

    def checked(self, idx, *a, **k):
        st = self.map_state
        mine = (_storages(st.params) | _storages(st.grids)
                | {self.est_c2w_dev.untyped_storage().data_ptr(),
                   self.store.est_c2w.untyped_storage().data_ptr()})
        theirs = (_storages(self._params_t) | _storages(self._grids_t)
                  | {self._bound_t.untyped_storage().data_ptr()})
        shared.append(bool(mine & theirs))
        return orig(self, idx, *a, **k)

    SlamEngine.mapping_event = checked
    try:
        eng.run()
    finally:
        SlamEngine.mapping_event = orig
    assert shared == [False] * 4, shared
    assert eng.frames_done == 9
    assert np.isfinite(eng.est_c2w[:9]).all()
    rmse = eng.ate()["rmse"]
    assert np.isfinite(rmse) and rmse < 0.5, rmse
    assert len(eng.kf_frame_ids) >= 3


def test_pipelined_refuses_data_parallel():
    from nice_slam_torch.engine import check_slice

    with pytest.raises(ValueError):
        check_slice(load_config(overrides={
            "tpu": {"pipelined": True, "data_parallel": True}}))


# ---------------------------------------------------------------------------
# multihost

def test_initialize_from_cfg_noop_without_config(monkeypatch):
    for k in (multihost.ENV_COORDINATOR, multihost.ENV_NUM_PROCESSES,
              multihost.ENV_PROCESS_ID):
        monkeypatch.delenv(k, raising=False)
    assert multihost.initialize_from_cfg({"tpu": {}}) is None
    assert multihost.initialize_from_cfg(
        {"tpu": {"multihost": {"num_processes": 1}}}) is None
    assert multihost.rank_world() == (0, 1) and multihost.is_primary()
    assert multihost.backend() is None


def test_backend_on_the_cpu_is_gloo():
    import torch.distributed as dist

    store = dist.HashStore()
    assert multihost.choose_backend(store, 0, 1,
                                    torch.device("cpu")) == "gloo"
    assert multihost.rank_device("cpu", 3) == torch.device("cpu")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--dp-rank", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--out", required=True)
    a = ap.parse_args()
    dp_rank_main(a.dp_rank, a.port, a.out)
