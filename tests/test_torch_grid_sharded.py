"""Grid-sharded mapping of the port (nice_slam_torch/parallel/
grid_sharded.py) on the CPU, held against the JAX package's module
(tests/test_grid_sharded.py runs it on the conftest's 8 virtual CPU
devices) and against the port's own dense step.

- Slab layout: the shard round trip for 2, 3 and 4 shards and the halo
  row equal the JAX functions' bit for bit.
- Slab interpolation: each shard's part within 1e-6 of JAX `slab_interp`;
  their sum equals the port's dense `trilinear_interp` bit for bit and
  the JAX dense interpolation within 1e-6.
- The sharded decode: one process's sum of 4 shards through
  `model_apply_feats` against JAX `gs_eval_points` on a [2, 4] mesh,
  stages middle, fine and colour, atol 2e-4 (JAX's own test's), and bit
  for bit against the port's `eval_points`.
- The feature sum's backward is the identity and the points' cotangent is
  summed (on a stand-in for n identical model ranks, exact).
- The step: at [1, 1] it equals the dense `map_optimize` bit for bit; each
  difference of the JAX gs step from JAX `map_optimize` (no Gauss-Newton,
  no grad_clip, no occupancy proxy, cameras live whatever `ba`) leaves the
  gs step bit-equal while it moves the dense step.
- Routing: only the NICE mapper goes through `gs_map_once`; a lone
  process and n_model 1 map dense; a mismatched world size raises.
- Four ranks over gloo in subprocesses ([2, 2]): the sharded query
  `gs_eval_points` against the dense `eval_points` (atol 1e-6); one
  mapping call on given union pixels against one dense process on the
  union (losses 1e-6 relative, every leaf 1e-5 relative Frobenius), the
  halo invariant bit
  for bit after every step, the middle loss falling on fixed pixels, the
  ranks bit-equal; and a 9-frame `run_torch.py --device cpu` run: ATE
  under 0.25 m, ranks bit-equal, only rank 0 writes.

Run as a script, this file is one rank of the [2, 2] check
(`--gs-rank R --port P --out FILE`).
"""

import argparse
import dataclasses
import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nice_slam_torch import mapping  # noqa: E402
from nice_slam_torch.config import load_config, specs_from_config  # noqa: E402
from nice_slam_torch.keyframes import add_keyframe, make_store  # noqa: E402
from nice_slam_torch.models.decoders import ModelSpec  # noqa: E402
from nice_slam_torch.ops.grid import trilinear_interp  # noqa: E402
from nice_slam_torch.ops.tree import tree_leaves  # noqa: E402
from nice_slam_torch.parallel import grid_sharded as gsm  # noqa: E402
from nice_slam_torch.parallel import multihost  # noqa: E402
from nice_slam_torch.parallel.schur_ba import window_pixels  # noqa: E402
from nice_slam_torch.state import make_map_state  # noqa: E402
from nice_slam_torch.utils.datasets import get_dataset  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRID_LEN = {"coarse": 1.0, "middle": 0.32, "fine": 0.16, "color": 0.16,
            "bound_divisible": 0.32}
ROOM = [[-0.5, 4.5], [-0.5, 3.5], [-0.5, 4.5]]
SHAPE = (2, 2)            # [n_data, n_model] of the multi-process check
RANK_PIXELS = 48          # a data rank's mapping budget: 16 a window frame
STAGES = (("middle", 3), ("fine", 1), ("color", 2))


def n(x):
    return x.detach().cpu().numpy()


def _communicate(procs, timeout):
    """Wait for `procs` (each started in a session of its own) for at most
    `timeout` seconds in all; on a hang, kill every process group and
    fail this test."""
    try:
        return [p.communicate(timeout=timeout)[0] for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        pytest.fail(f"a rank hung for {timeout} s")


# ---------------------------------------------------------------------------
# Slab layout and interpolation against the JAX package

@pytest.fixture(scope="module")
def jax_state():
    """Decoders, grids and bound as numpy arrays, the same for both
    packages: the grids of tests/test_grid_sharded.py's scene ([-2, 2]^3,
    middle 0.32, fine and colour 0.16) drawn from a numpy seed, the
    decoders of the port's init (the packages share the tree layout)."""
    from nice_slam_torch.convert import params_to_numpy
    from nice_slam_torch.models.decoders import init_model

    rng = np.random.RandomState(0)
    grids = {"coarse": (4, 4, 4), "middle": (13, 13, 13),
             "fine": (26, 26, 26), "color": (26, 26, 26)}
    grids = {k: (0.1 * rng.randn(*s, 32)).astype(np.float32)
             for k, s in grids.items()}
    params = params_to_numpy(init_model(torch.Generator().manual_seed(0),
                                        ModelSpec(), device="cpu"))
    return params, grids, np.array([[-2.0, 2.0]] * 3, np.float32)


@pytest.mark.parametrize("n_shards", [2, 3, 4])
def test_shard_roundtrip_equals_jax(jax_state, n_shards):
    from nice_slam_tpu.parallel import grid_sharded as jgs

    g = jax_state[1]["fine"]
    slabs = gsm.shard_grid_x(torch.tensor(g), n_shards)
    np.testing.assert_array_equal(n(slabs),
                                  np.asarray(jgs.shard_grid_x(g, n_shards)))
    np.testing.assert_array_equal(n(gsm.unshard_grid_x(slabs, g.shape[0])),
                                  g)
    for s in range(n_shards):
        assert torch.equal(gsm.own_slab(torch.tensor(g), n_shards, s),
                           slabs[s])


def test_halo_is_neighbour_first_row(jax_state):
    slabs = gsm.shard_grid_x(torch.tensor(jax_state[1]["middle"]), 4)
    for s in range(3):
        assert torch.equal(slabs[s, -1], slabs[s + 1, 0])


def test_slab_interp_matches_jax_and_sums_to_dense(jax_state):
    """Per shard against JAX slab_interp (atol 1e-6); the sum over shards
    equals the port's dense interpolation bit for bit, JAX's within
    1e-6."""
    from nice_slam_tpu.ops.grid import trilinear_interp as jax_interp
    from nice_slam_tpu.parallel import grid_sharded as jgs

    g = jax_state[1]["fine"]
    p = np.random.RandomState(1).uniform(-1.1, 1.1, (300, 3)).astype(
        np.float32)
    slabs_j = jgs.shard_grid_x(g, 4)
    slabs = gsm.shard_grid_x(torch.tensor(g), 4)
    sx = slabs.shape[1] - 1
    parts = []
    for s in range(4):
        got = gsm.slab_interp(slabs[s], torch.tensor(p), g.shape[:3], s, sx)
        want = jgs.slab_interp(slabs_j[s], p, g.shape[:3], s, sx)
        np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-6)
        parts.append(got)
    total = sum(parts)
    assert torch.equal(total, trilinear_interp(torch.tensor(g),
                                               torch.tensor(p)))
    np.testing.assert_allclose(n(total), np.asarray(jax_interp(g, p)),
                               atol=1e-6)


def _sum_of_shards_decode(params, grids, bound, pts, stage, n_model):
    """One process's sharded decode: every model shard's slab_interp
    summed, then model_apply_feats and the out-of-AABB forcing."""
    from nice_slam_torch.models.decoders import (
        model_apply_feats,
        stage_levels,
    )
    from nice_slam_torch.ops.grid import normalize_coords

    p_nor = normalize_coords(pts, bound)
    feats = {}
    for name in stage_levels(stage):
        slabs = gsm.shard_grid_x(grids[name], n_model)
        sx = slabs.shape[1] - 1
        feats[name] = sum(gsm.slab_interp(slabs[s], p_nor,
                                          grids[name].shape[:3], s, sx)
                          for s in range(n_model))
    raw = model_apply_feats(params, ModelSpec(), pts, feats, stage)
    inside = torch.all((pts > bound[:, 0]) & (pts < bound[:, 1]), dim=-1)
    occ = torch.where(inside, raw[..., 3], torch.full_like(raw[..., 3], 100.0))
    return torch.cat([raw[..., :3], occ[..., None]], dim=-1)


@pytest.mark.parametrize("stage", ["middle", "fine", "color"])
def test_sharded_decode_matches_jax_gs_eval_points(jax_state, stage):
    """The sum of 4 shards through model_apply_feats against JAX
    gs_eval_points on a [2, 4] mesh (atol 2e-4, as
    tests/test_grid_sharded.py), and bit for bit against the port's
    dense eval_points."""
    import jax

    from nice_slam_tpu.models.decoders import nice_model_spec
    from nice_slam_tpu.parallel import grid_sharded as jgs

    from nice_slam_torch.convert import params_from_jax
    from nice_slam_torch.render import eval_points

    params_np, grids_np, bound_np = jax_state
    pts = np.random.RandomState(2).uniform(-2.5, 2.5, (256, 3)).astype(
        np.float32)
    mesh = jgs.make_mesh_2d(2, 4)
    slabs_j, shapes = jgs.shard_grids(grids_np, 4, mesh)
    # jitted: eager shard_map takes tens of seconds a stage on the CPU
    want = jax.jit(lambda p_, s_, b_, x_: jgs.gs_eval_points(
        p_, nice_model_spec(), s_, b_, shapes, x_, stage, mesh))(
        params_np, slabs_j, bound_np, pts)
    params = params_from_jax(params_np, device="cpu")
    grids = {k: torch.tensor(v) for k, v in grids_np.items()}
    bound, pts_t = torch.tensor(bound_np), torch.tensor(pts)
    with torch.no_grad():
        got = _sum_of_shards_decode(params, grids, bound, pts_t, stage, 4)
        dense = eval_points(params, ModelSpec(), grids, bound, pts_t, stage)
    np.testing.assert_allclose(n(got), np.asarray(jax.device_get(want)),
                               atol=2e-4)
    assert torch.equal(got, dense)


class _Replicas:
    """A stand-in for n_model identical model ranks: their all_reduce(SUM)
    of a replicated value is n times it."""

    def __init__(self, n_model):
        self.n_model = n_model

    def model_sum_(self, t, kind, stage):
        return t.mul_(self.n_model)


def test_feature_sum_backward_is_identity():
    """_ModelSum's backward hands the cotangent on unchanged (a backward
    that all_reduced it would give n_model x); _ModelBroadcast's backward
    sums the points' cotangent over the model ranks.  Exact."""
    rep = _Replicas(3)
    x = torch.randn(7, 4, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    w = torch.randn(7, 4, generator=torch.Generator().manual_seed(1))
    y = gsm._ModelSum.apply(x, rep, "color")
    assert torch.equal(y, x.detach() * 3)
    (gx,) = torch.autograd.grad((y * w).sum(), x)
    assert torch.equal(gx, w)
    q = gsm._ModelBroadcast.apply(x, rep, "color")
    assert torch.equal(q, x.detach())
    (gq,) = torch.autograd.grad((q * w).sum(), x)
    assert torch.equal(gq, w * 3)


# ---------------------------------------------------------------------------
# The step on one process

def _window(H=30, W=40):
    """A 3-frame window of the synthetic scene (keyframes 0 and 3, current
    frame 6, GT poses; the BA cameras then moved by 1 cm), its frustum
    masks and BA mask, and the union's pixels of every STAGES iteration
    for SHAPE[0] data ranks (the middle iterations share one draw, so its
    loss must fall)."""
    cfg = load_config(overrides={
        "dataset": "synthetic", "synthetic": {"n_frames": 7},
        "cam": {"H": H, "W": W, "fx": float(H), "fy": float(H),
                "cx": (W - 1) / 2, "cy": (H - 1) / 2, "crop_edge": 0},
        "grid_len": GRID_LEN,
        "mapping": {"bound": ROOM, "pixels": RANK_PIXELS,
                    "mapping_window_size": 3},
        "rendering": {"N_samples": 8, "N_surface": 4}})
    specs = specs_from_config(cfg)
    cam = specs.camera
    ds = get_dataset(cfg)
    state = make_map_state(torch.Generator().manual_seed(0), ModelSpec(),
                           ROOM, GRID_LEN, 0.32, occ_guided=True,
                           device="cpu")
    # a proxy that is not flat, so that guided samples would move
    state.grids["occ_proxy"] = torch.rand(
        state.grids["occ_proxy"].shape,
        generator=torch.Generator().manual_seed(9))
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
    window, masks, cams0, lr_mask = mapping.prepare_mapping(
        store, c, d, p, state.grids, state.bound, cam, specs.mapper, True,
        gen=torch.Generator().manual_seed(1),
        mask_names=mapping._trained_grids(specs.mapper, STAGES))
    cams0 = cams0 + 0.01 * torch.randn(
        cams0.shape, generator=torch.Generator().manual_seed(4))
    wn = window["colors"].shape[0]
    g = torch.Generator().manual_seed(2)
    draws = [window_pixels(g, wn, SHAPE[0] * (RANK_PIXELS // wn), cam, "cpu")
             for _ in range(3)]
    pixels = [draws[0]] * STAGES[0][1] + [draws[1]] * STAGES[1][1] \
        + [draws[2]] * STAGES[2][1]
    return specs, state, window, masks, cams0, lr_mask, pixels


def _flat(params, grids, cams, losses) -> dict:
    out = {f"leaf{k}": n(x) for k, x in enumerate(tree_leaves(params)
                                                  + tree_leaves(grids))}
    out["cams"] = n(cams)
    out["losses"] = n(losses)
    return out


@pytest.fixture(scope="module")
def window():
    return _window()


def _gs_call(window, gs, mapspec=None, rspec=None):
    specs, state, win, masks, cams0, lr_mask, pixels = window
    return _flat(*gsm.gs_map_once(
        state.params, state.grids, state.bound, win, cams0, masks, lr_mask,
        1.0, specs.camera, STAGES, mapspec or specs.mapper,
        rspec or specs.render, specs.model, gs,
        gen=torch.Generator().manual_seed(3), pixels=pixels))


def _dense_call(window, mapspec=None, rspec=None, ba=True, pixels_x=1):
    specs, state, win, masks, cams0, lr_mask, pixels = window
    spec = mapspec or specs.mapper
    spec = dataclasses.replace(spec, pixels=pixels_x * spec.pixels)
    return _flat(*mapping.map_optimize(
        state.params, state.grids, state.bound, win, cams0, masks, lr_mask,
        1.0, specs.camera, STAGES, spec, rspec or specs.render, specs.model,
        ba=ba, gen=torch.Generator().manual_seed(3), pixels=pixels))


def _one_rank_window(window):
    """The window at n_data 1: the union draws are one rank's."""
    specs, state, win, masks, cams0, lr_mask, pixels = window
    specs = dataclasses.replace(specs, mapper=dataclasses.replace(
        specs.mapper, pixels=SHAPE[0] * RANK_PIXELS))
    return specs, state, win, masks, cams0, lr_mask, pixels


def _equal(a: dict, b: dict) -> bool:
    return all(np.array_equal(a[k], b[k]) for k in a)


@pytest.fixture(scope="module")
def world_one(window):
    """(the [1, 1] gs step, its GridShard, the dense step) on one rank's
    window."""
    w1 = _one_rank_window(window)
    gs = gsm.GridShard(1, 1)
    return _gs_call(w1, gs), gs, _dense_call(w1)


def test_world_one_gs_step_is_the_dense_step(world_one):
    """Without a process group a GridShard is [1, 1]: its step equals the
    dense map_optimize (BA on, no GN, no clip) bit for bit, and it counts
    its collectives."""
    got, gs, want = world_one
    assert _equal(got, want)
    st = gs.stats()
    assert st["shape"] == [1, 1]
    assert st["iters"] == {"middle": 3, "fine": 1, "color": 2}
    assert set(st["bytes_per_iter"]) == {"features", "halo", "points",
                                         "reassembly", "data"}
    # the points' cotangent is summed only where the cameras are live
    assert set(st["bytes_per_iter"]["points"]) == {"color"}


@pytest.mark.parametrize("case", ["no_gauss_newton", "no_grad_clip",
                                  "no_occ_proxy", "cams_live_without_ba"])
def test_gs_step_differences_from_map_optimize(window, world_one, case,
                                               monkeypatch):
    """Each difference of the JAX gs step (nice_slam_tpu/parallel/
    grid_sharded.py:287-386) from JAX map_optimize, reproduced: the option
    leaves the gs step bit-equal and moves the dense step (Gauss-Newton:
    the dense step runs the refinement, the gs step does not)."""
    from nice_slam_torch.parallel import schur_ba

    refines = []
    orig = schur_ba.schur_pose_refine

    def counted(*a, **k):
        refines.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(schur_ba, "schur_pose_refine", counted)
    w1 = _one_rank_window(window)
    specs = w1[0]
    spec, rspec, ba = specs.mapper, specs.render, True
    if case == "no_gauss_newton":
        spec = dataclasses.replace(spec, pose_gn_iters=1, pose_gn_pixels=8)
    elif case == "no_grad_clip":
        spec = dataclasses.replace(spec, grad_clip=0.01)
    elif case == "no_occ_proxy":
        rspec = dataclasses.replace(rspec, occ_guided=True)
    else:
        spec, ba = dataclasses.replace(spec, ba=False), False
    base, _, dense_base = world_one
    assert _equal(_gs_call(w1, gsm.GridShard(1, 1), spec, rspec), base)
    assert refines == []
    dense = _dense_call(w1, spec, rspec, ba=ba)
    if case == "no_gauss_newton":
        assert refines == [1]
    else:
        assert not _equal(dense, dense_base)
    if case == "cams_live_without_ba":
        # the gs cameras moved with the LR mask, the dense ones did not
        assert not np.array_equal(base["cams"], n(w1[4]))
        assert np.array_equal(dense["cams"], n(w1[4]))


def test_gs_routes_only_the_nice_mapper(monkeypatch):
    """In a run with a GridShard the NICE mapper's events go through
    gs_map_once and the coarse mapper's do not; iMAP* never does."""
    from nice_slam_torch.engine import SlamEngine

    calls = []
    orig = gsm.gs_map_once

    def recorded(*a, **k):
        calls.append(a[9])           # stage_iters
        return orig(*a, **k)

    monkeypatch.setattr(gsm, "gs_map_once", recorded)
    tiny = {"dataset": "synthetic", "synthetic": {"n_frames": 3},
            "cam": {"H": 12, "W": 16, "fx": 12.0, "fy": 12.0, "cx": 7.5,
                    "cy": 5.5, "crop_edge": 0},
            "mapping": {"every_frame": 2, "iters_first": 4, "iters": 3,
                        "pixels": 20, "color_refine": False},
            "tracking": {"iters": 2, "pixels": 16, "ignore_edge_W": 2,
                         "ignore_edge_H": 2},
            "rendering": {"N_samples": 6, "N_surface": 3}}
    for nice in (True, False):
        calls.clear()
        eng = SlamEngine(load_config(nice=nice, overrides=tiny),
                         output="/nonexistent", device="cpu")
        eng.is_primary = False          # writes nothing
        eng.gs = gsm.GridShard(1, 1)
        eng.run()
        assert eng.frames_done == 3
        if nice:
            assert eng.specs.coarse_mapper is not None
            # events 0, 2 (the last frame): never the coarse stage
            assert len(calls) == 2
            assert all("coarse" not in dict(c) for c in calls), calls
        else:
            assert calls == []


def test_grid_sharded_world_checks(capsys):
    """A lone process (and n_model 1) maps dense with the JAX package's
    warning; a group of another size than n_data x n_model raises;
    grid_sharded takes precedence over data_parallel; the pipelined engine
    refuses it."""
    from nice_slam_torch.engine import SlamEngine, check_slice, grid_shard_for

    cfg = load_config(overrides={"tpu": {"grid_sharded": [2, 2],
                                         "data_parallel": True}})
    check_slice(cfg)
    assert grid_shard_for(cfg, 1) is None
    assert "running dense" in capsys.readouterr().out
    with pytest.raises(ValueError):
        grid_shard_for(cfg, 3)
    assert grid_shard_for(load_config(overrides={
        "tpu": {"grid_sharded": [2, 1]}}), 2) is None
    with pytest.raises(ValueError):
        check_slice(load_config(overrides={
            "tpu": {"pipelined": True, "grid_sharded": [1, 2]}}))
    eng = SlamEngine(load_config(overrides={
        "dataset": "synthetic", "synthetic": {"n_frames": 2},
        "cam": {"H": 12, "W": 16, "fx": 12.0, "fy": 12.0, "cx": 7.5,
                "cy": 5.5, "crop_edge": 0},
        "tpu": {"grid_sharded": [2, 2]}}), device="cpu")
    assert (eng.world, eng.gs, eng.dp) == (1, None, None)


# ---------------------------------------------------------------------------
# Four ranks over gloo

def gs_rank_main(rank: int, port: int, out: str) -> None:
    """One rank of the [2, 2] check: the mapping call on the union's
    pixels with the halo invariant checked after every step, and the
    feature sum's and the points' backward over the real groups."""
    torch.set_num_threads(1)
    world = SHAPE[0] * SHAPE[1]
    multihost.initialize(f"127.0.0.1:{port}", world, rank, timeout_s=60,
                         device="cpu")
    gs = gsm.GridShard(*SHAPE)
    halo_ok = []
    refresh = gsm.refresh_halos

    def checked(slabs, names, gs_, stage):
        new = refresh(slabs, names, gs_, stage)
        names = list(names)
        rows = gsm._halo_planes([new[k][0] for k in names], gs_, gs_.m,
                                "check", stage)
        if gs_.m + 1 < gs_.n_model:
            halo_ok.extend(bool(torch.equal(new[k][-1], r[gs_.m + 1]))
                           for k, r in zip(names, rows))
        return new

    gsm.refresh_halos = checked
    win = _window()
    specs, state = win[0], win[1]
    pts = torch.rand(300, 3, generator=torch.Generator().manual_seed(7)) \
        * 6.0 - 1.0
    slabs, shapes = gsm.shard_grids(state.grids, gs.n_model, gs.m)
    query = n(gsm.gs_eval_points(state.params, specs.model, slabs,
                                 state.bound, shapes, pts, "color", gs))
    saved = _gs_call(win, gs)
    saved["query"] = query
    saved["halo_ok"] = np.array(halo_ok)
    # the collectives on the real groups: features summed over `model`,
    # their cotangent passed on unchanged, the points' cotangent summed
    x = torch.full((4,), float(rank), requires_grad=True)
    y = gsm._ModelSum.apply(x, gs, "t")
    (gx,) = torch.autograd.grad((y * 2.0).sum(), x)
    q = gsm._ModelBroadcast.apply(x, gs, "t")
    (gq,) = torch.autograd.grad((q * float(gs.m + 1)).sum(), x)
    saved["sum"], saved["sum_grad"], saved["bcast_grad"] = n(y), n(gx), n(gq)
    saved["dm"] = np.array([gs.d, gs.m])
    saved["backend"] = np.array(multihost.backend())
    np.savez(out, **saved)
    multihost.shutdown()


@pytest.fixture(scope="module")
def gs_ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("gs")
    port = multihost.free_port()
    world = SHAPE[0] * SHAPE[1]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--gs-rank", str(r),
         "--port", str(port), "--out", str(d / f"rank{r}.npz")],
        cwd=REPO, env={**os.environ, "PYTHONPATH": REPO,
                       "OMP_NUM_THREADS": "1"},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True) for r in range(world)]
    logs = _communicate(procs, 180)
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    out = []
    for r in range(world):
        with np.load(d / f"rank{r}.npz") as z:
            out.append({k: z[k] for k in z.files})
    return out


def test_gs_step_equals_one_process_on_the_union(window, gs_ranks):
    """[2, 2] on given pixels against one dense map_optimize on the union
    (2 x a rank's pixels): every loss within 1e-6 relative, every leaf
    (decoders, all grids, cameras) within 1e-5 relative Frobenius; the
    halo invariant bit for bit after every step; the middle loss falls on
    its fixed pixels; the four ranks end bit-equal."""
    want = _dense_call(window, pixels_x=SHAPE[0])
    specs, state, *_ = window
    from nice_slam_torch.render import eval_points

    pts = torch.rand(300, 3, generator=torch.Generator().manual_seed(7)) \
        * 6.0 - 1.0
    with torch.no_grad():
        query = n(eval_points(state.params, specs.model, state.grids,
                              state.bound, pts, "color"))
    before = _flat(state.params, state.grids, window[4], torch.zeros(1))
    moved = [k for k in want if k != "losses"
             and not np.array_equal(want[k], before[k])]
    assert "cams" in moved and len(moved) >= 5, moved
    assert want["losses"][2] < want["losses"][0]
    for r, rank in enumerate(gs_ranks):
        assert str(rank["backend"]) == "gloo"
        assert list(rank["dm"]) == [r // SHAPE[1], r % SHAPE[1]]
        # 6 steps, each refreshing the live levels' halos (1 + 2 + 3 x 2)
        if rank["dm"][1] + 1 < SHAPE[1]:
            assert rank["halo_ok"].size == 3 + 2 + 3 * 2
            assert rank["halo_ok"].all()
        np.testing.assert_allclose(rank["losses"], want["losses"],
                                   rtol=1e-6)
        # the sharded query: each data rank decodes half the points
        np.testing.assert_allclose(rank["query"], query, atol=1e-6)
        for k, w in want.items():
            err = np.linalg.norm(rank[k] - w) / max(np.linalg.norm(w),
                                                     1e-30)
            assert err <= 1e-5, (k, err)
        m = rank["dm"][1]
        assert np.array_equal(rank["sum"], np.full(4, float(
            sum(r // SHAPE[1] * SHAPE[1] + k for k in range(SHAPE[1])))))
        assert np.array_equal(rank["sum_grad"], np.full(4, 2.0))
        assert np.array_equal(rank["bcast_grad"], np.full(4, float(
            sum(k + 1 for k in range(SHAPE[1])))))
        assert m in range(SHAPE[1])
    for k in want:
        for rank in gs_ranks[1:]:
            assert np.array_equal(rank[k], gs_ranks[0][k]), k


# ---------------------------------------------------------------------------
# A [2, 2] run through run_torch.py

def _summaries(stdout: str) -> list:
    dec = json.JSONDecoder()
    out, k = [], stdout.find("{\n")
    while k >= 0:
        obj, end = dec.raw_decode(stdout, k)
        out.append(obj)
        k = stdout.find("{\n", end)
    return out


def test_grid_sharded_run_torch(tmp_path):
    """The JAX package's TestEngineGridSharded scene (9 frames, its bound,
    grid lengths, every_frame and keyframe_every 4), cut to 30x40 and few
    iterations for time, on 4 local ranks at [2, 2]: ATE under 0.25 m (its
    bound), ranks bit-equal, only rank 0 writes."""
    import yaml

    out = tmp_path / "out"
    cfg = tmp_path / "gs.yaml"
    cfg.write_text(yaml.safe_dump({
        "inherit_from": os.path.join(REPO, "configs", "Synthetic",
                                     "synthetic.yaml"),
        "dataset": "synthetic", "synthetic": {"n_frames": 9},
        "cam": {"H": 30, "W": 40, "fx": 30.0, "fy": 30.0, "cx": 19.5,
                "cy": 14.5, "crop_edge": 0},
        "grid_len": GRID_LEN,
        "mapping": {"bound": ROOM, "every_frame": 4, "iters_first": 30,
                    "iters": 8, "pixels": 96, "mapping_window_size": 4,
                    "keyframe_every": 4, "ckpt_freq": 10000,
                    "mesh_freq": 10000, "color_refine": False},
        "tracking": {"iters": 4, "pixels": 64, "ignore_edge_W": 4,
                     "ignore_edge_H": 4},
        "rendering": {"N_samples": 10, "N_surface": 5},
        "tpu": {"seed": 0, "grid_sharded": list(SHAPE)},
        "data": {"output": str(out)}}))
    p = subprocess.Popen([sys.executable, "run_torch.py", str(cfg),
                          "--device", "cpu", "--no-mesh"], cwd=REPO,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True, start_new_session=True,
                         env={**os.environ, "OMP_NUM_THREADS": "1"})
    (log,) = _communicate([p], 240)
    assert p.returncode == 0, log[-3000:]
    ranks = sorted(_summaries(log), key=lambda s: s["rank"])
    assert [s["rank"] for s in ranks] == [0, 1, 2, 3]
    assert all(s["world"] == 4 and s["backend"] == "gloo" for s in ranks)
    assert len({(s["traj_sha256"], s["map_sha256"]) for s in ranks}) == 1
    r0 = ranks[0]
    assert r0["frames"] == 9 and r0["ate_rmse_m"] < 0.25
    assert r0["grid_sharded"]["shape"] == list(SHAPE)
    assert r0["grid_sharded"]["iters"]["color"] > 0
    assert r0["allreduce"] is None
    assert r0["written"] == {"ckpt": 1, "ate": 1, "mesh": 0}
    assert all(s["written"] == {"ckpt": 0, "mesh": 0} for s in ranks[1:])
    assert sorted(os.listdir(out / "ckpts")) == ["00008.npz"]


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--gs-rank", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--out", required=True)
    a = ap.parse_args()
    gs_rank_main(a.gs_rank, a.port, a.out)
