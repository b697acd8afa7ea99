"""The CUDA-graph runner (nice_slam_torch/graphs.py) and the loops it
replays, on the CPU (no JAX: the reference here is the port's own
functional loop, which the JAX-parity tests hold against the JAX package).

- The static-buffer loops (`track_frame`, `map_optimize` through a
  `StepGraphs`) equal the functional loop (fresh tensors every iteration,
  `adam_update`) bit for bit: tracking, and mapping in each signature the
  engine captures (middle, fine, colour, colour with BA, the colour
  refinement, the coarse mapper).
- A test double of `CUDAGraph` whose replay re-runs the captured closure:
  warm-up, then capture, then replays; the launch counts credited per
  replay; the loss records cloned; the tracker's map refreshed in place
  after each event; and a run through it equals the eager run bit for
  bit (a replay that read anything but the static buffers would not).
- Calls that differ in any Python input of a step get different keys.
- Every mapping step reaches a graph, the data-parallel one as segments
  around its reduces; the segmented step's books and its failed capture.
- The pieces: the bias tables, `adam_step_` against `adam_update`, the
  capture record of the launch counters, the constant cache and
  `masked_median`'s device index."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nice_slam_torch import mapping, tracking  # noqa: E402
from nice_slam_torch.config import load_config, specs_from_config  # noqa: E402
from nice_slam_torch.engine import SlamEngine  # noqa: E402
from nice_slam_torch.graphs import StepGraphs  # noqa: E402
from nice_slam_torch.keyframes import add_keyframe, make_store  # noqa: E402
from nice_slam_torch.ops import fused_decode as fd  # noqa: E402
from nice_slam_torch.ops.consts import const  # noqa: E402
from nice_slam_torch.ops.optim import (  # noqa: E402
    adam_init,
    adam_step_,
    adam_update,
    bias_tables,
    inv_bias,
)
from nice_slam_torch.ops.se3 import tensor_from_cam  # noqa: E402
from nice_slam_torch.ops.tree import tree_leaves, tree_map  # noqa: E402
from nice_slam_torch.state import make_map_state  # noqa: E402
from nice_slam_torch.utils.datasets import get_dataset  # noqa: E402

CFG = {
    "dataset": "synthetic", "synthetic": {"n_frames": 7},
    "cam": {"H": 30, "W": 40, "fx": 30.0, "fy": 30.0, "cx": 19.5,
            "cy": 14.5, "crop_edge": 0},
    "grid_len": {"coarse": 1.0, "middle": 0.32, "fine": 0.16,
                 "color": 0.16},
    "mapping": {"bound": [[-0.5, 4.5], [-0.5, 3.5], [-0.5, 4.5]],
                "every_frame": 3, "iters_first": 12, "iters": 6,
                "pixels": 120, "mapping_window_size": 3,
                "keyframe_every": 3, "ckpt_freq": 10000, "mesh_freq": 10000},
    "tracking": {"iters": 4, "pixels": 60, "ignore_edge_W": 4,
                 "ignore_edge_H": 4},
    "rendering": {"N_samples": 10, "N_surface": 5},
}


def _cfg(nice=True, **over):
    cfg = {k: (dict(v) if isinstance(v, dict) else v) for k, v in CFG.items()}
    for k, v in over.items():
        cfg[k] = {**cfg.get(k, {}), **v}
    return load_config(nice=nice, overrides=cfg)


@pytest.fixture(scope="module")
def world():
    cfg = _cfg()
    specs = specs_from_config(cfg)
    gen = torch.Generator().manual_seed(0)
    st = make_map_state(gen, specs.model, cfg["mapping"]["bound"],
                        cfg["grid_len"], cfg["grid_len"]["bound_divisible"],
                        device="cpu")
    ds = get_dataset(cfg)
    frames = [ds[i] for i in range(4)]
    store = make_store(6, specs.camera.H, specs.camera.W, device="cpu")
    for i in range(3):
        _, c, d, pose = frames[i]
        add_keyframe(store, torch.from_numpy(c), torch.from_numpy(d),
                     torch.from_numpy(pose), torch.from_numpy(pose), i)
    return {"cfg": cfg, "specs": specs, "st": st, "frames": frames,
            "store": store}


def _frame(world, i):
    _, c, d, pose = world["frames"][i]
    return (torch.from_numpy(c), torch.from_numpy(d),
            torch.from_numpy(np.asarray(pose, np.float32)))


# ---------------------------------------------------------------------------
# The functional loops (fresh tensors every iteration, adam_update)

def _functional_track(params, grids, bound, cam0, color, depth, camera,
                      tspec, rspec, mspec, gen):
    rspec = dataclasses.replace(rspec, train_decoders=False)
    lr = torch.full((7,), tspec.lr)
    if tspec.seperate_lr:
        lr[:4] = tspec.lr * 0.2
    cam = cam0.detach()
    opt = adam_init(cam)
    best_cam, best_loss = cam, torch.tensor(float("inf"))
    losses = []
    for _ in range(tspec.iters):
        c = cam.clone().requires_grad_(True)
        loss = tracking.tracking_loss(c, params, grids, bound, color, depth,
                                      camera, tspec, rspec, mspec, gen=gen)
        (g,) = torch.autograd.grad(loss, c)
        loss = loss.detach()
        cam_new, opt = adam_update(cam, g, opt, lr)
        better = loss < best_loss
        best_cam = torch.where(better, cam_new, best_cam)
        best_loss = torch.where(better, loss, best_loss)
        losses.append(loss)
        cam = cam_new
    return best_cam, losses[0], losses[-1], best_loss


def _functional_map(params, grids, bound, window, cams0, masks, cam_lr_mask,
                    lr_factor, camera, stage_iters, mapspec, rspec, mspec,
                    ba, gen):
    tree = {"params": params, "grids": grids, "cams": cams0.detach()}
    opt = adam_init(tree)
    if not ba:
        mapspec = dataclasses.replace(mapspec, ba=False)
    losses = []
    for stage, n_iters in stage_iters:
        lr_tree, frozen = mapping._lr_tree(tree, stage, mapspec, lr_factor,
                                           cam_lr_mask)
        rspec_stage = dataclasses.replace(
            rspec, train_decoders=(stage == "color" or not mapspec.nice))
        for _ in range(n_iters):
            tr = tree_map(lambda x, f: x if f else
                          x.detach().requires_grad_(True), tree, frozen)
            live = [x for x, f in zip(tree_leaves(tr), tree_leaves(frozen))
                    if not f]
            loss = mapping.mapping_loss(tr, window, bound, camera, stage,
                                        mapspec, rspec_stage, mspec, gen=gen)
            grads = torch.autograd.grad(loss, live, allow_unused=True)
            gl = iter(grads)
            g = tree_map(lambda x, f: None if f else next(gl), tr, frozen)
            for n in g["grids"]:
                if g["grids"][n] is not None:
                    g["grids"][n] = g["grids"][n] * masks[n]
            g = tree_map(lambda x, gg: torch.zeros_like(x)
                         if gg is None and x.requires_grad else gg, tr, g)
            tree, opt = adam_update(tree, g, opt, lr_tree, frozen=frozen)
            losses.append(loss.detach())
    return tree["params"], tree["grids"], tree["cams"], torch.stack(losses)


def _equal_trees(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def test_track_frame_equals_functional_loop(world):
    """track_frame through a CPU runner equals the functional loop bit for
    bit: best camera, first / last / best loss."""
    s, st = world["specs"], world["st"]
    color, depth, pose = _frame(world, 1)
    cam0 = tensor_from_cam(pose[:3]) + torch.tensor(
        [0.0, 0.0, 0.0, 0.0, 0.03, -0.02, 0.01])
    args = (st.params, st.grids, st.bound, cam0, color, depth, s.camera,
            s.track, s.render, s.model)
    want = _functional_track(*args, gen=torch.Generator().manual_seed(5))
    graphs = StepGraphs("cpu")
    for _ in range(2):   # the second frame reuses the buffers
        got = tracking.track_frame(*args, gen=torch.Generator().manual_seed(5),
                                   graphs=graphs)
        for g_, w_ in zip(got, want):
            assert torch.equal(g_, w_)
    assert graphs.stats()["eager_steps"] == 2 * s.track.iters


def _map_case(world, case):
    s = world["specs"]
    mapspec, n_it, ba = s.mapper, (("middle", 2), ("fine", 2), ("color", 2)), False
    if case in ("middle", "fine", "color"):
        n_it = ((case, 3),)
    elif case == "color_ba":
        n_it, ba = (("color", 3),), True
    elif case == "refine":
        mapspec = dataclasses.replace(
            mapspec, window_size=mapspec.window_size * 2,
            middle_iter_ratio=0.0, fine_iter_ratio=0.0, fix_color=True,
            frustum_selection=False)
        n_it = mapping.stage_iters_of(mapspec, 3)
    elif case == "coarse":
        mapspec = s.coarse_mapper
        n_it = mapping.stage_iters_of(mapspec, 3)
    return mapspec, n_it, ba


@pytest.mark.parametrize("case", ["middle", "fine", "color", "color_ba",
                                  "refine", "coarse"])
def test_map_optimize_equals_functional_loop(world, case):
    """map_optimize through a CPU runner equals the functional loop bit for
    bit in each captured signature: decoders, grids, cameras, losses."""
    s, st = world["specs"], world["st"]
    mapspec, stage_iters, ba = _map_case(world, case)
    color, depth, pose = _frame(world, 3)
    window, masks, cams0, cam_lr_mask = mapping.prepare_mapping(
        world["store"], color, depth, pose, st.grids, st.bound, s.camera,
        mapspec, ba, gen=torch.Generator().manual_seed(2),
        mask_names=mapping._trained_grids(mapspec, stage_iters))
    args = (st.params, st.grids, st.bound, window, cams0, masks, cam_lr_mask,
            1.0, s.camera, stage_iters, mapspec, s.render, s.model, ba)
    want = _functional_map(*args, gen=torch.Generator().manual_seed(3))
    got = mapping.map_optimize(*args, gen=torch.Generator().manual_seed(3),
                               graphs=StepGraphs("cpu"))
    for g_, w_ in zip(got, want):
        assert _equal_trees(g_, w_)
    # the results are new tensors, not the runner's buffers
    assert not (set(x.data_ptr() for x in tree_leaves(got[:3]))
                & set(x.data_ptr() for x in tree_leaves(st.params)
                      + list(st.grids.values())))


# ---------------------------------------------------------------------------
# A test double of CUDAGraph

class FakeGraph:
    """Replays the closure given to its capture; capturing runs nothing."""

    def __init__(self):
        self.fn = None
        self.generators = []

    def register_generator_state(self, gen):
        self.generators.append(gen)

    def replay(self):
        self.fn()


RECORD = {"fwd": 1, "bwd": 2, "fwd_kinds": {"color n=1": 1},
          "bwd_kinds": {"color no-wgrad n=1": 2}}


class DoubleGraphs(StepGraphs):
    """StepGraphs on the CPU with FakeGraph in place of CUDAGraph: each
    capture records RECORD as its launches."""

    def __init__(self, device="cpu", max_iters=0):
        super().__init__(device, capture=False, max_iters=max_iters)
        self.capture = True
        self.log = []

    def _on_side(self, fn):
        self.log.append("eager")
        fn()

    def _new_graph(self):
        return FakeGraph()

    def _record(self, graph, fn, key):
        self.log.append("capture")
        graph.fn = fn
        return RECORD

    def _replay(self, g):
        super()._replay(g)
        self.log.append("replay")

    def _host(self, fn):
        self.log.append("host")
        super()._host(fn)


def _doubled(eng):
    eng._track_graphs = DoubleGraphs()
    eng._map_graphs = DoubleGraphs(max_iters=eng._map_graphs.max_iters)
    return eng


def _state(eng):
    st = eng.map_state
    return ([eng.est_c2w_dev] + tree_leaves(st.params)
            + list(st.grids.values()))


def test_double_run_equals_eager_and_keeps_the_books(tmp_path):
    """A strict engine run whose runners capture into FakeGraph equals the
    eager run bit for bit (trajectory, decoders, grids, tracking losses).
    Per key: one eager warm-up, one capture, then replays only; the
    launch counts gain RECORD at every replay; the loss records are clones;
    the tracker's map is refreshed in place and equals the map."""
    cfg = _cfg(mapping={"color_refine": True})
    plain = SlamEngine(cfg, output=str(tmp_path / "a"), device="cpu").run()
    eng = _doubled(SlamEngine(cfg, output=str(tmp_path / "b"), device="cpu"))
    ptrs = []
    orig = eng._load_track_map

    def load(device):
        orig(device)
        ptrs.append([x.data_ptr() for x in tree_leaves(eng._params_t)
                     + list(eng._grids_t.values())])

    eng._load_track_map = load
    fd.reset_launch_counts()
    eng.run()
    # the loss records share no storage with the tracking buffers
    recs = [r["losses"] for r in eng.tracking_stats]
    held = {x.untyped_storage().data_ptr()
            for b_ in eng._track_graphs._buffers.values()
            for x in vars(b_).values()}
    assert recs and held and not (
        {r.untyped_storage().data_ptr() for r in recs} & held)
    assert all(torch.equal(a, b) for a, b in zip(_state(plain), _state(eng)))
    assert [r["best_loss"] for r in plain.stats()] == [
        r["best_loss"] for r in eng.stats()]
    replays = 0
    for side in (eng._track_graphs, eng._map_graphs):
        st = side.stats()
        assert st["graphs"] == st["captures"] > 0
        # eager warm-ups: one a key; the log's order per key is eager,
        # capture, replays
        assert side.log.count("eager") == len(side._warm)
        assert side.log.count("capture") == st["captures"]
        assert side.log.count("replay") == st["replays"] > 0
        replays += st["replays"]
    assert fd.launch_counts() == {"fused_decode_fwd": replays,
                                  "fused_decode_bwd": 2 * replays}
    assert fd.fwd_launch_kinds() == {"color n=1": replays}
    # the map events' graphs: middle, fine, colour, the coarse mapper, and
    # the colour refinement on buffers of its own (window x2)
    keys = eng._map_graphs._graphs
    assert {k[2] for k in keys} == {"middle", "fine", "color", "coarse"}
    assert len({k[1] for k in keys}) == 2
    # the tracker's copy: refreshed in place at the first frame tracked
    # after each event (frames 1 and 4; frame 6's event is the last, and
    # the tracker reads it here)
    assert len(ptrs) == 2
    eng._tracking_map()
    assert len(ptrs) == 3 and ptrs[0] == ptrs[1] == ptrs[2]
    for a, b in zip(tree_leaves(eng._params_t) + list(eng._grids_t.values()),
                    tree_leaves(eng.map_state.params)
                    + list(eng.map_state.grids.values())):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()


# Each mode's engine run through the double equals its eager run: (the
# config's overrides, load_config's nice, each side's signatures)
MODES = {
    # the first event's 201 iterations in one call cross StepLR's step 200
    "imap": (dict(synthetic={"n_frames": 4},
                  mapping={"iters_first": 201, "pixels": 40},
                  tracking={"pixels": 40}), False,
             {"track", "init_select"}, {"middle", "fine", "color"}),
    # three events, the proxy refreshed after each
    "occ": (dict(rendering={"occupancy_guided": True}), True,
            {"track", "init_select"}, {"middle", "fine", "color", "coarse"}),
    # BA with GN at events 5 and 6 (the refinement's five passes)
    "gn": (dict(synthetic={"n_frames": 7},
                mapping={"every_frame": 1, "keyframe_every": 1, "iters": 3,
                         "pose_GN_iters": 2, "pose_GN_pixels": 20},
                tracking={"pose_GN_iters": 2, "pose_GN_pixels": 40}), True,
           {"track", "init_select", "gn"},
           {"middle", "fine", "color", "coarse", "gn"}),
    # per-iteration panels of tracking and mapping
    "panels": (dict(tracking={"vis_freq": 2, "vis_inside_freq": 2},
                    mapping={"vis_freq": 3, "vis_inside_freq": 4}), True,
               {"track", "init_select"},
               {"middle", "fine", "color", "coarse"}),
}


def _panels(out):
    from pathlib import Path

    found = {}
    for f in sorted(Path(out).glob("*_vis/*.npz")):
        with np.load(f) as z:
            found[f"{f.parent.name}/{f.name}"] = {k: z[k] for k in z.files}
    return found


@pytest.mark.parametrize("mode", sorted(MODES))
def test_double_run_equals_eager_in_every_mode(tmp_path, monkeypatch, mode):
    """An engine run of iMAP* (its StepLR crossing step 200 in one call),
    occupancy-guided sampling (the proxy refreshed in place in the
    tracker's copy), Gauss-Newton in tracking and BA, and the panels of
    tracking and mapping, whose runners capture into FakeGraph, equals
    the eager run bit for bit: trajectory, decoders, grids (the proxy
    among them), keyframes, tracking losses and the panels' arrays.
    Every step of each signature after the first two is a replay of the
    closure captured at the second, so a value of a later iteration that
    the step took from Python would differ."""
    import sys

    over, nice, want_track, want_map = MODES[mode]
    cfg = _cfg(nice=nice, **over)
    for name in [m for m in sys.modules if m.split(".")[0] == "matplotlib"]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    runs = []
    for doubled in (False, True):
        out = str(tmp_path / ("double" if doubled else "eager"))
        eng = SlamEngine(cfg, output=out, device="cpu")
        if doubled:
            _doubled(eng)
        if mode == "panels":
            eng.enable_visualizer()
        ptrs = []
        orig = eng._load_track_map

        def load(device, _orig=orig, _eng=eng, _ptrs=ptrs):
            _orig(device)
            _ptrs.append([x.data_ptr() for x in tree_leaves(_eng._params_t)
                          + list(_eng._grids_t.values())])

        eng._load_track_map = load
        eng.run()
        runs.append((eng, ptrs, out))
    (plain, _, out_p), (eng, ptrs, out_d) = runs
    assert all(torch.equal(a, b) for a, b in zip(_state(plain), _state(eng)))
    assert torch.equal(plain.store.est_c2w, eng.store.est_c2w)
    assert [r["best_loss"] for r in plain.stats()] == [
        r["best_loss"] for r in eng.stats()]
    for side, want in ((eng._track_graphs, want_track),
                       (eng._map_graphs, want_map)):
        st = side.stats()
        assert st["graphs"] == st["captures"] > 0 and st["replays"] > 0
        assert side.log.count("eager") == len(side._warm) == st["eager_steps"]
        got = {k[0] if k[0] != "map" else k[2] for k in side._warm}
        assert got == want, (mode, got)
    # the tracker's copy of the map (the proxy too), read once more after
    # the last event, was refreshed in place each time
    eng._tracking_map()
    assert len(ptrs) >= 2 and all(p == ptrs[0] for p in ptrs)
    if mode == "imap":
        assert max(eng._map_graphs.max_iters, 0) == 201
    if mode == "occ":
        proxy = eng.map_state.grids["occ_proxy"]
        assert torch.equal(eng._grids_t["occ_proxy"], proxy)
        assert float(proxy.min()) < 0.5
    if mode == "panels":
        a, b = _panels(out_p), _panels(out_d)
        assert any(k.startswith("tracking_vis") for k in a)
        assert any(k.startswith("mapping_vis") for k in a)
        assert sorted(a) == sorted(b)
        assert all(np.array_equal(a[k][x], b[k][x])
                   for k in a for x in a[k])


def test_imap_lr_table_is_the_host_scalar():
    """imap_lr_table holds float32(lr * imap_lr_scale(k)) taken in double
    (the value the eager multiply by a host scalar rounds to) at every
    step, across StepLR's boundaries.  The JAX package takes 0.8 ** k in
    float32: its rate differs from the table's at 2,000 of the 3,000 steps
    checked, by at most 3 ulps (2.07e-7 relative; numpy's float32 power
    and the JAX package's agree), which the iMAP* end-to-end parity test
    absorbs."""
    lr = 0.0002
    tab = mapping.imap_lr_table(lr, 3000, "cpu")
    assert tab.dtype == torch.float32 and tab.shape == (3000,)
    want = np.array([np.float32(lr * mapping.imap_lr_scale(k))
                     for k in range(3000)], np.float32)
    assert np.array_equal(tab.numpy(), want)
    assert tab[199] == np.float32(lr) and tab[200] == np.float32(lr * 0.8)
    jax_like = np.array([np.float32(lr) * np.float32(0.8) ** np.float32(
        k // 200) for k in range(3000)], np.float32)
    rel = np.abs(jax_like.astype(np.float64) - want) / want
    assert rel.max() <= 2.1e-7, rel.max()
    ulps = np.abs(jax_like.view(np.int32) - want.view(np.int32))
    assert ulps.max() <= 3


def test_python_inputs_change_the_key(world):
    """Two calls that differ in any Python input of a step get different
    signatures: tracking (iterations, learning rate, pixels, loss weights,
    render spec, camera, a map at other addresses, the generator) and
    mapping (stage, learning-rate factor, BA, map spec, render spec,
    window size, the generator)."""
    s, st = world["specs"], world["st"]
    color, depth, pose = _frame(world, 1)
    cam0 = tensor_from_cam(pose[:3])
    graphs = DoubleGraphs()
    gen, other_gen = torch.Generator(), torch.Generator()

    def track(tspec=s.track, rspec=s.render, camera=s.camera, params=None,
              g=gen):
        tracking.track_frame(params or st.params, st.grids, st.bound, cam0,
                             color, depth, camera,
                             dataclasses.replace(tspec, iters=1), rspec,
                             s.model, gen=g, graphs=graphs)
        return len(graphs._warm)

    n = [track()]
    for kw in ({"tspec": dataclasses.replace(s.track, lr=0.002)},
               {"tspec": dataclasses.replace(s.track, pixels=61)},
               {"tspec": dataclasses.replace(s.track, w_color_loss=0.4)},
               {"tspec": dataclasses.replace(s.track, handle_dynamic=False)},
               {"rspec": dataclasses.replace(s.render, n_surface=4)},
               {"camera": dataclasses.replace(s.camera, fx=31.0)},
               {"params": tree_map(torch.clone, st.params)},
               {"g": other_gen}):
        n.append(track(**kw))
    assert n == list(range(1, len(n) + 1)), n
    assert track() == n[-1]   # the first call's key again

    window, masks, cams0, lr_mask = mapping.prepare_mapping(
        world["store"], color, depth, pose, st.grids, st.bound, s.camera,
        s.mapper, True, gen=torch.Generator().manual_seed(1))
    mgraphs = DoubleGraphs()

    def mapped(stage="color", lr_factor=1.0, ba=False, mapspec=s.mapper,
               rspec=s.render, win=window, m=masks, c=cams0, lm=lr_mask,
               g=gen):
        mapping.map_optimize(st.params, st.grids, st.bound, win, c, m, lm,
                             lr_factor, s.camera, ((stage, 1),), mapspec,
                             rspec, s.model, ba=ba, gen=g, graphs=mgraphs)
        return len(mgraphs._warm)

    n = [mapped()]
    big = mapping.prepare_mapping(
        world["store"], color, depth, pose, st.grids, st.bound, s.camera,
        dataclasses.replace(s.mapper, window_size=6), True,
        gen=torch.Generator().manual_seed(1))
    for kw in ({"stage": "fine"}, {"stage": "middle"}, {"lr_factor": 0.5},
               {"ba": True},
               {"mapspec": dataclasses.replace(s.mapper, w_color_loss=0.3)},
               {"mapspec": dataclasses.replace(s.mapper, pixels=90)},
               {"rspec": dataclasses.replace(s.render, n_samples=9)},
               dict(zip(("win", "m", "c", "lm"), big)), {"g": other_gen}):
        n.append(mapped(**kw))
    assert n == list(range(1, len(n) + 1)), n
    assert mapped() == n[-1]


def test_every_mapping_step_reaches_a_graph(world, monkeypatch):
    """Under a capturing runner every step of tracking and mapping reaches
    a graph: the Adam iterations with the panels' cameras and on_iter,
    init_select's candidate renders and the Gauss-Newton polish of
    tracking and of BA (the mode-specific cases run through whole engines
    below).  The data-parallel step (a world-one RayShard) and its
    Gauss-Newton polish reach their segment signatures: per segment an
    eager warm-up, a capture that replays at once, then replays, with the
    reduce between two segments (two segments an Adam iteration, three a
    Gauss-Newton iteration).  Grid-sharded mapping (`gs_map_once`)
    receives the runner."""
    from nice_slam_torch.ops.se3 import to_homogeneous
    from nice_slam_torch.parallel.data_parallel import RayShard

    s, st = world["specs"], world["st"]
    color, depth, pose = _frame(world, 1)
    graphs = DoubleGraphs()
    tspec = dataclasses.replace(s.track, iters=3, gn_iters=2, gn_pixels=40)
    est = torch.stack([to_homogeneous(pose[:3])] * 3)
    est[1, :3, 3] += 0.01
    _, cams = tracking.track_step(st.params, st.grids, st.bound, est, 2,
                                  color, depth, s.camera, tspec, s.render,
                                  s.model, gen=torch.Generator(),
                                  return_cams=True, graphs=graphs)
    assert cams.shape == (3, 7)
    assert sorted(k[0] for k in graphs._warm) == ["gn", "init_select",
                                                  "track"]
    assert sorted(k[0] for k in graphs._graphs) == ["gn", "track"]
    assert graphs.stats()["eager_steps"] == 3

    window, masks, cams0, lr_mask = mapping.prepare_mapping(
        world["store"], color, depth, pose, st.grids, st.bound, s.camera,
        s.mapper, True, gen=torch.Generator().manual_seed(1))
    mapspec = dataclasses.replace(s.mapper, pose_gn_iters=2,
                                  pose_gn_pixels=20)
    seen = []
    for shard in (None, RayShard()):
        mgraphs = DoubleGraphs()
        mapping.map_optimize(st.params, st.grids, st.bound, window, cams0,
                             masks, lr_mask, 1.0, s.camera, (("color", 3),),
                             mapspec, s.render, s.model, ba=True,
                             gen=torch.Generator(), shard=shard,
                             on_iter=lambda it, tree: seen.append(it),
                             graphs=mgraphs)
        if shard is None:
            assert sorted(k[0] for k in mgraphs._graphs) == ["gn", "map"]
            # per signature: one eager warm-up, then a capture that
            # replays at once and replays
            assert mgraphs.stats()["replays"] == (3 - 1) + (2 - 1)
            assert mgraphs.log.count("capture") == 2
            assert mgraphs.stats()["host_calls"] == 0
        else:
            keys = sorted((k[0], k[-1]) for k in mgraphs._graphs)
            assert keys == [("gn", ("segment", i)) for i in range(3)] + [
                ("map", ("segment", i)) for i in range(2)]
            assert len(mgraphs._warm) == 5
            # Adam: 3 iterations of 2 segments; GN: 2 of 3
            assert mgraphs.log == (
                ["eager", "host", "eager"]
                + ["capture", "replay", "host", "capture", "replay"]
                + ["replay", "host", "replay"]
                + ["eager", "host", "eager", "host", "eager"]
                + ["capture", "replay", "host"] * 2 + ["capture", "replay"])
            assert mgraphs.stats() == {
                "signatures": 5, "graphs": 5, "segments": 5, "captures": 5,
                "replays": 2 * 2 + 3, "eager_steps": 5,
                "host_calls": 3 + 2 * 2,
                "capture_s": mgraphs.capture_s}
            assert shard.calls == {"color": 3, "gn": 4}
    assert seen == [0, 1, 2] * 2

    from nice_slam_torch.parallel import grid_sharded

    called = []
    monkeypatch.setattr(grid_sharded, "gs_map_once",
                        lambda *a, **k: called.append(k) or (
                            st.params, st.grids, cams0,
                            torch.zeros(1)))
    ggraphs = DoubleGraphs()
    mapping._one_map_optimize(
        st.params, st.grids, st.bound, world["store"],
        torch.stack([to_homogeneous(pose[:3])] * 4), 3, color, depth, 1.0,
        s.camera, (("color", 2),), s.mapper, s.render, s.model, False,
        gen=torch.Generator(), gs=object(), graphs=ggraphs)
    assert len(called) == 1 and called[0]["graphs"] is ggraphs


def test_segmented_step_books_and_failures():
    """A segmented step through the double: each segment's launches are
    credited once a replay; a capture that fails in segment 2 raises,
    names that segment, and leaves no graph of the step behind (segments
    0 and 1, captured in the same iteration, are dropped too); a runner
    that does not capture runs every segment and host call eagerly."""
    ran = []

    def seg(i):
        return lambda: ran.append(i)

    segs = [seg(0), seg(1), seg(2)]
    hosts = [lambda: ran.append("h0"), lambda: ran.append("h1")]
    graphs = DoubleGraphs()
    fd.reset_launch_counts()
    for _ in range(4):
        graphs.step_segments(("s",), segs, hosts)
    assert ran == [0, "h0", 1, "h1", 2] * 4
    st = graphs.stats()
    # iterations 2-4 replay each of the three segments
    assert (st["graphs"], st["segments"], st["replays"]) == (3, 3, 9)
    assert fd.launch_counts() == {"fused_decode_fwd": 9,
                                  "fused_decode_bwd": 18}
    fd.reset_launch_counts()
    with pytest.raises(ValueError):
        graphs.step_segments(("t",), segs, hosts[:1])

    class Failing(DoubleGraphs):
        def _record(self, graph, fn, key):
            if key[-1] == ("segment", 2):
                raise RuntimeError("boom")
            return super()._record(graph, fn, key)

    graphs = Failing()
    graphs.step_segments(("f",), segs, hosts)
    with pytest.raises(RuntimeError, match="segment 2 of the step 'f'"):
        graphs.step_segments(("f",), segs, hosts)
    assert graphs._graphs == {}
    eager = StepGraphs("cpu")
    ran.clear()
    eager.step_segments(("e",), segs, hosts)
    assert ran == [0, "h0", 1, "h1", 2]
    assert eager.stats()["eager_steps"] == 3
    assert eager.stats()["host_calls"] == 2


def test_capture_failure_raises():
    """A step that fails while it is captured raises, naming the step; the
    runner keeps no graph of it."""
    class Failing(DoubleGraphs):
        def _record(self, graph, fn, key):
            raise RuntimeError(f"capture of {key[0]!r} failed: boom")

    graphs = Failing()
    graphs.step(("s",), lambda: None)
    with pytest.raises(RuntimeError, match="'s'"):
        graphs.step(("s",), lambda: None)
    assert graphs._graphs == {}


# ---------------------------------------------------------------------------
# The pieces

def test_bias_tables_and_adam_step_equal_adam_update():
    """The bias tables hold 1 / (1 - b**k), taken in double and rounded to
    float32; three in-place steps
    (per-leaf learning rates, a frozen leaf) equal adam_update's bit for
    bit, the step counter included."""
    tab = bias_tables(4, "cpu")
    assert tab.dtype == torch.float32 and tab.shape == (2, 5)
    assert tab[0, 0] == 1.0 and tab[1, 0] == 1.0
    for k in range(1, 5):
        assert tab[0, k].item() == float(np.float32(
            1.0 / (1.0 - 0.9 ** k))) == float(inv_bias(0.9, k))
        assert tab[1, k].item() == float(inv_bias(0.999, k))
    rng = np.random.RandomState(3)
    p = {"a": torch.from_numpy(rng.randn(5).astype(np.float32)),
         "b": [torch.from_numpy(rng.randn(2, 3).astype(np.float32))],
         "c": torch.from_numpy(rng.randn(4).astype(np.float32))}
    lr = {"a": 0.01, "b": [torch.from_numpy(
        rng.rand(2, 3).astype(np.float32))], "c": 0.5}
    frozen = {"a": False, "b": [False], "c": True}
    st = adam_init(p)
    q = tree_map(torch.clone, p)
    m, v = tree_map(torch.zeros_like, p), tree_map(torch.zeros_like, p)
    step = torch.zeros((), dtype=torch.int64)
    for _ in range(3):
        g = {"a": torch.from_numpy(rng.randn(5).astype(np.float32)),
             "b": [torch.from_numpy(rng.randn(2, 3).astype(np.float32))],
             "c": None}
        p, st = adam_update(p, g, st, lr, frozen=frozen)
        adam_step_(q, g, m, v, step, tab, lr, frozen=frozen)
    assert _equal_trees(p, q) and _equal_trees(st.m, m)
    assert _equal_trees(st.v, v) and int(step) == st.step == 3


def test_capture_records_launches_and_replays_credit_them(monkeypatch):
    """A launch counted while a watched stream captures goes into the
    capture's record, not the counts; credit_launches adds the record
    once a replay; a launch into an unwatched capture raises."""
    from types import SimpleNamespace

    stream = SimpleNamespace(cuda_stream=4242)
    state = {"capturing": True}
    monkeypatch.setattr(fd, "_stream_state",
                        lambda device: (4242, state["capturing"]))
    fd.reset_launch_counts()
    with fd.count_captured(stream) as rec:
        fd.FusedNiceDecode._count("fwd", "color n=9", None)
        fd.FusedNiceDecode._count("bwd", "color no-wgrad n=9", None)
    assert rec == {"fwd": 1, "bwd": 1, "fwd_kinds": {"color n=9": 1},
                   "bwd_kinds": {"color no-wgrad n=9": 1}}
    assert fd.launch_counts() == {"fused_decode_fwd": 0,
                                  "fused_decode_bwd": 0}
    for _ in range(3):
        fd.credit_launches(rec)
    assert fd.launch_counts() == {"fused_decode_fwd": 3,
                                  "fused_decode_bwd": 3}
    assert fd.bwd_launch_kinds() == {"color no-wgrad n=9": 3}
    with pytest.raises(RuntimeError, match="no count_captured"):
        fd.FusedNiceDecode._count("fwd", "color n=9", None)
    state["capturing"] = False
    fd.FusedNiceDecode._count("fwd", "color n=9", None)
    assert fd.launch_counts()["fused_decode_fwd"] == 4
    fd.reset_launch_counts()


def test_const_cache_and_device_median():
    """const() gives torch.tensor's values, once per key; masked_median
    reads its index on the device (index_select) with the old result."""
    a = const([1, 2, 3], torch.float32, "cpu")
    assert torch.equal(a, torch.tensor([1.0, 2.0, 3.0]))
    assert const((1, 2, 3), torch.float32, torch.device("cpu")) is a
    assert const([1, 2, 3], torch.int64, "cpu").dtype == torch.int64
    gen = torch.Generator().manual_seed(0)
    for n_ in (1, 2, 7, 50):
        x = torch.rand(n_, generator=gen)
        m = torch.rand(n_, generator=gen) > 0.3
        srt, _ = torch.sort(torch.where(m, x, torch.full_like(x, np.inf)))
        k = max((int(m.sum()) - 1) // 2, 0)
        got = tracking.masked_median(x, m)
        assert got.shape == () and torch.equal(got, srt[k])
