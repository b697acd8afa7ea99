"""The port's visualiser panels and trajectory replay against the JAX
package's.

- render_image (the panels' render) against JAX render_image on the same
  map and pose: depth and colour atol 1e-4, rtol 1e-4.
- The panel's jpg is byte-equal to JAX save_panel's on the same arrays;
  its npz holds the six float32 images (exact).
- The mapping iterations that get a panel equal the segment starts of JAX
  segment_stage_iters (exact, pure Python).
- The engine's cadence on TestInsideVisualizer's config
  (tests/test_slam.py) gives exactly the panel names of the JAX test's
  rules, and drawing panels changes no result (bit-equal trajectory,
  grids and decoders); the grid-sharded route at [1, 1] draws the same
  mapping panels (atol 1e-6).
- The replay's --html embeds the same DATA as JAX tools/replay.py
  (exact), and its png mode without matplotlib names --html."""

import base64
import json
import os
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from nice_slam_tpu.camera import Camera as JCamera  # noqa: E402
from nice_slam_tpu.models.decoders import nice_model_spec  # noqa: E402
from nice_slam_tpu.ops import cam_from_tensor  # noqa: E402
from nice_slam_tpu.render import RenderSpec as JRenderSpec  # noqa: E402
from nice_slam_tpu.render import render_image as jax_render_image  # noqa: E402
from nice_slam_tpu.state import make_map_state as jax_make_map_state  # noqa: E402
from nice_slam_tpu.utils import visualizer as jvis  # noqa: E402

from nice_slam_torch.camera import Camera  # noqa: E402
from nice_slam_torch.config import load_config  # noqa: E402
from nice_slam_torch.convert import params_from_jax  # noqa: E402
from nice_slam_torch.engine import SlamEngine  # noqa: E402
from nice_slam_torch.models.decoders import ModelSpec  # noqa: E402
from nice_slam_torch.ops.tree import tree_leaves  # noqa: E402
from nice_slam_torch.render import RenderSpec, render_image  # noqa: E402
from nice_slam_torch.tools import replay  # noqa: E402
from nice_slam_torch.utils import visualizer as vis  # noqa: E402
from nice_slam_torch.utils.plyio import write_ply  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))
sys.path.insert(0, REPO)
from test_slam import TEST_CFG  # noqa: E402
from tools import replay as jreplay  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture
def no_matplotlib(monkeypatch):
    """matplotlib poisoned: `import matplotlib` raises ImportError."""
    for name in [m for m in sys.modules if m.split(".")[0] == "matplotlib"]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)


def _panel_inputs(seed=0, h=12, w=16):
    rng = np.random.RandomState(seed)
    gt_depth = (rng.rand(h, w) * 3).astype(np.float32)
    gt_depth[2:4, 5:9] = 0.0
    return (gt_depth, rng.rand(h, w, 3).astype(np.float32),
            (rng.rand(h, w) * 3).astype(np.float32),
            (rng.rand(h, w, 3) * 1.4 - 0.2).astype(np.float32))


# ---------------------------------------------------------------------------
# The render and the panel


def test_render_image_matches_jax():
    """Two chunks, the last one partial; a depth hole."""
    st = jax_make_map_state(jax.random.PRNGKey(2), nice_model_spec(),
                            [[-0.5, 2.5], [-0.5, 2.0], [-0.5, 2.5]],
                            {"coarse": 1.0, "middle": 0.32, "fine": 0.16,
                             "color": 0.16}, 0.32)
    cam = dict(H=12, W=16, fx=12.0, fy=12.0, cx=7.5, cy=5.5)
    c2w = np.asarray(cam_from_tensor(np.array(
        [0.95, 0.1, -0.2, 0.05, 1.0, 0.8, 2.4], np.float32)))
    rng = np.random.RandomState(0)
    gt = (rng.rand(12, 16) * 2 + 0.5).astype(np.float32)
    gt[3, :4] = 0.0
    out_j = jax_render_image(
        jax.tree.map(np.asarray, st.params), nice_model_spec(), st.grids,
        st.bound, c2w, JCamera(**cam), jax.random.PRNGKey(0),
        JRenderSpec(n_samples=12, n_surface=6), "color", gt, chunk=100)
    out_t = render_image(
        params_from_jax(jax.tree.map(np.asarray, st.params), device="cpu"),
        ModelSpec(),
        params_from_jax({k: np.asarray(v) for k, v in st.grids.items()},
                        device="cpu"),
        torch.tensor(np.asarray(st.bound)), torch.tensor(c2w),
        Camera(**cam), RenderSpec(n_samples=12, n_surface=6), "color",
        torch.tensor(gt), chunk=100)
    for i in (0, 2):   # depth, colour
        np.testing.assert_allclose(out_t[i].numpy(), np.asarray(out_j[i]),
                                   **TOL)


def test_panel_npz_holds_the_six_images(tmp_path, no_matplotlib):
    gt_d, gt_c, d, c = _panel_inputs()
    written = vis.save_panel(str(tmp_path / "00003_0007"), gt_d, gt_c, d, c)
    assert written == [str(tmp_path / "00003_0007.npz")]
    z = vis.load_panel(written[0])
    assert all(z[k].dtype == np.float32 for k in vis.PANEL_KEYS)
    hole = gt_d == 0.0
    np.testing.assert_array_equal(z["depth_residual"][hole], 0.0)
    np.testing.assert_array_equal(z["color_residual"][hole], 0.0)
    np.testing.assert_array_equal(z["depth_residual"][~hole],
                                  np.abs(gt_d - d)[~hole])
    np.testing.assert_array_equal(z["color"], np.clip(c, 0, 1))
    np.testing.assert_array_equal(z["gt_depth"], gt_d)
    assert float(z["vmax"]) == float(gt_d.max())


def test_panel_jpg_equals_jax_and_draws_from_npz(tmp_path, monkeypatch):
    """The port's jpg equals JAX save_panel's byte for byte; the jpg that
    `python -m nice_slam_torch.utils.visualizer <dir>` draws later from
    the npz equals both; without matplotlib the command exits 1."""
    args = _panel_inputs(1)
    jvis.save_panel(str(tmp_path / "jax.jpg"), *args)
    vis.save_panel(str(tmp_path / "port" / "00001_0000"), *args)
    want = (tmp_path / "jax.jpg").read_bytes()
    assert (tmp_path / "port" / "00001_0000.jpg").read_bytes() == want
    late = tmp_path / "late"
    late.mkdir()
    (tmp_path / "port" / "00001_0000.npz").rename(late / "00001_0000.npz")
    assert vis.main([str(late)]) == 0
    assert (late / "00001_0000.jpg").read_bytes() == want
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert vis.main([str(late)]) == 1


def test_stage_timer_books_nested_stages_apart():
    """A stage timed inside another counts only to itself (panels drawn
    inside a mapping event count under 'vis', not 'map')."""
    import time

    from nice_slam_torch.utils.profiling import StageTimer

    timer = StageTimer()
    t0 = time.perf_counter()
    with timer.time("map"):
        time.sleep(0.01)
        with timer.time("vis"):
            time.sleep(0.05)
    elapsed = time.perf_counter() - t0
    assert timer.totals["vis"] >= 0.05
    assert abs(timer.totals["map"] + timer.totals["vis"] - elapsed) < 1e-3
    assert dict(timer.counts) == {"map": 1, "vis": 1}


@pytest.mark.parametrize("stage_iters,inside_freq", [
    ((("middle", 6), ("fine", 12), ("color", 42)), 25),
    ((("middle", 1), ("fine", 2), ("color", 3)), 3),
    ((("color", 10),), 1),
    ((("middle", 3), ("fine", 0), ("color", 4)), 50),
    ((("middle", 151), ("fine", 99), ("color", 250)), 40)])
def test_mapping_panel_iters_equal_jax_segments(stage_iters, inside_freq):
    total = sum(n for _, n in stage_iters)
    v = vis.Visualizer("unused", 1, inside_freq)
    drawn = [it for it in range(total) if v.iter_selected(it)]
    starts = [s for s, _ in jvis.segment_stage_iters(stage_iters,
                                                      inside_freq)]
    assert drawn == starts


# ---------------------------------------------------------------------------
# The engine's panels

# TestInsideVisualizer's config (tests/test_slam.py), cut for time: the
# camera to 18x24, the samples to 12 + 6 a ray, 100 mapping pixels
IVIS = {**TEST_CFG,
        "cam": {**TEST_CFG["cam"], "H": 18, "W": 24, "fx": 18.0,
                "fy": 18.0, "cx": 11.5, "cy": 8.5},
        "rendering": {"N_samples": 12, "N_surface": 6},
        "synthetic": {"n_frames": 5},
        "mapping": {**TEST_CFG["mapping"], "every_frame": 2,
                    "iters_first": 6, "iters": 6, "keyframe_every": 2,
                    "pixels": 100, "vis_freq": 2, "vis_inside_freq": 3},
        "tracking": {**TEST_CFG["tracking"], "iters": 5, "pixels": 100,
                     "vis_freq": 2, "vis_inside_freq": 2}}


def _run(out, setup=None, overrides=IVIS):
    eng = SlamEngine(load_config(overrides=overrides), output=str(out),
                     device="cpu")
    if setup is not None:
        setup(eng)
    eng.run()
    return eng


def _state(eng):
    return ([eng.est_c2w_dev] + tree_leaves(eng.map_state.params)
            + tree_leaves(eng.map_state.grids))


def _names(d):
    return sorted(os.listdir(d)) if os.path.isdir(d) else []


@pytest.fixture(scope="module")
def plain_run(tmp_path_factory):
    return _run(tmp_path_factory.mktemp("plain"))


@pytest.fixture(scope="module")
def panel_run(tmp_path_factory):
    """The run with per-iteration panels, matplotlib poisoned; (engine,
    output dir, the lines it printed that start with 'visualizer:')."""
    import contextlib
    import io

    out = tmp_path_factory.mktemp("ivis")
    buf = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(buf):
        for name in [m for m in sys.modules
                     if m.split(".")[0] == "matplotlib"]:
            mp.delitem(sys.modules, name)
        mp.setitem(sys.modules, "matplotlib", None)
        eng = _run(out, lambda e: e.enable_visualizer())
    return eng, out, [ln for ln in buf.getvalue().splitlines()
                      if ln.startswith("visualizer:")]


def test_inside_panels_cadence_and_bit_equal(plain_run, panel_run):
    """The JAX test's panel names, exactly, as npz only (no matplotlib),
    with the one line that names the command drawing the jpgs; the same
    trajectory, grids and decoders as the run without panels, bit for
    bit."""
    eng, out, lines = panel_run
    assert len(lines) == 1 and "npz only" in lines[0]
    assert vis.DRAW_COMMAND in lines[0]
    # tracking: frames 2 and 4, iterations 0, 2 and 4 of 5
    assert _names(out / "tracking_vis") == [
        f"{f:05d}_{it:04d}.npz" for f in (2, 4) for it in (0, 2, 4)]
    # mapping: events 2 and 4, iterations 0 and 3 of 6; none at the first
    # event (mapping.no_vis_on_first_frame)
    assert _names(out / "mapping_vis") == [
        f"{f:05d}_{it:04d}.npz" for f in (2, 4) for it in (0, 3)]
    assert eng.written["vis"] == 10 and eng.timer.counts["vis"] == 10
    for a, b in zip(_state(eng), _state(plain_run)):
        assert torch.equal(a, b)
    z = vis.load_panel(str(out / "mapping_vis" / "00004_0003.npz"))
    assert all(np.isfinite(z[k]).all() for k in vis.PANEL_KEYS)
    assert z["depth"].shape == (18, 24) and z["color"].shape == (18, 24, 3)


def test_grid_sharded_panels_equal_dense(tmp_path, plain_run, panel_run,
                                         no_matplotlib):
    """The mapping panels through the grid-sharded decode (GridShard at
    [1, 1], no process group) equal the dense route's within 1e-6, and
    the run still equals the run without panels."""
    from nice_slam_torch.parallel.grid_sharded import GridShard

    def setup(e):
        e.gs = GridShard(1, 1)
        e.enable_visualizer(mapping_only=True)

    dense = panel_run[1]
    out = tmp_path / "gs"
    eng = _run(out, setup)
    assert not (out / "tracking_vis").exists()
    names = _names(out / "mapping_vis")
    assert names == _names(dense / "mapping_vis") and len(names) == 4
    for name in names:
        a = vis.load_panel(str(out / "mapping_vis" / name))
        b = vis.load_panel(str(dense / "mapping_vis" / name))
        for k in vis.PANEL_KEYS:
            np.testing.assert_allclose(a[k], b[k], atol=1e-6, rtol=0)
    assert eng.gs.stats()["bytes"]["features"] > 0
    for a, b in zip(_state(eng), _state(plain_run)):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


SMALL = {**IVIS, "synthetic": {"n_frames": 4},
         "mapping": {**IVIS["mapping"], "iters_first": 3, "iters": 3,
                     "pixels": 100}}


@pytest.mark.parametrize("mode,tracking,mapping", [
    # every 2nd frame after its event; every 2nd mapping event (0 and 3,
    # the final frame's)
    ({"inside": False}, ["00002_0000.npz"],
     ["00000_0000.npz", "00003_0000.npz"]),
    # per-iteration mapping panels only: event 2, iterations 0 and 3 of 3
    ({"mapping_only": True}, [], ["00002_0000.npz"])])
def test_hook_panel_names(tmp_path, no_matplotlib, mode, tracking, mapping):
    out = tmp_path / "hooks"
    _run(out, lambda e: e.enable_visualizer(**mode), SMALL)
    assert _names(out / "tracking_vis") == tracking
    assert _names(out / "mapping_vis") == mapping


def test_gauss_newton_tracking_panels_bit_equal(tmp_path, no_matplotlib):
    """With the Gauss-Newton polish after tracking's Adam loop, the
    tracking panels still draw the Adam loop's pre-step cameras, and the
    run equals the same run without panels, bit for bit."""
    gn = {**SMALL, "synthetic": {"n_frames": 3},
          "tracking": {**SMALL["tracking"], "pose_GN_iters": 2,
                       "pose_GN_pixels": 60}}
    plain = _run(tmp_path / "plain", overrides=gn)
    out = tmp_path / "panels"
    eng = _run(out, lambda e: e.enable_visualizer(), gn)
    # frame 2, iterations 0, 2 and 4 of 5; event 2, iteration 0 of 3
    assert _names(out / "tracking_vis") == [
        f"00002_{it:04d}.npz" for it in (0, 2, 4)]
    assert _names(out / "mapping_vis") == ["00002_0000.npz"]
    for a, b in zip(_state(eng), _state(plain)):
        assert torch.equal(a, b)


def test_pipelined_mapping_panels(tmp_path, no_matplotlib):
    """The pipelined engine (one device) draws the mapping panels of
    enable_visualizer(mapping_only=True), as the sequential engine, and
    refuses the per-frame tracking hook of inside=False (as JAX)."""
    from nice_slam_torch.parallel.pipelined import PipelinedSlamEngine

    cfg = load_config(overrides={**SMALL, "tpu": {"pipelined": True}})
    out = tmp_path / "pipe"
    PipelinedSlamEngine(cfg, output=str(out), devices=["cpu"]) \
        .enable_visualizer(mapping_only=True).run()
    assert _names(out / "mapping_vis") == ["00002_0000.npz"]
    assert not (out / "tracking_vis").exists()
    eng = PipelinedSlamEngine(cfg, output=str(tmp_path / "refused"),
                              devices=["cpu"]).enable_visualizer(
                                  inside=False)
    with pytest.raises(ValueError, match="mapping_only"):
        eng.run()


# ---------------------------------------------------------------------------
# The replay


def _orbit_c2w(n, radius=2.0):
    out = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    th = np.linspace(0, 2 * np.pi, n, endpoint=False)
    out[:, 0, 3] = radius * np.cos(th)
    out[:, 2, 3] = radius * np.sin(th)
    return out


def _run_dir(tmp_path, n=12, with_mesh=True, nan_gt_frames=(), selkf=False):
    out = tmp_path / "run"
    (out / "ckpts").mkdir(parents=True)
    gt = _orbit_c2w(n, radius=2.01)
    gt[list(nan_gt_frames)] = np.nan
    extra = {"extra/kf_frame_ids": np.array([0, 5, 10])}
    if selkf:
        extra["extra/selkf_event_idx"] = np.array([5, 10])
        extra["extra/selkf_frames"] = np.array([[0, 5, -2], [0, 5, 20]])
    np.savez(out / "ckpts" / "00011.npz", est_c2w=_orbit_c2w(n), gt_c2w=gt,
             idx=np.int64(n), **extra)
    if with_mesh:
        (out / "mesh").mkdir()
        rng = np.random.RandomState(3)
        write_ply(str(out / "mesh" / "final_mesh.ply"),
                  rng.rand(9, 3).astype(np.float32),
                  rng.randint(0, 9, (7, 3)),
                  rng.randint(0, 256, (9, 3)).astype(np.uint8))
    return out


def _data(path):
    m = re.search(r"const DATA = (\{.*?\});\n", path.read_text(), re.S)
    assert m, "embedded DATA block missing"
    return json.loads(m.group(1))


@pytest.mark.parametrize("kw,max_faces", [
    ({}, 150000), ({"with_mesh": False, "nan_gt_frames": (3, 7)}, 150000),
    ({"selkf": True}, 150000), ({}, 1), ({}, 4)],
    ids=["mesh", "no-mesh-nan-gt", "selkf", "max-faces-1", "max-faces-4"])
def test_replay_html_data_equals_jax(tmp_path, kw, max_faces):
    run = _run_dir(tmp_path, **kw)
    jreplay.write_html(str(run), str(tmp_path / "jax.html"), max_faces)
    replay.write_html(str(run), str(tmp_path / "port.html"), max_faces)
    want = _data(tmp_path / "jax.html")
    assert _data(tmp_path / "port.html") == want
    assert (tmp_path / "port.html").read_text() == \
        (tmp_path / "jax.html").read_text()
    assert want["n"] == 12 and want["kf"] == [0, 5, 10]


def test_replay_png_mode_without_matplotlib(tmp_path, no_matplotlib,
                                            capsys):
    with pytest.raises(SystemExit) as e:
        replay.main([str(_run_dir(tmp_path)), "--stride", "2"])
    assert e.value.code not in (0, None) and "--html" in str(e.value.code)


def test_replay_cli_html(tmp_path, monkeypatch, capsys):
    """`python -m nice_slam_torch.tools.replay <run> --html <file>`, run
    as __main__ in this process (a new interpreter would spend its time
    importing torch)."""
    import runpy

    run = _run_dir(tmp_path)
    out = tmp_path / "viewer.html"
    monkeypatch.setattr(sys, "argv", ["replay", str(run), "--html",
                                      str(out)])
    monkeypatch.delitem(sys.modules, "nice_slam_torch.tools.replay")
    runpy.run_module("nice_slam_torch.tools.replay", run_name="__main__",
                     alter_sys=True)
    assert "wrote interactive viewer" in capsys.readouterr().out
    data = _data(out)
    est = np.frombuffer(base64.b64decode(data["est"]),
                        np.float32).reshape(12, 4, 4)
    np.testing.assert_array_equal(est, _orbit_c2w(12))
    assert "mesh_v" in data and "http" not in out.read_text()
