"""The PyTorch port's config loader against the JAX package's, and the
port's import rule (no jax, nothing of nice_slam_tpu)."""

import glob
import os
import subprocess
import sys
import textwrap

import pytest

pytest.importorskip("torch")

from nice_slam_tpu.config import load_config as jax_load_config  # noqa: E402

from nice_slam_torch.config import load_config, specs_from_config  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "**", "*.yaml"),
                           recursive=True))


def test_configs_found():
    assert len(CONFIGS) >= 20


@pytest.mark.parametrize("nice", [True, False], ids=["nice", "imap"])
@pytest.mark.parametrize("path", CONFIGS,
                         ids=[os.path.relpath(p, REPO) for p in CONFIGS])
def test_resolved_dict_equals_jax(path, nice):
    """Exact equality of the resolved dicts (same defaults, same
    inherit_from chain, same overrides)."""
    assert load_config(path, nice=nice) == jax_load_config(path, nice=nice)


def test_overrides_equal_jax():
    ov = {"mapping": {"iters": 7, "bound": [[0, 1], [0, 1], [0, 1]]},
          "tpu": {"seed": 3}}
    assert load_config(overrides=ov) == jax_load_config(overrides=ov)


def test_specs_from_synthetic_config():
    cfg = load_config(os.path.join(REPO, "configs", "Synthetic",
                                   "synthetic.yaml"))
    s = specs_from_config(cfg)
    assert (s.camera.H, s.camera.W) == (240, 320)
    assert s.track.iters == 50 and s.track.pixels == 200
    assert s.mapper.pixels == 1000 and s.mapper.keyframe_selection == "overlap"
    assert s.coarse_mapper.coarse_mapper and not s.coarse_mapper.ba
    assert s.coarse_mapper.keyframe_selection == "global"
    assert s.render.n_samples == 32 and s.render.n_surface == 16


def test_port_imports_without_jax():
    """Every module of nice_slam_torch (and run_torch.py, chip_smoke.py)
    imports with jax and nice_slam_tpu poisoned in sys.modules, among them
    the checkpoint, iMAP* and mesher modules (the host library is not
    built at import), the parallel modes, the evaluation tools, the
    visualiser and the replay, whose viewer template ships inside the
    package (beside tools/replay.py, named in pyproject.toml's package
    data); an iMAP* and a loose engine then
    build, save a checkpoint and resume from it on the CPU the same way,
    as do the Gauss-Newton, occupancy-guided and pretraining modules."""
    code = textwrap.dedent("""
        import importlib, os, pkgutil, sys, tempfile
        for name in ("jax", "jaxlib", "nice_slam_tpu"):
            sys.modules[name] = None
        import nice_slam_torch
        for m in pkgutil.walk_packages(nice_slam_torch.__path__,
                                       "nice_slam_torch."):
            importlib.import_module(m.name)
        for name in ("utils.checkpoint", "models.embedding", "ops.sampling",
                     "ops.composite", "render", "mapping", "engine",
                     "native", "utils.plyio", "utils.mesher",
                     "parallel.schur_ba", "models.pretrain",
                     "tools.pretrain_decoders", "utils.profiling",
                     "parallel.multihost", "parallel.data_parallel",
                     "parallel.pipelined", "tools.eval_recon",
                     "tools.cull_mesh", "tools.eval_ate",
                     "parallel.grid_sharded", "utils.retry",
                     "tools.prep_own_data", "utils.visualizer",
                     "tools.replay"):
            assert "nice_slam_torch." + name in sys.modules, name
        tpl = os.path.join(os.path.dirname(
            sys.modules["nice_slam_torch.tools.replay"].__file__),
            "viewer_template.html")
        assert "__DATA__" in open(tpl).read(), tpl
        import runpy
        runpy.run_path("run_torch.py", run_name="not_main")
        runpy.run_path("chip_smoke.py", run_name="not_main")
        from nice_slam_torch.config import load_config
        from nice_slam_torch.engine import SlamEngine
        tiny = {"synthetic": {"n_frames": 3},
                "cam": {"H": 12, "W": 16, "fx": 12.0, "fy": 12.0,
                        "cx": 7.5, "cy": 5.5, "crop_edge": 0}}
        out = tempfile.mkdtemp()
        for nice, sync in ((False, "strict"), (True, "loose")):
            cfg = load_config(nice=nice, overrides={
                **tiny, "dataset": "synthetic", "sync_method": sync})
            eng = SlamEngine(cfg, output=out, device="cpu")
            p = os.path.join(out, "ck.npz")
            eng.save(p)
            SlamEngine(cfg, output=out, device="cpu").resume(p)
        bad = [m for m in sys.modules if m.split(".")[0] in
               ("jax", "jaxlib", "nice_slam_tpu") and sys.modules[m]]
        assert not bad, bad
        print("ok")
    """)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), r.stderr
    import tomllib

    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        data = tomllib.load(f)["tool"]["setuptools"]["package-data"]
    assert data["nice_slam_torch.tools"] == ["viewer_template.html"]


def test_unsupported_options_raise():
    """No option is refused on its own; tpu.pipelined together with
    tpu.data_parallel or tpu.grid_sharded raises ValueError (the JAX
    package's parallel/pipelined.py:72-76); the other parallel modes,
    occupancy-guided sampling, the Gauss-Newton polish (tracking and
    mapping), loose/free sync (the Demo config's loose among them), iMAP*,
    N_importance, density compositing, gt_camera and NICE widths and
    embeddings the fused decode does not take are accepted, by check_slice
    and by the engine's constructor (which reads the GN and
    occupancy-guided options into its specs)."""
    from nice_slam_torch.engine import check_slice

    for mode in ({"data_parallel": True}, {"grid_sharded": [2, 2]}):
        with pytest.raises(ValueError):
            check_slice(load_config(overrides={
                "tpu": {"pipelined": True, **mode}}))
    for ov in ({"tpu": {"pipelined": True}}, {"tpu": {"data_parallel": True}},
               {"tpu": {"grid_sharded": [2, 2]}},
               {"tpu": {"grid_sharded": [1, 2], "data_parallel": True}},
               {"tpu": {"multihost": True}},
               {"tpu": {"data_parallel": True, "mesh_shape": [2],
                        "multihost": {"num_processes": 2}}},
               {"sync_method": "loose"}, {"sync_method": "free"},
               {"rendering": {"occupancy_guided": True}},
               {"tracking": {"pose_GN_iters": 2}},
               {"mapping": {"pose_GN_iters": 2}},
               {"rendering": {"N_importance": 4}}, {"occupancy": False},
               {"tracking": {"gt_camera": True}},
               {"model": {"c_dim": 16, "hidden_size": 64}},
               {"model": {"pos_embedding_method": "nerf"}}):
        check_slice(load_config(overrides=ov))
    from nice_slam_torch.engine import SlamEngine

    tiny = {"synthetic": {"n_frames": 2}, "dataset": "synthetic",
            "cam": {"H": 12, "W": 16, "fx": 12.0, "fy": 12.0, "cx": 7.5,
                    "cy": 5.5, "crop_edge": 0},
            "model": {"c_dim": 16, "hidden_size": 64}}
    SlamEngine(load_config(overrides=tiny), device="cpu")
    # one process is world 1: the dense path, the primary rank
    eng = SlamEngine(load_config(overrides={
        **tiny, "tpu": {"data_parallel": True, "mesh_shape": [2]}}),
        device="cpu")
    assert (eng.rank, eng.world, eng.dp, eng.is_primary) == (0, 1, None, True)
    eng = SlamEngine(load_config(overrides={
        **tiny, "rendering": {"occupancy_guided": True},
        "tracking": {"pose_GN_iters": 2, "pose_GN_pixels": 30},
        "mapping": {"pose_GN_iters": 3}}), device="cpu")
    s = eng.specs
    assert (s.track.gn_iters, s.track.gn_pixels) == (2, 30)
    assert (s.mapper.pose_gn_iters, s.mapper.pose_gn_pixels) == (3, 200)
    assert s.coarse_mapper.pose_gn_iters == 0 and s.render.occ_guided
    assert eng.map_state.grids["occ_proxy"].shape[-1] == 1
    check_slice(load_config(nice=False))
    check_slice(load_config(os.path.join(REPO, "configs", "Demo",
                                         "demo.yaml")))
    check_slice(load_config())


def test_imap_specs_reach_the_port():
    """The iMAP* overrides reach the port's specs as the JAX package's
    (handle_dynamic off, density compositing, importance samples, global
    keyframe selection, no frustum masks, imap_decoders_lr)."""
    from nice_slam_tpu.config import specs_from_config as jax_specs

    cfg = os.path.join(REPO, "configs", "Synthetic", "synthetic.yaml")
    s = specs_from_config(load_config(cfg, nice=False))
    j = jax_specs(jax_load_config(cfg, nice=False))
    assert not s.track.handle_dynamic and not s.track.nice
    assert (s.render.n_samples, s.render.n_surface, s.render.n_importance,
            s.render.occupancy) == (32, 0, 12, False)
    for name in ("handle_dynamic", "pixels", "iters", "nice"):
        assert getattr(s.track, name) == getattr(j.track, name), name
    for name in ("pixels", "w_color_loss", "frustum_selection",
                 "keyframe_selection", "ba", "ba_cam_lr", "nice",
                 "imap_decoders_lr"):
        assert getattr(s.mapper, name) == getattr(j.mapper, name), name
    for name in ("n_samples", "n_surface", "n_importance", "occupancy",
                 "perturb"):
        assert getattr(s.render, name) == getattr(j.render, name), name
    assert s.coarse_mapper is None and j.coarse_mapper is None
    assert not s.model.nice and not s.model.coarse


def _run_torch_parser():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "run_torch_flags", os.path.join(REPO, "run_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.build_parser()


@pytest.mark.parametrize("flags, nice", [
    ([], True), (["--nice"], True), (["--imap"], False),
    (["--nice", "--imap"], None)])
def test_run_torch_nice_imap_flags(flags, nice, capsys):
    """run_torch.py takes run.py's mutually exclusive --nice / --imap
    (run.py:26-28): NICE by default, and argparse exits with 2 when both
    are given."""
    ap = _run_torch_parser()
    if nice is None:
        with pytest.raises(SystemExit) as e:
            ap.parse_args(["cfg.yaml"] + flags)
        assert e.value.code == 2
        assert "not allowed with argument" in capsys.readouterr().err
    else:
        assert ap.parse_args(["cfg.yaml"] + flags).nice is nice
