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
    imports with jax and nice_slam_tpu poisoned in sys.modules."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        for name in ("jax", "jaxlib", "nice_slam_tpu"):
            sys.modules[name] = None
        import nice_slam_torch
        for m in pkgutil.walk_packages(nice_slam_torch.__path__,
                                       "nice_slam_torch."):
            importlib.import_module(m.name)
        import runpy
        runpy.run_path("run_torch.py", run_name="not_main")
        runpy.run_path("chip_smoke.py", run_name="not_main")
        bad = [m for m in sys.modules if m.split(".")[0] in
               ("jax", "jaxlib", "nice_slam_tpu") and sys.modules[m]]
        assert not bad, bad
        print("ok")
    """)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def test_unsupported_options_raise():
    from nice_slam_torch.engine import check_slice

    base = load_config()
    for ov in ({"sync_method": "loose"}, {"rendering": {"N_importance": 4}},
               {"tracking": {"pose_GN_iters": 2}}, {"tpu": {"pipelined": True}}):
        with pytest.raises(NotImplementedError):
            check_slice(load_config(overrides=ov))
    with pytest.raises(NotImplementedError):
        check_slice(load_config(nice=False))
    check_slice(base)
