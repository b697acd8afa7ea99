"""The port's reconstruction evaluation (nice_slam_torch/tools/eval_recon.py,
cull_mesh.py, eval_ate.py and the rasterizer in nice_slam_torch/native/)
against the JAX package's tools and native library, on the meshes of
tests/test_mesh.py `TestEvalRecon` / `TestCullMesh`:

- sample_surface bit-equal; calc_3d_metrics and calc_2d_metric (few
  views, with and without ICP, with view rejection) equal to 1e-6;
- the rasterizer's library equal to the JAX library and to its numpy
  oracle (near-plane clipping included); a failed g++ build raises;
- cull and unseen_points equal;
- eval_ate on a port checkpoint prints the JSON of tools/eval_ate.py.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import cull_mesh as jax_cull  # noqa: E402
import eval_recon as jax_recon  # noqa: E402
from nice_slam_tpu import native as jax_native  # noqa: E402

from nice_slam_torch import native  # noqa: E402
from nice_slam_torch.tools import cull_mesh, eval_recon  # noqa: E402


def sphere_mesh(n=24, r=0.6, center=(0.0, 0.0, 0.0)):
    xs = np.linspace(-1, 1, n)
    X, Y, Z = np.meshgrid(xs, xs, xs, indexing="ij")
    vol = (r - np.sqrt((X - center[0]) ** 2 + (Y - center[1]) ** 2
                       + (Z - center[2]) ** 2)).astype(np.float32)
    return native.marching_tetrahedra(vol, 0.0, np.full(3, -1.0),
                                      np.full(3, 2.0 / (n - 1)))


@pytest.fixture(scope="module")
def meshes():
    """A sphere, and a smaller sphere off centre (a reconstruction that
    misses)."""
    v, t = sphere_mesh()
    v2, t2 = sphere_mesh(r=0.5, center=(0.05, -0.03, 0.02))
    return (v, t, None), (v2, t2, None)


def test_marching_equals_jax():
    vol = np.random.RandomState(0).rand(12, 10, 14).astype(np.float32)
    v, t = native.marching_tetrahedra(vol, 0.5, np.zeros(3), np.ones(3))
    jv, jt = jax_native.marching_tetrahedra(vol, 0.5, np.zeros(3),
                                            np.ones(3))
    assert np.array_equal(v, jv) and np.array_equal(t, jt)


def test_sample_surface_bit_equal(meshes):
    v, t, _ = meshes[0]
    for seed in (0, 1):
        assert np.array_equal(eval_recon.sample_surface(v, t, 5000, seed),
                              jax_recon.sample_surface(v, t, 5000, seed))
    sq = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], float)
    tri = np.array([[0, 1, 2], [0, 2, 3]])
    assert np.array_equal(eval_recon.sample_surface(sq, tri, 5000),
                          jax_recon.sample_surface(sq, tri, 5000))


@pytest.mark.parametrize("align", [False, True])
def test_3d_metrics_equal_jax(meshes, align):
    rec, gt = meshes[1], meshes[0]
    got = eval_recon.calc_3d_metrics(rec, gt, n_samples=20_000, align=align)
    want = jax_recon.calc_3d_metrics(rec, gt, n_samples=20_000, align=align)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6)
    assert got["accuracy_cm"] > 1.0   # the spheres differ
    same = eval_recon.calc_3d_metrics(gt, gt, n_samples=5000, align=False)
    assert same["accuracy_cm"] < 2.0 and same["completion_ratio_pct"] > 99


@pytest.mark.parametrize("align", [False, True])
def test_2d_metric_equal_jax(meshes, align):
    rec, gt = meshes[1], meshes[0]
    kw = dict(n_views=3, H=60, W=60, focal=40.0, align=align)
    got = eval_recon.calc_2d_metric(rec, gt, **kw)
    want = jax_recon.calc_2d_metric(rec, gt, **kw)
    assert got.keys() == want.keys() and got["views_used"] == 3
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6)
    assert got["depth_l1_cm"] > 0
    zero = eval_recon.calc_2d_metric(gt, gt, n_views=2, H=60, W=60,
                                     focal=40.0, align=False)
    assert zero["depth_l1_cm"] == 0.0


def test_2d_metric_rejection_equal_jax(meshes):
    """Views in which unseen points are visible are resampled, and views
    without a clean sample are excluded, as in the JAX tool."""
    gt = meshes[0]
    th = np.linspace(0, 2 * np.pi, 64)
    ring = np.stack([2.5 * np.cos(th), 2.5 * np.sin(th),
                     np.zeros_like(th)], 1)
    ring = np.concatenate([ring, ring[:, [0, 2, 1]], ring[:, [2, 0, 1]]])
    kw = dict(pc_unseen=ring, n_views=2, align=False)
    got = eval_recon.calc_2d_metric(gt, gt, **kw)
    np.testing.assert_equal(got, jax_recon.calc_2d_metric(gt, gt, **kw))
    assert got["views_rejected"] > 0
    assert got["views_used"] + got["views_excluded"] == 2


def test_rasterizer_equals_jax_library_and_oracle(meshes):
    v, t, _ = meshes[0]
    for pos in ([0.3, -0.2, 2.5], [0.0, 0.0, 3.0]):
        c2w = np.eye(4)
        c2w[:3, 3] = pos
        d = native.rasterize_depth(v, t, c2w, 48, 56, 50.0, 50.0, 27.5,
                                   23.5)
        jd = jax_native.rasterize_depth(v, t, c2w, 48, 56, 50.0, 50.0, 27.5,
                                        23.5)
        np.testing.assert_array_equal(d, jd)
        oracle = native._rasterize_depth_numpy(
            np.ascontiguousarray(v, np.float32), np.asarray(t, np.int64),
            np.linalg.inv(c2w).astype(np.float32), 48, 56, 50.0, 50.0, 27.5,
            23.5, 0.01, 20.0)
        np.testing.assert_allclose(d, oracle, atol=1e-4)
        assert (d > 0).any()


def test_rasterizer_near_plane_clipping():
    """A wall straddling the camera plane is clipped, not dropped or
    smeared (tests/test_mesh.py:159-174), in the library and the oracle
    alike."""
    v = np.array([[0.5, -5, 5], [0.5, -5, -5], [0.5, 5, -5],
                  [0.5, 5, 5]], np.float32)
    t = np.array([[0, 1, 2], [0, 2, 3]], np.int64)
    args = (64, 64, 32.0, 32.0, 31.5, 31.5)
    d = native.rasterize_depth(v, t, np.eye(4), *args)
    np.testing.assert_array_equal(
        d, jax_native.rasterize_depth(v, t, np.eye(4), *args))
    # the same coverage; depths to rtol 1e-4 (the library's barycentrics
    # are fp32, the oracle's partly fp64: at grazing pixels near the
    # clipped edge 1/d interpolates across a wide range)
    oracle = native._rasterize_depth_numpy(
        v, t, np.eye(4, dtype=np.float32), *args, 0.01, 20.0)
    np.testing.assert_array_equal(d > 0, oracle > 0)
    np.testing.assert_allclose(d, oracle, rtol=1e-4, atol=1e-4)
    assert (d >= 0).all() and np.isfinite(d).all()
    assert (d[:, 48:] > 0).mean() > 0.9 and (d[:, :16] == 0).all()


def test_failed_build_raises(tmp_path, monkeypatch):
    """No numpy fallback: a library that cannot be built raises."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "GXX_FLAGS",
                        native.GXX_FLAGS + ["-no-such-flag"])
    monkeypatch.setattr(native, "_lib", None)
    v, t = np.eye(3, dtype=np.float32), np.array([[0, 1, 2]], np.int64)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.rasterize_depth(v, t, np.eye(4), 8, 8, 8.0, 8.0, 3.5, 3.5)


def test_cull_and_unseen_equal_jax(meshes):
    v, t, _ = meshes[0]
    near, far = np.eye(4), np.eye(4)
    near[2, 3], far[2, 3] = 3.0, -3.0
    for poses in ([near], [far], [near, far]):
        got = cull_mesh.cull(v, t, poses, 64, 64, 40.0, 40.0, 31.5, 31.5)
        assert np.array_equal(got, jax_cull.cull(v, t, poses, 64, 64, 40.0,
                                                 40.0, 31.5, 31.5))
    assert len(cull_mesh.cull(v, t, [near], 64, 64, 40.0, 40.0, 31.5,
                              31.5)) == len(t)
    kw = dict(n_samples=4000)
    got = cull_mesh.unseen_points(v, t, [near], 64, 64, 400.0, 400.0, 31.5,
                                  31.5, **kw)
    want = jax_cull.unseen_points(v, t, [near], 64, 64, 400.0, 400.0, 31.5,
                                  31.5, **kw)
    assert np.array_equal(got, want) and 0 < len(got) < 4000


def test_eval_ate_equals_jax_tool(tmp_path):
    """Both tools on a checkpoint the port wrote."""
    import torch

    from nice_slam_torch.config import load_config
    from nice_slam_torch.engine import SlamEngine

    cfg = load_config(overrides={
        "dataset": "synthetic", "synthetic": {"n_frames": 4},
        "cam": {"H": 12, "W": 16, "fx": 12.0, "fy": 12.0, "cx": 7.5,
                "cy": 5.5, "crop_edge": 0}})
    eng = SlamEngine(cfg, output=str(tmp_path), device="cpu")
    poses = np.stack([np.asarray(eng.dataset[i][3], np.float32)
                      for i in range(4)])
    eng.gt_c2w[:] = poses
    jitter = np.random.RandomState(0).normal(0, 0.02, (4, 3))
    est = poses.copy()
    est[:, :3, 3] += jitter
    eng.est_c2w_dev = torch.as_tensor(est)
    eng.frames_done = 4
    eng.save(str(tmp_path / "ckpts" / "00003.npz"))

    def run(*cmd):
        r = subprocess.run([sys.executable, *cmd, str(tmp_path)], cwd=REPO,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode == 0, r.stderr[-2000:]
        return r.stdout

    got = run("-m", "nice_slam_torch.tools.eval_ate")
    want = run(os.path.join("tools", "eval_ate.py"))
    assert got == want
    stats = json.loads(got[:got.index("}") + 1])
    assert stats["n_pairs"] == 4 and 0 < stats["rmse"] < 0.1
