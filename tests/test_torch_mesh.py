"""The port's mesher against the JAX package's, on the CPU: the host
marching tetrahedra (against its numpy oracle and against the JAX
package's library), PLY files read across the two packages, the mesher's
helpers on the same arrays, `extract_mesh` end to end on the same map
(NICE and iMAP*, with and without cleaning), the forecast mesh's cyan
paint, and meshes written by the engine and by run_torch.py.

The map is made from a numpy seed through the JAX initialisers and
carried across with convert.params_from_jax.  So that the mesh has a
surface, the middle decoder's last block reads its feature directly
(occupancy = the middle grid's channel 0, which holds the signed distance
to a sphere) and the fine decoder's head is scaled down; the other weights
keep their random init.  Tolerances are stated per test."""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from scipy.spatial import cKDTree  # noqa: E402

from nice_slam_tpu import native as jnative  # noqa: E402
from nice_slam_tpu.camera import Camera as JCamera  # noqa: E402
from nice_slam_tpu.models.decoders import imap_model_spec  # noqa: E402
from nice_slam_tpu.models.decoders import nice_model_spec  # noqa: E402
from nice_slam_tpu.state import make_map_state as jax_make_map_state  # noqa: E402
from nice_slam_tpu.utils import mesher as jmesher  # noqa: E402
from nice_slam_tpu.utils import plyio as jplyio  # noqa: E402

from nice_slam_torch import native  # noqa: E402
from nice_slam_torch.camera import Camera  # noqa: E402
from nice_slam_torch.config import load_config  # noqa: E402
from nice_slam_torch.convert import params_from_jax  # noqa: E402
from nice_slam_torch.engine import SlamEngine  # noqa: E402
from nice_slam_torch.models.decoders import ModelSpec  # noqa: E402
from nice_slam_torch.utils import mesher, plyio  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOUND = [[-0.5, 4.5], [-0.5, 3.5], [-0.5, 4.5]]
MC_BOUND = [[0.0, 4.0], [0.0, 3.0], [0.0, 4.0]]
GRID_LEN = {"coarse": 1.0, "middle": 0.32, "fine": 0.16, "color": 0.16}
CENTRE, RADIUS = np.array([2.0, 1.5, 2.0]), 1.0
CAM = dict(H=48, W=64, fx=32.0, fy=32.0, cx=31.5, cy=23.5)
NARROW = dict(CAM, fx=200.0, fy=200.0)
RES = 40
VOXEL = 4.1 / (RES - 1)   # the widest axis' spacing


def sphere_volume(n=24, r=0.6):
    xs = np.linspace(-1, 1, n)
    X, Y, Z = np.meshgrid(xs, xs, xs, indexing="ij")
    vol = (r - np.sqrt(X**2 + Y**2 + Z**2)).astype(np.float32)
    return vol, np.array([-1.0, -1.0, -1.0]), np.full(3, 2.0 / (n - 1))


VOLUMES = {
    "sphere": sphere_volume(),
    "nonuniform": (sphere_volume(n=20)[0], np.array([5.0, -3.0, 1.0]),
                   np.array([0.1, 0.2, 0.3])),
    "random": (np.random.RandomState(0).randn(30, 31, 32).astype(np.float32),
               np.array([0.5, -1.0, 2.0]), np.array([0.1, 0.2, 0.3])),
}


def cameras(xs, z=9.0):
    """Cameras at (x, 1.5, z) looking down -z (identity rotation)."""
    c2w = np.tile(np.eye(4, dtype=np.float32), (len(xs), 1, 1))
    c2w[:, 0, 3] = xs
    c2w[:, 1, 3] = 1.5
    c2w[:, 2, 3] = z
    return c2w


def _node_sdf(bound, shape, centre):
    axes = [np.linspace(bound[a, 0], bound[a, 1], shape[a])
            for a in range(3)]
    X, Y, Z = np.meshgrid(*axes, indexing="ij")
    d = np.sqrt((X - centre[0])**2 + (Y - centre[1])**2
                + (Z - centre[2])**2)
    return (RADIUS - d).astype(np.float32)


def nice_map(seed=2):
    """(JAX spec, port spec, numpy params, numpy grids, numpy bound)."""
    spec_j = nice_model_spec()
    st = jax_make_map_state(jax.random.PRNGKey(seed), spec_j, BOUND,
                            GRID_LEN, 0.32)
    params = jax.tree.map(np.array, st.params)
    grids = {k: np.array(v) for k, v in st.grids.items()}
    bound = np.array(st.bound)
    mid = params["middle"]
    mid["pts"][4]["w"][:] = 0.0
    mid["pts"][4]["b"][:] = 0.0
    mid["fc_c"][4]["w"][:] = np.eye(32, dtype=np.float32)
    mid["fc_c"][4]["b"][:] = 0.0
    mid["out"]["w"][:] = 0.0
    mid["out"]["w"][0, 0] = 1.0
    mid["out"]["b"][:] = 0.0
    params["fine"]["out"]["w"] *= 0.01
    params["fine"]["out"]["b"][:] = 0.0
    g = grids["middle"]
    g[..., 0] = _node_sdf(bound, g.shape, CENTRE)
    # the coarse level passes its channel 0 through (kept positive by an
    # offset of 5 through the ReLUs): its occupancy is the signed distance
    # to a sphere of the same centre, evaluated on the enlarged bound
    co = params["coarse"]
    eye = np.eye(32, dtype=np.float32)
    for i in range(5):
        co["pts"][i]["b"][:] = 0.0
        co["pts"][i]["w"][:] = (np.concatenate([0 * eye, eye]) if i == 3
                                else eye)
    co["out"]["w"][:] = 0.0
    co["out"]["w"][0, 0] = 1.0
    co["out"]["b"][:] = -5.0
    gc = grids["coarse"]
    gc[..., 0] = _node_sdf(bound * 2, gc.shape, CENTRE) + 5.0
    return spec_j, ModelSpec(), params, grids, bound


def imap_map(seed=3):
    """An iMAP* map with a smooth density: the Fourier matrix scaled from
    std 25 to std 0.5."""
    spec_j = imap_model_spec()
    st = jax_make_map_state(jax.random.PRNGKey(seed), spec_j, BOUND,
                            GRID_LEN, 0.32)
    params = jax.tree.map(np.array, st.params)
    params["imap"]["embed"]["B"] /= 50.0
    return (spec_j, ModelSpec(nice=False, coarse=False), params, {},
            np.array(st.bound))


def port_map(params, grids, bound):
    return (params_from_jax(params, device="cpu"),
            params_from_jax(grids, device="cpu"), torch.from_numpy(bound))


# ---------------------------------------------------------------------------
# marching tetrahedra and PLY

@pytest.mark.parametrize("name", ["sphere", "nonuniform"])
def test_marching_matches_numpy_oracle(name):
    """The port's C++ against its numpy oracle: vertices allclose 1e-6,
    triangles equal; an empty volume gives an empty mesh."""
    vol, origin, spacing = VOLUMES[name]
    v1, t1 = native.marching_tetrahedra(vol, 0.0, origin, spacing)
    v2, t2 = native._marching_tetrahedra_numpy(vol, 0.0, origin, spacing)
    assert len(t1) > 500
    np.testing.assert_allclose(v1, v2, atol=1e-6)
    np.testing.assert_array_equal(t1, t2)
    v, t = native.marching_tetrahedra(np.full((5, 5, 5), -1.0, np.float32),
                                      0.0, np.zeros(3), np.ones(3))
    assert v.shape == (0, 3) and t.shape == (0, 3)


@pytest.mark.parametrize("name", list(VOLUMES))
def test_marching_matches_jax_library(name):
    """The port's library against the JAX package's on the same volume:
    identical vertices and triangles."""
    vol, origin, spacing = VOLUMES[name]
    v1, t1 = native.marching_tetrahedra(vol, 0.1, origin, spacing)
    v2, t2 = jnative.marching_tetrahedra(vol, 0.1, origin, spacing)
    assert v1.dtype == v2.dtype and t1.dtype == t2.dtype
    np.testing.assert_array_equal(v1, v2)
    np.testing.assert_array_equal(t1, t2)


@pytest.mark.parametrize("colors", [True, False], ids=["rgb", "plain"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_ply_read_across_packages(tmp_path, writer, colors):
    """A PLY file written by either package reads back equal in the
    other."""
    rng = np.random.RandomState(0)
    v = rng.rand(17, 3).astype(np.float32)
    t = rng.randint(0, 17, (9, 3)).astype(np.int64)
    c = rng.randint(0, 256, (17, 3)).astype(np.uint8) if colors else None
    path = str(tmp_path / "m.ply")
    write, read = ((plyio.write_ply, jplyio.read_ply) if writer == "port"
                   else (jplyio.write_ply, plyio.read_ply))
    write(path, v, t, c)
    v2, t2, c2 = read(path)
    np.testing.assert_array_equal(v2, v)
    np.testing.assert_array_equal(t2, t)
    if colors:
        np.testing.assert_array_equal(c2, c)
    else:
        assert c2 is None


# ---------------------------------------------------------------------------
# helpers on the same arrays

def test_compose_forecast_occupancy_equals_jax():
    rng = np.random.RandomState(1)
    occ_f = rng.randn(1000).astype(np.float32)
    occ_c = rng.randn(1000).astype(np.float32)
    seen, hull = rng.rand(1000) > 0.5, rng.rand(1000) > 0.3
    a = mesher.compose_forecast_occupancy(occ_f, occ_c, seen, hull)
    b = jmesher.compose_forecast_occupancy(occ_f, occ_c, seen, hull)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("largest", [False, True], ids=["area", "largest"])
def test_component_filter_equals_jax(largest):
    """On two spheres of different size and some stray triangles."""
    vol, origin, spacing = sphere_volume(n=20)
    small = np.maximum(vol, (0.25 - np.sqrt(np.sum(np.stack(np.meshgrid(
        *[np.linspace(-1, 1, 20) - 0.7] * 3, indexing="ij")) ** 2,
        axis=0))).astype(np.float32))
    v, t = native.marching_tetrahedra(small, 0.0, origin, spacing)
    a = mesher._component_filter(v, t, largest, 0.2)
    b = jmesher._component_filter(v, t, largest, 0.2)
    np.testing.assert_array_equal(a, b)
    assert 0 < len(a) <= len(t)


def test_hull_mask_equals_jax():
    """The hull of two keyframes' backprojected depth: the same mask on
    the same points; no depth gives None in both."""
    rng = np.random.RandomState(2)
    pts = rng.uniform(-1, 5, (20000, 3)).astype(np.float32)
    c2w = cameras([1.0, 3.0])
    depth = np.full((2, CAM["H"], CAM["W"]), 12.0, np.float32)
    depth[1, :10] = 0.0
    a = mesher._hull_mask(pts, c2w, depth, Camera(**CAM), 1.02)
    b = jmesher._hull_mask(pts, c2w, depth, JCamera(**CAM), 1.02)
    np.testing.assert_array_equal(a, b)
    assert 0 < a.sum() < len(a)
    zero = np.zeros_like(depth)
    assert mesher._hull_mask(pts, c2w, zero, Camera(**CAM), 1.02) is None
    assert jmesher._hull_mask(pts, c2w, zero, JCamera(**CAM), 1.02) is None


@pytest.mark.parametrize("depth_test", [False, True], ids=["frustum",
                                                          "depth"])
def test_seen_mask_close_to_jax(depth_test):
    """Visibility of 60,000 points in three keyframes (one not valid in
    JAX's padded store, left out in the port's): the masks differ on at
    most 1e-4 of the points (projections that round across an image
    edge)."""
    rng = np.random.RandomState(3)
    pts = rng.uniform(-1, 5, (60000, 3)).astype(np.float32)
    c2w = cameras([0.5, 3.5, 2.0])
    depth = rng.uniform(4.0, 10.0, (3, CAM["H"], CAM["W"])).astype(
        np.float32)
    valid = np.array([True, True, False])
    want = np.asarray(jmesher._seen_mask_chunked(
        pts, c2w, depth, valid, JCamera(**NARROW), 16384, depth_test))
    got = mesher._seen_mask_chunked(
        torch.from_numpy(pts), torch.from_numpy(c2w[:2]),
        torch.from_numpy(depth[:2]), Camera(**NARROW), 16384,
        depth_test).numpy()
    assert 0.05 < want.mean() < 0.95
    assert np.mean(got != want) <= 1e-4


# ---------------------------------------------------------------------------
# extract_mesh end to end

def _chamfer(a, b):
    return 0.5 * (cKDTree(b).query(a)[0].mean()
                  + cKDTree(a).query(b)[0].mean())


@pytest.mark.parametrize("clean", [True, False], ids=["clean", "raw"])
@pytest.mark.parametrize("mode", ["nice", "imap"])
def test_extract_mesh_matches_jax(mode, clean):
    """Resolution 40, two keyframes (one sees the whole volume): the
    occupancy volume within 1e-5 x max(1, max|occ|), vertex and triangle
    counts within 2 %, symmetric mean Chamfer distance below 0.25 voxel,
    NICE vertex colours within 2/255 at matched vertices.  iMAP* meshes at
    the volume's median density; its colours (normal rays) are held
    against JAX on the same vertices in the next test."""
    spec_j, spec, params, grids, bound = (nice_map() if mode == "nice"
                                          else imap_map())
    p_t, g_t, b_t = port_map(params, grids, bound)
    c2w = cameras([2.0, 3.5])
    depth = np.full((2, CAM["H"], CAM["W"]), 12.0, np.float32)
    cams = [CAM, NARROW]
    level = 0.0
    axes = [np.linspace(MC_BOUND[a][0] - 0.05, MC_BOUND[a][1] + 0.05, RES)
            for a in range(3)]
    pts = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(
        -1, 3).astype(np.float32)
    stage = "fine" if mode == "nice" else "color"
    occ_j = np.asarray(jmesher._eval_volume_chunked(
        params, spec_j, grids, bound, pts, stage, 65536))[:, 3]
    occ_t = mesher._eval_volume_chunked(p_t, spec, g_t, b_t,
                                        torch.from_numpy(pts), stage, 65536,
                                        3).numpy()
    tol = 1e-5 * max(1.0, float(np.abs(occ_j).max()))
    assert np.abs(occ_t - occ_j).max() <= tol
    if mode == "imap":
        level = float(np.median(occ_j))
    ms_j = jmesher.MeshSpec(resolution=RES, level_set=level,
                            clean_mesh=clean, color=mode == "nice")
    ms_t = mesher.MeshSpec(resolution=RES, level_set=level,
                           clean_mesh=clean)
    vj, tj, cj = jmesher.extract_mesh(
        params, spec_j, grids, bound, MC_BOUND, JCamera(**cams[0]), ms_j,
        kf_c2w=c2w, kf_depth=depth, n_keyframes=2)
    vt, tt, ct = mesher.extract_mesh(
        p_t, spec, g_t, b_t, MC_BOUND, Camera(**cams[0]), ms_t,
        kf_c2w=torch.from_numpy(c2w), kf_depth=torch.from_numpy(depth),
        n_keyframes=2)
    assert len(vj) > 500 and len(tj) > 500
    assert abs(len(vt) - len(vj)) <= 0.02 * len(vj)
    assert abs(len(tt) - len(tj)) <= 0.02 * len(tj)
    assert _chamfer(vt, vj) < 0.25 * VOXEL
    assert ct.dtype == np.uint8 and ct.shape == vt.shape
    if mode == "nice":
        d, k = cKDTree(vj).query(vt)
        match = d < 1e-3 * VOXEL
        assert match.mean() > 0.9
        diff = np.abs(ct[match].astype(int) - cj[k[match]].astype(int))
        assert diff.max() <= 2


def test_imap_normal_colors_match_jax():
    """iMAP* vertex colours from rays along the vertex normals, on the
    same mesh in both packages: within 2/255.  The head's biases are
    raised (rgb 0.5, density 10) so that the rays composite a colour."""
    spec_j, spec, params, grids, bound = imap_map()
    params["imap"]["out"]["b"][:] = [0.5, 0.5, 0.5, 10.0]
    p_t, g_t, b_t = port_map(params, grids, bound)
    v, t = native.marching_tetrahedra(*VOLUMES["sphere"][:1], 0.0,
                                      *VOLUMES["sphere"][1:])
    v = v * 1.5 + CENTRE.astype(np.float32)
    want = jmesher._imap_normal_colors(params, spec_j, grids, bound, v, t,
                                       2048)
    got = mesher._imap_normal_colors(p_t, spec, g_t, b_t, v, t, 65536)
    assert got.dtype == np.uint8 and got.shape == v.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 2
    assert want.std() > 1.0


def test_forecast_mesh_paints_cyan(tmp_path):
    """mesh_coarse_level: two narrow keyframes leave a strip of the sphere
    unseen but inside their hull; it comes from the coarse level and is
    painted cyan, the seen parts are not (the JAX package's
    TestForecastMeshing)."""
    _, spec, params, grids, bound = nice_map()
    p_t, g_t, b_t = port_map(params, grids, bound)
    c2w = cameras([0.5, 3.5])
    depth = np.full((2, CAM["H"], CAM["W"]), 12.0, np.float32)
    out = str(tmp_path / "forecast.ply")
    v, t, c = mesher.extract_mesh(
        p_t, spec, g_t, b_t, MC_BOUND, Camera(**NARROW),
        mesher.MeshSpec(resolution=RES, forecast=True),
        kf_c2w=c2w, kf_depth=depth, n_keyframes=2, out_path=out)
    assert len(v) and len(t) and c is not None
    cyan = (c == np.array([0, 255, 255], np.uint8)).all(axis=1)
    assert 0 < cyan.sum() < len(v), f"{cyan.sum()}/{len(v)}"
    assert os.path.exists(out)


# ---------------------------------------------------------------------------
# the engine and the CLI

TINY = {"dataset": "synthetic", "synthetic": {"n_frames": 5},
        "cam": {"H": 24, "W": 32, "fx": 24.0, "fy": 24.0, "cx": 15.5,
                "cy": 11.5, "crop_edge": 0},
        "mapping": {"every_frame": 3, "iters_first": 30, "iters": 4,
                    "pixels": 100, "keyframe_every": 3, "mesh_freq": 3,
                    "ckpt_freq": 100},
        "tracking": {"iters": 3, "pixels": 50, "ignore_edge_W": 2,
                     "ignore_edge_H": 2},
        "rendering": {"N_samples": 8, "N_surface": 4},
        "meshing": {"resolution": 24, "eval_rec": True}}


def test_engine_mesher_hook_writes_meshes(tmp_path):
    """SlamEngine(mesher_hook=engine_mesher_hook) writes a mesh at frame
    mesh_freq and the final mesh, with the eval_rec mesh beside it, and
    adds the mesh's parts to its timings."""
    cfg = load_config(overrides=TINY)
    eng = SlamEngine(cfg, output=str(tmp_path), device="cpu",
                     mesher_hook=mesher.engine_mesher_hook)
    eng.run()
    for name in ("00003_mesh.ply", "final_mesh.ply",
                 "final_mesh_eval_rec.ply"):
        v, t, c = plyio.read_ply(str(tmp_path / "mesh" / name))
        assert len(v) and len(t) and c is not None, name
    assert eng.timings["mesh_query"] > 0 and eng.timings["mesh_march"] > 0


def test_run_torch_meshes_by_default(tmp_path):
    """run_torch.py --device cpu writes mesh/final_mesh.ply by default and
    no mesh with --no-mesh."""
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(
        f"inherit_from: {os.path.join(REPO, 'configs', 'Synthetic', 'synthetic.yaml')}\n"
        "synthetic: {n_frames: 3}\n"
        "cam: {H: 24, W: 32, fx: 24.0, fy: 24.0, cx: 15.5, cy: 11.5}\n"
        "mapping: {every_frame: 2, iters_first: 20, iters: 4, pixels: 100,"
        " keyframe_every: 2}\n"
        "tracking: {iters: 3, pixels: 50, ignore_edge_W: 2,"
        " ignore_edge_H: 2}\n"
        "rendering: {N_samples: 8, N_surface: 4}\n"
        "meshing: {resolution: 20}\n")
    for extra, want in (([], True), (["--no-mesh"], False)):
        out = tmp_path / ("mesh" if want else "nomesh")
        r = subprocess.run(
            [sys.executable, os.path.join(REPO, "run_torch.py"), str(cfg),
             "--device", "cpu", "--output", str(out)] + extra,
            cwd=REPO, capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, r.stderr[-2000:]
        assert (out / "mesh" / "final_mesh.ply").exists() == want
        assert (out / "traj_est.npy").exists()
