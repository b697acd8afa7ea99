"""Occupancy-guided sampling in the port against the JAX package:
`occ_guided_zvals` on the same rays and proxy (atol 1e-4), the render of
the colour stage with the proxy (depth, uncertainty, colour atol 1e-4,
rtol 1e-4), `refresh_occ_proxy` on the same map (atol 1e-5), the
mirrors of tests/test_render.py `TestOccGuidedSampling`, an engine run
and checkpoints that carry the proxy both ways."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from nice_slam_tpu import mapping as jmap  # noqa: E402
from nice_slam_tpu.config import load_config as jax_load_config  # noqa: E402
from nice_slam_tpu.engine import SlamEngine as JaxSlamEngine  # noqa: E402
from nice_slam_tpu.models.decoders import nice_model_spec  # noqa: E402
from nice_slam_tpu.ops import occ_guided_zvals as jax_occ_zvals  # noqa: E402
from nice_slam_tpu.render import RenderSpec as JRenderSpec  # noqa: E402
from nice_slam_tpu.render import render_rays as jax_render_rays  # noqa: E402
from nice_slam_tpu.state import make_map_state as jax_make_map_state  # noqa: E402
from test_slam import TEST_CFG  # noqa: E402

from nice_slam_torch import mapping  # noqa: E402
from nice_slam_torch.config import load_config  # noqa: E402
from nice_slam_torch.convert import params_from_jax  # noqa: E402
from nice_slam_torch.engine import SlamEngine  # noqa: E402
from nice_slam_torch.models.decoders import ModelSpec  # noqa: E402
from nice_slam_torch.ops.sampling import (  # noqa: E402
    occ_guided_zvals,
    stratified_zvals,
)
from nice_slam_torch.render import RenderSpec, render_rays  # noqa: E402

BOUND = [[-0.5, 2.5], [-0.5, 2.0], [-0.5, 2.5]]
GRID_LEN = {"coarse": 1.0, "middle": 0.32, "fine": 0.16, "color": 0.16}


def n(x):
    return x.detach().cpu().numpy()


def t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


@pytest.fixture(scope="module")
def scene():
    """A JAX occupancy-guided map with a random proxy, and rays into it."""
    st = jax_make_map_state(jax.random.PRNGKey(2), nice_model_spec(), BOUND,
                            GRID_LEN, 0.32, occ_guided=True)
    rng = np.random.RandomState(0)
    grids = {k: np.asarray(v) for k, v in st.grids.items()}
    grids["occ_proxy"] = rng.rand(*grids["occ_proxy"].shape).astype(
        np.float32)
    o = np.tile(np.array([[1.0, 0.8, 2.4]], np.float32), (24, 1))
    d = rng.randn(24, 3).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2]) - 0.5
    depth = (rng.rand(24) * 2 + 0.5).astype(np.float32)
    depth[3] = 0.0  # a depth hole
    return {"params": jax.tree.map(np.asarray, st.params), "grids": grids,
            "bound": np.asarray(st.bound), "o": o, "d": d, "depth": depth}


def test_occ_guided_zvals_matches_jax(scene):
    s = scene
    near = (s["depth"][:, None] * 0.01 + 0.05).astype(np.float32)
    far = near + 2.0
    want = np.asarray(jax_occ_zvals(
        jnp.asarray(s["o"]), jnp.asarray(s["d"]), jnp.asarray(near),
        jnp.asarray(far), jnp.asarray(s["grids"]["occ_proxy"]),
        jnp.asarray(s["bound"]), 16))
    got = n(occ_guided_zvals(t(s["o"]), t(s["d"]), t(near), t(far),
                             t(s["grids"]["occ_proxy"]), t(s["bound"]), 16))
    assert got.shape == (24, 16)
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert (np.diff(got, axis=1) >= -1e-6).all()


def test_render_rays_occ_guided_matches_jax(scene):
    """The colour stage's render with the proxy steering the stratified
    samples, and lindisp refused as in JAX."""
    s = scene
    out_j = jax_render_rays(
        jax.tree.map(jnp.asarray, s["params"]), nice_model_spec(),
        {k: jnp.asarray(v) for k, v in s["grids"].items()},
        jnp.asarray(s["bound"]), jnp.asarray(s["o"]), jnp.asarray(s["d"]),
        jax.random.PRNGKey(0),
        JRenderSpec(n_samples=12, n_surface=6, occ_guided=True), "color",
        gt_depth=jnp.asarray(s["depth"]))
    rs = RenderSpec(n_samples=12, n_surface=6, occ_guided=True)
    params = params_from_jax(s["params"], device="cpu")
    grids = params_from_jax(s["grids"], device="cpu")
    out_t = render_rays(params, ModelSpec(), grids, t(s["bound"]), t(s["o"]),
                        t(s["d"]), rs, "color", gt_depth=t(s["depth"]))
    for a, b in zip(out_t[:3], out_j[:3]):
        np.testing.assert_allclose(n(a), np.asarray(b), atol=1e-4, rtol=1e-4)
    # the proxy moved the samples: a uniform proxy renders otherwise
    flat = dict(grids, occ_proxy=torch.ones_like(grids["occ_proxy"]))
    d_flat = render_rays(params, ModelSpec(), flat, t(s["bound"]), t(s["o"]),
                         t(s["d"]), rs, "color", gt_depth=t(s["depth"]))[0]
    assert float((d_flat - out_t[0]).abs().max()) > 1e-4
    with pytest.raises(ValueError, match="lindisp"):
        render_rays(params, ModelSpec(), grids, t(s["bound"]), t(s["o"]),
                    t(s["d"]), RenderSpec(n_samples=12, n_surface=6,
                                          occ_guided=True, lindisp=True),
                    "color", gt_depth=t(s["depth"]))


def test_uniform_proxy_matches_stratified():
    bound = t([[0.0, 4.0], [0.0, 4.0], [0.0, 4.0]])
    rays_o, rays_d = t([[2.0, 2.0, 0.1]]), t([[0.0, 0.0, 1.0]])
    near, far = t([[0.5]]), t([[3.5]])
    z = occ_guided_zvals(rays_o, rays_d, near, far, torch.ones(8, 8, 8, 1),
                         bound, 32)
    np.testing.assert_allclose(n(z), n(stratified_zvals(near, far, 32)),
                               atol=0.15)


def test_samples_concentrate_in_occupied_slab():
    """A proxy solid only for world z in [2.4, 3.2] draws most samples
    through that slab and keeps the floor share elsewhere."""
    bound = t([[0.0, 4.0], [0.0, 4.0], [0.0, 4.0]])
    proxy = torch.zeros(10, 10, 10, 1)
    proxy[:, :, 6:8] = 1.0
    rays_o, rays_d = t([[2.0, 2.0, 0.1]]), t([[0.0, 0.0, 1.0]])
    z = occ_guided_zvals(rays_o, rays_d, t([[0.2]]), t([[3.9]]), proxy,
                         bound, 64, floor=0.05)
    assert z.shape == (1, 64)
    zs = n(z[0])
    assert (np.diff(zs) >= -1e-6).all()
    assert zs.min() >= 0.19 and zs.max() <= 3.91
    world_z = 0.1 + zs
    assert ((world_z > 2.2) & (world_z < 3.4)).mean() > 0.5
    assert (world_z < 2.0).sum() >= 2


def test_refresh_occ_proxy_matches_jax(scene):
    s = scene
    want = np.asarray(jmap.refresh_occ_proxy(
        jax.tree.map(jnp.asarray, s["params"]),
        {k: jnp.asarray(v) for k, v in s["grids"].items()},
        jnp.asarray(s["bound"]), nice_model_spec()))
    got = n(mapping.refresh_occ_proxy(
        params_from_jax(s["params"], device="cpu"),
        params_from_jax(s["grids"], device="cpu"), t(s["bound"]),
        ModelSpec()))
    assert got.shape == s["grids"]["occ_proxy"].shape
    np.testing.assert_allclose(got, want, atol=1e-5)


OCC_CFG = {
    "dataset": "synthetic", "synthetic": {"n_frames": 9},
    "cam": {"H": 48, "W": 64, "fx": 48.0, "fy": 48.0, "cx": 31.5,
            "cy": 23.5, "crop_edge": 0},
    "grid_len": GRID_LEN,
    "mapping": {"bound": [[-0.5, 4.5], [-0.5, 3.5], [-0.5, 4.5]],
                "every_frame": 3, "iters_first": 60, "iters": 15,
                "pixels": 240, "mapping_window_size": 3,
                "keyframe_every": 3, "ckpt_freq": 3, "mesh_freq": 10000,
                "color_refine": False},
    "tracking": {"iters": 6, "pixels": 120, "ignore_edge_W": 4,
                 "ignore_edge_H": 4},
    "rendering": {"N_samples": 12, "N_surface": 8,
                  "occupancy_guided": True},
}


def test_engine_occ_guided_run(tmp_path, monkeypatch):
    """tests/test_render.py's end-to-end run on the port: the proxy is
    refreshed after each mapping event (events 0, 3, 6, 8), leaves its
    all-ones init, the ATE stays under 0.3 m, and a resume from the
    event-6 checkpoint holds the proxy bit for bit."""
    refreshed = []
    orig = mapping.refresh_occ_proxy

    def counted(*a, **k):
        out = orig(*a, **k)
        refreshed.append(float(out.min()))
        return out

    monkeypatch.setattr(mapping, "refresh_occ_proxy", counted)
    cfg = load_config(overrides=OCC_CFG)
    eng = SlamEngine(cfg, output=str(tmp_path), device="cpu")
    assert torch.equal(eng.map_state.grids["occ_proxy"],
                       torch.ones_like(eng.map_state.grids["occ_proxy"]))
    eng.run()
    assert len(refreshed) == 4 and refreshed[0] < 0.5, refreshed
    assert float(eng.map_state.grids["occ_proxy"].min()) < 0.5
    rmse = eng.ate()["rmse"]
    assert np.isfinite(rmse) and rmse < 0.3, rmse
    ck = tmp_path / "ckpts" / "00006.npz"
    with np.load(ck) as z:
        saved = z["grids/occ_proxy"]
    res = SlamEngine(cfg, output=str(tmp_path / "r"), device="cpu")
    res.resume(str(ck))
    assert np.array_equal(n(res.map_state.grids["occ_proxy"]), saved)
    assert res.frames_done == 7


def test_port_occ_checkpoint_resumes_in_jax(tmp_path):
    """A port checkpoint of an occupancy-guided engine resumes in the JAX
    package's occupancy-guided engine with the same proxy (exact)."""
    ov = {**TEST_CFG, "synthetic": {"n_frames": 4},
          "rendering": {**TEST_CFG["rendering"], "occupancy_guided": True}}
    eng = SlamEngine(load_config(overrides=ov), output=str(tmp_path / "t"),
                     device="cpu")
    proxy = torch.rand(eng.map_state.grids["occ_proxy"].shape,
                       generator=torch.Generator().manual_seed(1))
    eng.map_state.grids["occ_proxy"] = proxy
    p = str(tmp_path / "t.npz")
    eng.save(p)
    j = JaxSlamEngine(jax_load_config(overrides=ov),
                      output=str(tmp_path / "j")).resume(p)
    assert set(j.map_state.grids) == set(eng.map_state.grids)
    for k, v in eng.map_state.grids.items():
        np.testing.assert_array_equal(np.asarray(j.map_state.grids[k]), n(v),
                                      err_msg=k)
