"""iMAP* mode of the port against the JAX package: the NeRF, `same` and
`fc_relu` embeddings, the imap decoder tree and its output, density
compositing, sample_pdf (the JAX key's uniforms fed in, and det),
render_rays with N_importance at perturb 0 (deterministic in both), the
regulation term (the same jitter draws), the iMAP* mapping loss and its
gradients, the learning-rate tree and StepLR, and a 5-frame run from the
same decoders.  Tolerances are stated per test."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from nice_slam_tpu import mapping as jmap  # noqa: E402
from nice_slam_tpu import render as jrender  # noqa: E402
from nice_slam_tpu.camera import Camera as JCamera  # noqa: E402
from nice_slam_tpu.config import load_config as jax_load_config  # noqa: E402
from nice_slam_tpu.engine import SlamEngine as JaxSlamEngine  # noqa: E402
from nice_slam_tpu.models import embedding as jemb  # noqa: E402
from nice_slam_tpu.models.decoders import (  # noqa: E402
    imap_model_spec,
    init_model as jax_init_model,
    model_apply as jax_model_apply,
)
from nice_slam_tpu.ops import cam_from_tensor, rays_from_uv  # noqa: E402
from nice_slam_tpu.ops import raw2outputs as jax_raw2outputs  # noqa: E402
from nice_slam_tpu.ops import sample_pdf as jax_sample_pdf  # noqa: E402
from nice_slam_tpu.ops import sample_pixels as jax_sample_pixels  # noqa: E402
from nice_slam_tpu.ops import tensor_from_cam as jax_tensor_from_cam  # noqa: E402
from test_slam import TEST_CFG  # noqa: E402

from nice_slam_torch import mapping, render  # noqa: E402
from nice_slam_torch.camera import Camera  # noqa: E402
from nice_slam_torch.config import load_config  # noqa: E402
from nice_slam_torch.convert import params_from_jax  # noqa: E402
from nice_slam_torch.engine import SlamEngine  # noqa: E402
from nice_slam_torch.models import embedding  # noqa: E402
from nice_slam_torch.models.decoders import (  # noqa: E402
    ModelSpec,
    init_model,
    model_apply,
)
from nice_slam_torch.ops.composite import raw2outputs  # noqa: E402
from nice_slam_torch.ops.sampling import sample_pdf  # noqa: E402
from nice_slam_torch.ops.tree import tree_leaves, tree_map  # noqa: E402
from nice_slam_torch.utils.datasets import get_dataset  # noqa: E402

BOUND = np.array([[-0.5, 4.5], [-0.5, 3.5], [-0.5, 4.5]], np.float32)
CAM = dict(H=30, W=40, fx=30.0, fy=30.0, cx=19.5, cy=14.5)
GRAD = dict(atol=1e-4, rtol=1e-3)


def n(x):
    return x.detach().cpu().numpy()


def t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def cpu(tree):
    return params_from_jax(tree, device="cpu")


@pytest.fixture(scope="module")
def imap_params():
    spec = imap_model_spec()
    return jax.tree.map(np.asarray, jax_init_model(jax.random.PRNGKey(3),
                                                   spec))


@pytest.fixture(scope="module")
def rays():
    rng = np.random.RandomState(0)
    cam = np.array([0.95, 0.1, -0.2, 0.05, 2.0, 1.5, 3.8], np.float32)
    c2w = np.asarray(cam_from_tensor(cam))
    i = rng.randint(0, 40, 24).astype(np.float32)
    j = rng.randint(0, 30, 24).astype(np.float32)
    o, d = rays_from_uv(i, j, c2w, 30.0, 30.0, 19.5, 14.5)
    depth = (rng.rand(24) * 2 + 1.0).astype(np.float32)
    return np.asarray(o), np.asarray(d), depth


@pytest.mark.parametrize("method,name", [
    ("nerf", "color"), ("nerf", "imap"), ("same", "imap"),
    ("fc_relu", "imap")])
def test_embeddings_match_jax(method, name):
    """atol 1e-5 (sin/cos of arguments up to ~2,600 in fp32)."""
    x = (np.random.RandomState(1).rand(64, 3) * 8 - 3).astype(np.float32)
    params = {}
    if method == "fc_relu":
        rng = np.random.RandomState(2)
        params = {"w": rng.randn(3, 93).astype(np.float32),
                  "b": rng.randn(93).astype(np.float32)}
    want = np.asarray(jemb.apply_embedding(params, x, method, name))
    got = n(embedding.apply_embedding(cpu(params), t(x), method, name))
    assert got.shape[-1] == embedding.embedding_dim(method, name) \
        == jemb.embedding_dim(method, name)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_imap_decoder_tree_and_output(imap_params):
    """The imap tree has the JAX package's keys and shapes (no fc_c, a
    calibrated head); with the JAX weights carried over, the decoder's
    (N, 4) output agrees to rtol 1e-5 (atol 1e-6)."""
    port = init_model(torch.Generator().manual_seed(0),
                      ModelSpec(nice=False, coarse=False), device="cpu")
    shapes = tree_map(lambda a: tuple(a.shape), port)
    assert shapes == jax.tree.map(lambda a: tuple(a.shape), imap_params,
                                  is_leaf=lambda a: isinstance(a, np.ndarray))
    assert set(port["imap"]) == {"embed", "pts", "out"}
    assert [w["w"].shape for w in port["imap"]["pts"]] == [
        (93, 256), (256, 256), (256, 256), (256, 256)]
    assert port["imap"]["out"]["b"][3].item() == np.float32(-0.2)
    p = (np.random.RandomState(4).rand(200, 3) * 5 - 0.5).astype(np.float32)
    want = np.asarray(jax_model_apply(imap_params, imap_model_spec(), {},
                                      BOUND, p, "color"))
    got = n(model_apply(cpu(imap_params), ModelSpec(nice=False,
                                                    coarse=False),
                        {}, t(BOUND), t(p), "color"))
    assert got.shape == (200, 4)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_density_raw2outputs(rays):
    """Density compositing (1e10 tail, |d|-scaled dists, relu sigma):
    atol 1e-5, rtol 1e-5."""
    _, d, _ = rays
    rng = np.random.RandomState(5)
    raw = rng.randn(24, 10, 4).astype(np.float32) * 3
    z = np.sort(rng.rand(24, 10).astype(np.float32) * 4, axis=-1)
    want = jax_raw2outputs(raw, z, d, occupancy=False)
    got = raw2outputs(t(raw), t(z), t(d), occupancy=False)
    for a, b in zip(got, want):
        np.testing.assert_allclose(n(a), np.asarray(b), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("det", [False, True], ids=["random", "det"])
def test_sample_pdf(det):
    """sample_pdf with the JAX key's own uniforms fed in (or det):
    atol 1e-5, including a zero-weight row (the 1e-5 guard) and draws on
    the CDF's flat parts (the denom < 1e-5 guard)."""
    rng = np.random.RandomState(6)
    bins = np.sort(rng.rand(16, 12).astype(np.float32) * 5, axis=-1)
    w = rng.rand(16, 11).astype(np.float32)
    w[0] = 0.0
    w[1, 3:] = 0.0
    key = jax.random.PRNGKey(7)
    want = np.asarray(jax_sample_pdf(key, bins, w, 9, det=det))
    u = None if det else t(jax.random.uniform(key, (16, 9)))
    got = n(sample_pdf(t(bins), t(w), 9, det=det, u=u))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_render_rays_importance(imap_params, rays):
    """render_rays in iMAP* mode (density, 12 + 6 importance samples, no
    surface samples) at perturb 0: depth, uncertainty, colour, weights
    and the gradient of a weighted sum of them with respect to the decoder,
    atol 1e-4 rtol 1e-4 (gradients GRAD)."""
    o, d, depth = rays
    spec = imap_model_spec()
    rj = jrender.RenderSpec(n_samples=12, n_surface=0, n_importance=6,
                            occupancy=False)
    rt = render.RenderSpec(n_samples=12, n_surface=0, n_importance=6,
                           occupancy=False)
    w_out = np.random.RandomState(8).randn(24, 5).astype(np.float32)

    def jloss(params):
        dd, var, col, _ = jrender.render_rays(
            params, spec, {}, BOUND, o, d, jax.random.PRNGKey(0), rj,
            "color", gt_depth=depth)
        return jnp.sum(jnp.concatenate([dd[:, None], var[:, None], col],
                                       -1) * w_out), (dd, var, col)

    (_, outs_j), g_j = jax.value_and_grad(jloss, has_aux=True)(imap_params)
    params_t = tree_map(lambda a: a.requires_grad_(True), cpu(imap_params))
    mt = ModelSpec(nice=False, coarse=False)
    dd, var, col, wts = render.render_rays(params_t, mt, {}, t(BOUND), t(o),
                                           t(d), rt, "color",
                                           gt_depth=t(depth))
    assert wts.shape == (24, 18)
    for a, b in zip((dd, var, col), outs_j):
        np.testing.assert_allclose(n(a), np.asarray(b), atol=1e-4,
                                   rtol=1e-4)
    loss = torch.sum(torch.cat([dd[:, None], var[:, None], col], -1)
                     * t(w_out))
    grads = torch.autograd.grad(loss, tree_leaves(params_t))
    want = tree_leaves(tree_map(lambda x, g: g, params_t, g_j))
    for a, b in zip(grads, want):
        np.testing.assert_allclose(n(a), np.asarray(b), **GRAD)


def test_regulation_sigma(imap_params, rays):
    """The free-space regulation term with the same jitter draws: atol
    1e-5 rtol 1e-5."""
    o, d, depth = rays
    key = jax.random.PRNGKey(9)
    want = np.asarray(jrender.regulation_sigma(
        imap_params, imap_model_spec(), {}, BOUND, o, d, depth, key, 10))
    u = t(jax.random.uniform(key, (24, 10)))
    got = n(render.regulation_sigma(
        cpu(imap_params), ModelSpec(nice=False, coarse=False), {}, t(BOUND),
        t(o), t(d), t(depth), 10, u=u))
    assert got.shape == (240,)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def frames():
    cfg = load_config(overrides={
        "dataset": "synthetic", "synthetic": {"n_frames": 6},
        "cam": {**CAM, "crop_edge": 0},
        "mapping": {"bound": BOUND.tolist()}})
    ds = get_dataset(cfg)
    return [ds[i] for i in (1, 3, 5)]


@pytest.mark.parametrize("stage", ["middle", "color"])
def test_mapping_loss_and_gradients(imap_params, frames, stage):
    """The iMAP* mapping loss (no AABB mask, the colour term in every
    stage, 0.0005 |sigma| regulation) on the JAX key's pixel and jitter
    draws: loss rtol 1e-4, decoder and camera gradients GRAD."""
    colors = np.stack([f[1] for f in frames]).astype(np.float32)
    depths = np.stack([f[2] for f in frames]).astype(np.float32)
    c2ws = np.stack([f[3] for f in frames]).astype(np.float32)
    valid = np.array([True, False, True])
    cams = np.asarray(jax_tensor_from_cam(c2ws[:, :3, :]))
    wj = {"colors": colors, "depths": depths, "c2ws": c2ws, "valid": valid}
    wt = {"colors": t(colors), "depths": t(depths), "c2ws": t(c2ws),
          "valid": torch.from_numpy(valid)}
    mj = jmap.MapSpec(pixels=60, nice=False, w_color_loss=0.05)
    mt = mapping.MapSpec(pixels=60, nice=False, w_color_loss=0.05)
    rj = jrender.RenderSpec(n_samples=10, n_surface=0, n_importance=4,
                            occupancy=False)
    rt = render.RenderSpec(n_samples=10, n_surface=0, n_importance=4,
                           occupancy=False)
    key = jax.random.PRNGKey(12)
    keys = jax.random.split(key, 3)
    ij = [jax_sample_pixels(k, 20, 0, CAM["H"], 0, CAM["W"]) for k in keys]
    pix = (t(np.stack([np.asarray(a) for a, _ in ij])),
           t(np.stack([np.asarray(b) for _, b in ij])))
    k2, _ = jax.random.split(key)
    _, ks = jax.random.split(k2)
    reg_u = t(jax.random.uniform(ks, (60, 10)))
    tree_j = {"params": imap_params, "grids": {}, "cams": cams}
    loss_j, g_j = jax.value_and_grad(jmap.mapping_loss)(
        tree_j, wj, BOUND, key, JCamera(**CAM), stage, mj, rj,
        imap_model_spec())
    tr = {"params": tree_map(lambda a: a.requires_grad_(True),
                             cpu(imap_params)),
          "grids": {}, "cams": t(cams).requires_grad_(True)}
    loss_t = mapping.mapping_loss(tr, wt, t(BOUND), Camera(**CAM), stage, mt,
                                  rt, ModelSpec(nice=False, coarse=False),
                                  pix=pix, reg_u=reg_u)
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-4)
    live = tree_leaves(tr)
    grads = torch.autograd.grad(loss_t, live)
    want = tree_leaves(tree_map(lambda x, g: g, tr, g_j))
    for a, b in zip(grads, want):
        np.testing.assert_allclose(n(a), np.asarray(b), **GRAD)


@pytest.mark.parametrize("ba", [False, True], ids=["no_ba", "ba"])
def test_lr_tree_and_steplr(imap_params, ba):
    """iMAP*'s learning-rate tree: every decoder leaf at imap_decoders_lr,
    no grids, cameras live (at ba_cam_lr x mask) only with BA; StepLR(200,
    0.8) at Adam steps 0 / 199 / 200 / 400 as in the JAX mapping loop
    (rtol 1e-6)."""
    tree = {"params": cpu(imap_params), "grids": {}, "cams": torch.zeros(3, 7)}
    mask = t([0.0, 1.0, 1.0])
    mt = mapping.MapSpec(nice=False, ba=ba, ba_cam_lr=0.0002)
    lr, frozen = mapping._lr_tree(tree, "color", mt, 1.0, mask)
    lr_j, frozen_j = jmap._lr_tree(
        {"params": imap_params, "grids": {}, "cams": np.zeros((3, 7))},
        "color", jmap.MapSpec(nice=False, ba=ba, ba_cam_lr=0.0002), 1.0,
        np.asarray(mask), ba=True)
    assert set(tree_leaves(lr["params"])) == {0.0002}
    assert tree_leaves(tree_map(lambda x, f: f, tree["params"],
                                frozen["params"])) == tree_leaves(
        tree_map(lambda x, f: f, tree["params"], frozen_j["params"]))
    assert lr["grids"] == {} and frozen["grids"] == {}
    assert frozen["cams"] is (not ba)
    want_cams = np.asarray(lr_j["cams"]) if ba else np.zeros((3, 7))
    np.testing.assert_allclose(n(lr["cams"]), want_cams, rtol=1e-6)
    for step in (0, 199, 200, 400):
        want = float(0.8 ** (jnp.int32(step) // 200).astype(jnp.float32))
        np.testing.assert_allclose(mapping.imap_lr_scale(step), want,
                                   rtol=1e-6)


IMAP_CFG = {
    **TEST_CFG, "scale": 1.0, "synthetic": {"n_frames": 5},
    "mapping": {**TEST_CFG["mapping"], "iters_first": 60, "iters": 15,
                "pixels": 300},
    "tracking": {**TEST_CFG["tracking"], "iters": 5, "pixels": 120},
    "rendering": {"N_samples": 16, "N_surface": 0, "N_importance": 8}}


def test_imap_end_to_end_close_to_jax(tmp_path):
    """TestImapMode's 5-frame run (tests/test_slam.py:235-256) through both
    engines from the same decoder.  The two draw different random streams,
    so this compares results: both ATEs < 0.5 m and within 0.1 m of each
    other.  The port keeps no grids and saves its final checkpoint."""
    eng_j = JaxSlamEngine(jax_load_config(nice=False, overrides=IMAP_CFG),
                          output=str(tmp_path / "jax"))
    eng_t = SlamEngine(load_config(nice=False, overrides=IMAP_CFG),
                       output=str(tmp_path / "torch"), device="cpu")
    assert eng_t.map_state.grids == {}
    eng_t.map_state.params = cpu(jax.tree.map(np.asarray,
                                              eng_j.map_state.params))
    eng_j.run()
    eng_t.run()
    ate_j, ate_t = eng_j.ate()["rmse"], eng_t.ate()["rmse"]
    assert eng_t.frames_done == 5 and np.isfinite(eng_t.est_c2w).all()
    assert ate_j < 0.5 and ate_t < 0.5, (ate_j, ate_t)
    assert abs(ate_t - ate_j) < 0.1, (ate_j, ate_t)
    assert (tmp_path / "torch" / "ckpts" / "00004.npz").exists()
