"""The port's tracking, keyframe and mapping pieces against the JAX
package's on the same map (carried across), the same synthetic frames and
the same random draws (pixels and selection scores drawn by JAX and
passed in).  Tolerances: losses rtol 1e-4; gradients atol 1e-4,
rtol 1e-3; one Adam step atol 1e-5 where the update's sign is set."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from nice_slam_tpu import keyframes as jkf  # noqa: E402
from nice_slam_tpu import mapping as jmap  # noqa: E402
from nice_slam_tpu import tracking as jtrack  # noqa: E402
from nice_slam_tpu.camera import Camera as JCamera  # noqa: E402
from nice_slam_tpu.models.decoders import nice_model_spec  # noqa: E402
from nice_slam_tpu.ops import sample_pixels as jax_sample_pixels  # noqa: E402
from nice_slam_tpu.ops import tensor_from_cam as jax_tensor_from_cam  # noqa: E402
from nice_slam_tpu.render import RenderSpec as JRenderSpec  # noqa: E402
from nice_slam_tpu.state import make_map_state as jax_make_map_state  # noqa: E402

from nice_slam_torch import keyframes, mapping, tracking  # noqa: E402
from nice_slam_torch.camera import Camera  # noqa: E402
from nice_slam_torch.config import load_config  # noqa: E402
from nice_slam_torch.convert import params_from_jax  # noqa: E402
from nice_slam_torch.models.decoders import ModelSpec  # noqa: E402
from nice_slam_torch.ops.tree import tree_leaves, tree_map  # noqa: E402
from nice_slam_torch.render import RenderSpec  # noqa: E402
from nice_slam_torch.utils.datasets import get_dataset  # noqa: E402

CAM = dict(H=30, W=40, fx=30.0, fy=30.0, cx=19.5, cy=14.5)
BOUND = [[-0.5, 4.5], [-0.5, 3.5], [-0.5, 4.5]]
GRAD = dict(atol=1e-4, rtol=1e-3)


def n(x):
    return x.detach().cpu().numpy()


def t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


@pytest.fixture(scope="module")
def world():
    cfg = load_config(overrides={
        "dataset": "synthetic", "synthetic": {"n_frames": 6},
        "cam": {**CAM, "crop_edge": 0}, "mapping": {"bound": BOUND}})
    ds = get_dataset(cfg)
    frames = [ds[i] for i in range(6)]
    st = jax_make_map_state(jax.random.PRNGKey(0), nice_model_spec(), BOUND,
                            {"coarse": 1.0, "middle": 0.32, "fine": 0.16,
                             "color": 0.16}, 0.32)
    params = jax.tree.map(np.asarray, st.params)
    grids = {k: np.asarray(v) for k, v in st.grids.items()}
    return {"frames": frames, "params": params, "grids": grids,
            "bound": np.asarray(st.bound), "jcam": JCamera(**CAM),
            "tcam": Camera(**CAM),
            "rj": JRenderSpec(n_samples=12, n_surface=6),
            "rt": RenderSpec(n_samples=12, n_surface=6)}


def test_tracking_loss_and_camera_gradient(world):
    _, color, depth, pose = world["frames"][2]
    cam = np.asarray(jax_tensor_from_cam(pose)) + np.array(
        [0.0, 0.01, -0.01, 0.005, 0.03, -0.02, 0.02], np.float32)
    tj = jtrack.TrackSpec(pixels=60, ignore_edge_w=2, ignore_edge_h=2)
    tt = tracking.TrackSpec(pixels=60, ignore_edge_w=2, ignore_edge_h=2)
    key = jax.random.PRNGKey(3)
    kpix, _ = jax.random.split(key)
    i, j = jax_sample_pixels(kpix, 60, 2, CAM["H"] - 2, 2, CAM["W"] - 2)
    loss_j, g_j = jax.value_and_grad(jtrack.tracking_loss)(
        cam, world["params"], world["grids"], world["bound"], color, depth,
        key, world["jcam"], tj, world["rj"], nice_model_spec())
    c = t(cam).requires_grad_(True)
    loss_t = tracking.tracking_loss(
        c, params_from_jax(world["params"], device="cpu"),
        params_from_jax(world["grids"], device="cpu"),
        t(world["bound"]), t(color), t(depth), world["tcam"], tt,
        world["rt"], ModelSpec(), pix=(t(i), t(j)))
    (g_t,) = torch.autograd.grad(loss_t, c)
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-4)
    np.testing.assert_allclose(n(g_t), np.asarray(g_j), **GRAD)


def test_masked_median_lower_middle():
    x = torch.tensor([5.0, 1.0, 4.0, 2.0, 9.0])
    m = torch.tensor([True, True, True, True, False])
    assert float(tracking.masked_median(x, m)) == float(
        jtrack.masked_median(jnp.asarray(n(x)), jnp.asarray(n(m))))
    assert float(tracking.masked_median(x, m)) == 2.0


def _stores(world, n_kf=4, capacity=6):
    js = jkf.make_store(capacity, CAM["H"], CAM["W"])
    ts = keyframes.make_store(capacity, CAM["H"], CAM["W"], device="cpu")
    for f in range(n_kf):
        _, color, depth, pose = world["frames"][f]
        js = jkf.add_keyframe(js, jnp.asarray(color), jnp.asarray(depth),
                              jnp.asarray(pose), jnp.asarray(pose), f)
        keyframes.add_keyframe(ts, t(color), t(depth), t(pose), t(pose), f)
    return js, ts


def test_keyframe_store_and_overlap_selection(world):
    js, ts = _stores(world)
    np.testing.assert_array_equal(n(ts.colors), np.asarray(js.colors))
    _, color, depth, pose = world["frames"][4]
    key = jax.random.PRNGKey(7)
    kp, kr = jax.random.split(key)
    i, j = jax_sample_pixels(kp, 100, 0, CAM["H"], 0, CAM["W"])
    u = jax.random.uniform(kr, (js.capacity,))
    for k in (2, 8):   # k above the capacity exercises the padding
        sj, vj = jkf.select_keyframes_overlap(
            key, js, jnp.asarray(color), jnp.asarray(depth),
            jnp.asarray(pose), world["jcam"], k)
        st_, vt = keyframes.select_keyframes_overlap(
            ts, t(depth), t(pose), world["tcam"], k, pix=(t(i), t(j)),
            scores_u=t(u))
        np.testing.assert_array_equal(n(vt), np.asarray(vj))
        np.testing.assert_array_equal(n(st_)[n(vt)], np.asarray(sj)[
            np.asarray(vj)])
    pts = np.random.RandomState(0).rand(50, 3).astype(np.float32) * 3
    for a, b in zip(keyframes.project_points(t(pts), t(pose), world["tcam"]),
                    jkf.project_points(pts, pose, world["jcam"])):
        np.testing.assert_allclose(n(a), np.asarray(b), atol=1e-3,
                                   rtol=1e-5)


def test_prepare_mapping_matches_jax(world):
    """Selection, window, frustum masks, window cameras and the BA mask
    (oldest valid keyframe frozen) from the same draws."""
    js, ts = _stores(world)
    _, color, depth, pose = world["frames"][5]
    mj = jmap.MapSpec(window_size=5)
    key = jax.random.PRNGKey(11)
    ksel, _ = jax.random.split(key)
    kp, kr = jax.random.split(ksel)
    i, j = jax_sample_pixels(kp, 100, 0, CAM["H"], 0, CAM["W"])
    u = jax.random.uniform(kr, (js.capacity,))
    win_j, masks_j, cams_j, lr_j = jmap.prepare_mapping(
        key, js, jnp.asarray(color), jnp.asarray(depth), jnp.asarray(pose),
        world["grids"], world["bound"], world["jcam"], mj, True)
    win_t, masks_t, cams_t, lr_t = mapping.prepare_mapping(
        ts, t(color), t(depth), t(pose),
        params_from_jax(world["grids"], device="cpu"),
        t(world["bound"]), world["tcam"], mapping.MapSpec(window_size=5),
        True, sel_draws={"pix": (t(i), t(j)), "scores_u": t(u)})
    valid = np.asarray(win_j["valid"])
    np.testing.assert_array_equal(n(win_t["valid"]), valid)
    np.testing.assert_array_equal(n(win_t["slots"])[valid],
                                  np.asarray(win_j["slots"])[valid])
    for name in ("colors", "depths"):
        np.testing.assert_allclose(n(win_t[name])[valid],
                                   np.asarray(win_j[name])[valid], atol=1e-6)
    np.testing.assert_allclose(n(cams_t)[valid], np.asarray(cams_j)[valid],
                               atol=1e-5)
    np.testing.assert_array_equal(n(lr_t), np.asarray(lr_j))
    for name in masks_j:
        np.testing.assert_array_equal(n(masks_t[name]),
                                      np.asarray(masks_j[name]))


def _window(world, idxs=(1, 3, 5), valid=(True, False, True)):
    fr = [world["frames"][f] for f in idxs]
    colors = np.stack([f[1] for f in fr]).astype(np.float32)
    depths = np.stack([f[2] for f in fr]).astype(np.float32)
    c2ws = np.stack([f[3] for f in fr]).astype(np.float32)
    valid = np.asarray(valid)
    cams = np.asarray(jax_tensor_from_cam(c2ws[:, :3, :]))
    wj = {"colors": colors, "depths": depths, "c2ws": c2ws, "valid": valid}
    wt = {"colors": t(colors), "depths": t(depths), "c2ws": t(c2ws),
          "valid": torch.from_numpy(valid)}
    return wj, wt, cams


def _jax_window_draws(key, wn, pix):
    keys = jax.random.split(key, wn)
    ij = [jax_sample_pixels(k, pix, 0, CAM["H"], 0, CAM["W"]) for k in keys]
    return (t(np.stack([np.asarray(a) for a, _ in ij])),
            t(np.stack([np.asarray(b) for _, b in ij])))


@pytest.mark.parametrize("stage", ["coarse", "middle", "fine", "color"])
def test_mapping_loss_and_adam_step(world, stage):
    """mapping_loss and its gradients with respect to every leaf the stage
    trains, then one Adam step of map_optimize, against JAX."""
    wj, wt, cams = _window(world)
    mj = jmap.MapSpec(pixels=120, coarse_mapper=stage == "coarse")
    mt = mapping.MapSpec(pixels=120, coarse_mapper=stage == "coarse")
    pix = 120 // 3
    cam_lr = np.array([0.0, 1.0, 1.0], np.float32)
    params_t = params_from_jax(world["params"], device="cpu")
    grids_t = params_from_jax(world["grids"], device="cpu")
    tree_t = {"params": params_t, "grids": grids_t, "cams": t(cams)}
    _, frozen = mapping._lr_tree(tree_t, stage, mt, 1.0, t(cam_lr))

    # the loss and its gradients, on the draws of map_optimize's one
    # iteration below
    kmap = jax.random.PRNGKey(30)
    _, ks = jax.random.split(kmap)
    key = jax.random.split(ks, 1)[0]
    draws = _jax_window_draws(key, 3, pix)
    tree_j = {"params": world["params"], "grids": world["grids"],
              "cams": cams}
    loss_j, g_j = jax.value_and_grad(jmap.mapping_loss)(
        tree_j, wj, world["bound"], key, world["jcam"], stage, mj,
        world["rj"], nice_model_spec())
    tr = {"params": params_t,
          "grids": {k: v.clone().requires_grad_(not frozen["grids"][k])
                    for k, v in grids_t.items()},
          "cams": t(cams).requires_grad_(not frozen["cams"])}
    live = [x for x in tree_leaves(tr) if x.requires_grad]
    loss_t = mapping.mapping_loss(
        tr, wt, t(world["bound"]), world["tcam"], stage, mt, world["rt"],
        ModelSpec(), pix=draws)
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-4)
    grads = torch.autograd.grad(loss_t, live)
    # JAX rebuilds dicts with sorted keys: align its leaves by key
    g_all = tree_leaves(tree_map(lambda x, g: g, tr, g_j))
    want = [g for g, x in zip(g_all, tree_leaves(tr)) if x.requires_grad]
    assert len(grads) == len(want) > 0
    for a, b in zip(grads, want):
        np.testing.assert_allclose(n(a), np.asarray(b), **GRAD)

    # one Adam step of the staged optimisation (frustum masks all ones)
    masks_j = {k: np.ones(v.shape[:3] + (1,), np.float32)
               for k, v in world["grids"].items()}
    pj, gj, cj, _ = jmap.map_optimize(
        world["params"], world["grids"], world["bound"], wj, cams, masks_j,
        cam_lr, 1.0, kmap, world["jcam"], ((stage, 1),), mj, world["rj"],
        nice_model_spec(), ba=True)
    pt, gt_, ct, _ = mapping.map_optimize(
        params_t, grids_t, t(world["bound"]), wt, t(cams),
        params_from_jax(masks_j, device="cpu"), t(cam_lr), 1.0, world["tcam"],
        ((stage, 1),), mt, world["rt"], ModelSpec(), ba=True,
        pixels=[draws])
    before = tree_leaves({"params": params_t, "grids": grids_t,
                          "cams": t(cams)})
    after_t = tree_leaves({"params": pt, "grids": gt_, "cams": ct})
    after_j = tree_leaves(tree_map(lambda x, a: a, tree_t,
                                   {"params": pj, "grids": gj, "cams": cj}))
    moved = 0
    for b0, a_t, a_j, g in zip(before, after_t, after_j, g_all):
        d_j = np.asarray(a_j) - n(b0)
        d_t = n(a_t) - n(b0)
        if not d_j.any():
            np.testing.assert_array_equal(d_t, 0.0)
            continue
        moved += 1
        # Adam's first step is lr * g / (|g| + eps): compare where the
        # gradient is well above its rounding (elsewhere its sign is noise)
        sure = np.abs(np.asarray(g)) > 1e-3
        np.testing.assert_allclose(d_t[sure], d_j[sure], atol=1e-5)
    assert moved > 0
