"""The port's renderer against the JAX package's: render_rays depth,
uncertainty, colour and weights, and their gradients with respect to the
grids and the rays, on the same map (carried across) and the same rays.
Tolerance: atol 1e-4 (rtol 1e-4)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from nice_slam_tpu.models.decoders import nice_model_spec  # noqa: E402
from nice_slam_tpu.ops import cam_from_tensor, rays_from_uv  # noqa: E402
from nice_slam_tpu.render import RenderSpec as JRenderSpec  # noqa: E402
from nice_slam_tpu.render import eval_points as jax_eval_points  # noqa: E402
from nice_slam_tpu.render import render_rays as jax_render_rays  # noqa: E402
from nice_slam_tpu.state import make_map_state as jax_make_map_state  # noqa: E402

from nice_slam_torch.convert import params_from_jax  # noqa: E402
from nice_slam_torch.models.decoders import ModelSpec  # noqa: E402
from nice_slam_torch.render import RenderSpec, eval_points, render_rays  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)


def n(x):
    return x.detach().cpu().numpy()


@pytest.fixture(scope="module")
def scene():
    st = jax_make_map_state(jax.random.PRNGKey(2), nice_model_spec(),
                            [[-0.5, 2.5], [-0.5, 2.0], [-0.5, 2.5]],
                            {"coarse": 1.0, "middle": 0.32, "fine": 0.16,
                             "color": 0.16}, 0.32)
    params = jax.tree.map(np.asarray, st.params)
    grids = {k: np.asarray(v) for k, v in st.grids.items()}
    bound = np.asarray(st.bound)
    rng = np.random.RandomState(0)
    cam = np.array([0.95, 0.1, -0.2, 0.05, 1.0, 0.8, 2.4], np.float32)
    c2w = np.asarray(cam_from_tensor(cam))
    i = rng.randint(0, 40, 24).astype(np.float32)
    j = rng.randint(0, 30, 24).astype(np.float32)
    o, d = rays_from_uv(i, j, c2w, 30.0, 30.0, 19.5, 14.5)
    depth = (rng.rand(24) * 2 + 0.5).astype(np.float32)
    depth[3] = 0.0  # a depth hole
    return params, grids, bound, np.asarray(o), np.asarray(d), depth


@pytest.mark.parametrize("stage,with_depth", [
    ("color", True), ("fine", True), ("middle", True), ("coarse", False)])
def test_render_rays_matches_jax(scene, stage, with_depth):
    params, grids, bound, o, d, depth = scene
    gt = depth if with_depth else None
    rs_j = JRenderSpec(n_samples=12, n_surface=6)
    rs_t = RenderSpec(n_samples=12, n_surface=6)
    w_out = np.random.RandomState(1).randn(24, 5).astype(np.float32)

    def f(g, o_, d_):
        dep, var, col, _ = jax_render_rays(
            params, nice_model_spec(), g, bound, o_, d_,
            jax.random.PRNGKey(0), rs_j, stage, gt_depth=gt)
        return jnp.sum(jnp.concatenate([dep[:, None], var[:, None], col],
                                       axis=1) * w_out)

    out_j = jax_render_rays(params, nice_model_spec(), grids, bound, o, d,
                            jax.random.PRNGKey(0), rs_j, stage, gt_depth=gt)
    gg_j, go_j, gd_j = jax.grad(f, argnums=(0, 1, 2))(grids, o, d)

    gt_t = {k: v.clone().requires_grad_(True)
            for k, v in params_from_jax(grids, device="cpu").items()}
    o_t = torch.tensor(o, requires_grad=True)
    d_t = torch.tensor(d, requires_grad=True)
    out_t = render_rays(params_from_jax(params, device="cpu"), ModelSpec(),
                        gt_t, torch.tensor(bound), o_t, d_t, rs_t, stage,
                        gt_depth=None if gt is None else torch.tensor(gt))
    for a, b in zip(out_t, out_j):
        np.testing.assert_allclose(n(a), np.asarray(b), **TOL)
    dep, var, col, _ = out_t
    loss = (torch.cat([dep[:, None], var[:, None], col], 1)
            * torch.tensor(w_out)).sum()
    names = [k for k in gt_t if gg_j[k] is not None
             and np.abs(np.asarray(gg_j[k])).max() > 0]
    grads = torch.autograd.grad(loss, [gt_t[k] for k in names] + [o_t, d_t])
    for k, a in zip(names, grads):
        np.testing.assert_allclose(n(a), np.asarray(gg_j[k]), **TOL)
    np.testing.assert_allclose(n(grads[-2]), np.asarray(go_j), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(n(grads[-1]), np.asarray(gd_j), atol=1e-4,
                               rtol=1e-4)


def test_eval_points_outside_bound(scene):
    params, grids, bound, _, _, _ = scene
    p = np.array([[0.5, 0.5, 0.5], [9.0, 0.5, 0.5], [0.5, -3.0, 0.5]],
                 np.float32)
    out_j = jax_eval_points(params, nice_model_spec(), grids, bound, p,
                            "color")
    out_t = eval_points(params_from_jax(params, device="cpu"), ModelSpec(),
                        params_from_jax(grids, device="cpu"),
                        torch.tensor(bound),
                        torch.tensor(p), "color")
    np.testing.assert_allclose(n(out_t), np.asarray(out_j), **TOL)
    assert float(out_t[1, 3]) == 100.0 and float(out_t[2, 3]) == 100.0
