"""nice_slam_torch.ops against nice_slam_tpu.ops on the same numpy inputs
(fp32, CPU).  Tolerances: atol 1e-5 on values, 1e-4 on gradients."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from nice_slam_tpu import ops as jops  # noqa: E402
from nice_slam_tpu.ops import grid as jgrid  # noqa: E402
from nice_slam_tpu.ops import optim as joptim  # noqa: E402
from nice_slam_tpu.ops import rays as jrays  # noqa: E402

from nice_slam_torch.ops import composite, grid, optim, rays, sampling, se3  # noqa: E402

VAL = dict(atol=1e-5, rtol=1e-5)
GRAD = dict(atol=1e-4, rtol=1e-4)


def t(a):
    return torch.as_tensor(np.array(a, np.float32))


def n(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def rand_quats(rng, k):
    q = rng.randn(k, 4).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


class TestSE3:
    def test_quat_to_rot(self):
        q = rand_quats(np.random.RandomState(0), 32) * 1.7
        np.testing.assert_allclose(n(se3.quat_to_rot(t(q))),
                                   n(jops.quat_to_rot(q)), **VAL)

    @pytest.mark.parametrize("case", ["random", "pivots"])
    def test_rot_to_quat(self, case):
        if case == "random":
            R = np.asarray(jops.quat_to_rot(
                rand_quats(np.random.RandomState(1), 64)))
        else:
            R = np.stack([np.diag([1.0, -1, -1]), np.diag([-1.0, 1, -1]),
                          np.diag([-1.0, -1, 1]), np.eye(3)]).astype(
                np.float32)
        np.testing.assert_allclose(n(se3.rot_to_quat(t(R))),
                                   n(jops.rot_to_quat(R)), **VAL)

    def test_cam_tensor_roundtrip_and_homogeneous(self):
        rng = np.random.RandomState(2)
        cam = np.concatenate([rand_quats(rng, 8), rng.randn(8, 3)], 1)
        c2w = se3.cam_from_tensor(t(cam))
        np.testing.assert_allclose(n(c2w), n(jops.cam_from_tensor(cam)),
                                   **VAL)
        h = se3.to_homogeneous(c2w)
        np.testing.assert_allclose(n(h), n(jops.to_homogeneous(
            jops.cam_from_tensor(cam))), **VAL)
        np.testing.assert_allclose(n(se3.tensor_from_cam(h)),
                                   n(jops.tensor_from_cam(n(h))), **VAL)


class TestRays:
    def test_rays_from_uv_and_far(self):
        rng = np.random.RandomState(3)
        i = rng.randint(0, 80, 50).astype(np.float32)
        j = rng.randint(0, 60, 50).astype(np.float32)
        c2w = np.asarray(jops.to_homogeneous(jops.cam_from_tensor(
            np.array([0.9, 0.1, -0.3, 0.2, 1.0, 2.0, 0.5], np.float32))))
        args = (60.0, 60.0, 39.5, 29.5)
        o_t, d_t = rays.rays_from_uv(t(i), t(j), t(c2w), *args)
        o_j, d_j = jops.rays_from_uv(i, j, c2w, *args)
        np.testing.assert_allclose(n(o_t), n(o_j), **VAL)
        np.testing.assert_allclose(n(d_t), n(d_j), **VAL)
        bound = np.array([[-0.5, 4.5], [-0.5, 3.5], [-0.5, 4.5]], np.float32)
        np.testing.assert_allclose(
            n(rays.ray_aabb_far(o_t, d_t, t(bound))),
            n(jops.ray_aabb_far(o_j, d_j, bound)), atol=1e-4, rtol=1e-5)

    def test_gather_and_sample_pixels(self):
        rng = np.random.RandomState(4)
        img = rng.rand(6, 7, 3).astype(np.float32)
        i = np.array([0, 6, 3], np.float32)
        j = np.array([5, 0, 2], np.float32)
        np.testing.assert_array_equal(n(rays.gather_pixels(t(img), t(i), t(j))),
                                      n(jrays.gather_pixels(img, i, j)))
        gen = torch.Generator().manual_seed(0)
        pi, pj = rays.sample_pixels(gen, 500, 2, 5, 3, 9)
        assert pi.min() >= 3 and pi.max() <= 8 and pj.min() >= 2 \
            and pj.max() <= 4


class TestSampling:
    def test_stratified_perturb_surface(self):
        rng = np.random.RandomState(5)
        near = rng.rand(9, 1).astype(np.float32) * 0.1
        far = near + 2.0 + rng.rand(9, 1).astype(np.float32)
        for lindisp in (False, True):
            np.testing.assert_allclose(
                n(sampling.stratified_zvals(t(near), t(far), 12, lindisp)),
                n(jops.stratified_zvals(near, far, 12, lindisp)), **VAL)
        z = np.asarray(jops.stratified_zvals(near, far, 12))
        key = jax.random.PRNGKey(0)
        u = np.asarray(jax.random.uniform(key, z.shape))
        np.testing.assert_allclose(
            n(sampling.perturb_zvals(t(z), u=t(u))),
            n(jops.perturb_zvals(key, z)), **VAL)
        d = np.concatenate([rng.rand(8) * 3 + 0.5, [0.0]]).astype(np.float32)
        np.testing.assert_allclose(n(sampling.surface_zvals(t(d), 6, 4.0)),
                                   n(jops.surface_zvals(d, 6, 4.0)), **VAL)


class TestComposite:
    def test_raw2outputs(self):
        rng = np.random.RandomState(6)
        raw = rng.randn(10, 16, 4).astype(np.float32)
        z = np.sort(rng.rand(10, 16).astype(np.float32) * 4, axis=1)
        d = rng.randn(10, 3).astype(np.float32)
        got = composite.raw2outputs(t(raw), t(z), t(d))
        want = jops.raw2outputs(raw, z, d, True)
        for a, b in zip(got, want):
            np.testing.assert_allclose(n(a), n(b), **VAL)


class TestAdam:
    def test_update_with_frozen_leaves(self):
        """Three steps with per-leaf lr (scalar, per-element) and a frozen
        leaf that must stay untouched, moments included."""
        rng = np.random.RandomState(7)
        params = {"a": rng.randn(5).astype(np.float32),
                  "b": [rng.randn(2, 3).astype(np.float32)],
                  "c": rng.randn(4).astype(np.float32)}
        lr = {"a": 0.01, "b": [rng.rand(2, 3).astype(np.float32) * 0.1],
              "c": 0.5}
        frozen = {"a": False, "b": [False], "c": True}
        pj = jax.tree.map(jnp.asarray, params)
        sj = joptim.adam_init(pj)
        pt = {"a": t(params["a"]), "b": [t(params["b"][0])],
              "c": t(params["c"])}
        st = optim.adam_init(pt)
        lr_t = {"a": 0.01, "b": [t(lr["b"][0])], "c": 0.5}
        for step in range(3):
            g = {"a": rng.randn(5).astype(np.float32),
                 "b": [rng.randn(2, 3).astype(np.float32)],
                 "c": rng.randn(4).astype(np.float32)}
            pj, sj = joptim.adam_update(pj, jax.tree.map(jnp.asarray, g), sj,
                                        jax.tree.map(jnp.asarray, lr),
                                        frozen=frozen)
            gt = {"a": t(g["a"]), "b": [t(g["b"][0])], "c": None}
            pt, st = optim.adam_update(pt, gt, st, lr_t, frozen=frozen)
        np.testing.assert_allclose(n(pt["a"]), n(pj["a"]), **VAL)
        np.testing.assert_allclose(n(pt["b"][0]), n(pj["b"][0]), **VAL)
        np.testing.assert_array_equal(n(pt["c"]), params["c"])
        np.testing.assert_array_equal(n(st.m["c"]), 0.0)
        assert st.step == 3


class TestGrid:
    @pytest.mark.parametrize("shape", [(5, 4, 6, 8), (1, 3, 2, 4)],
                             ids=["regular", "side_under_2"])
    def test_interp_forward_and_gradients(self, shape):
        """trilinear_interp forward, grid gradient (index_add_) and point
        gradient against JAX autodiff of _interp_impl; points include
        out-of-range ones (border clamp)."""
        rng = np.random.RandomState(8)
        g = rng.randn(*shape).astype(np.float32)
        p = rng.uniform(-1.2, 1.2, (64, 3)).astype(np.float32)
        w = rng.randn(64, shape[-1]).astype(np.float32)

        def f(grid_, p_):
            return jnp.sum(jgrid._interp_impl(grid_, p_) * w)

        out_j = jgrid._interp_impl(g, p)
        gg_j, gp_j = jax.grad(f, argnums=(0, 1))(g, p)
        gt_ = t(g).requires_grad_(True)
        pt_ = t(p).requires_grad_(True)
        out_t = grid.trilinear_interp(gt_, pt_)
        gg_t, gp_t = torch.autograd.grad((out_t * t(w)).sum(), [gt_, pt_])
        np.testing.assert_allclose(n(out_t), n(out_j), **VAL)
        np.testing.assert_allclose(n(gg_t), n(gg_j), **GRAD)
        np.testing.assert_allclose(n(gp_t), n(gp_j), **GRAD)

    def test_scatter_fixed_order_many_duplicates(self):
        """The grid backward's fixed-order scatter with many points per
        corner row (2,000 points on a 2x3x2 grid): the grid gradient agrees
        with JAX autodiff and two runs are bit-equal.  On runs longer than
        a piece (about 400 entries a row, pieces of 64 and of 16), the
        scatter repeats bit for bit and is within fp32 rounding of the
        float64 sum."""
        rng = np.random.RandomState(11)
        g = rng.randn(2, 3, 2, 4).astype(np.float32)
        p = rng.uniform(-1.1, 1.1, (2000, 3)).astype(np.float32)
        w = rng.randn(2000, 4).astype(np.float32)
        gg_j = jax.grad(lambda grid_: jnp.sum(
            jgrid._interp_impl(grid_, p) * w))(g)

        def run():
            gt_ = t(g).requires_grad_(True)
            out = grid.trilinear_interp(gt_, t(p))
            return torch.autograd.grad((out * t(w)).sum(), gt_)[0]

        a, b = run(), run()
        np.testing.assert_allclose(n(a), n(gg_j), **GRAD)
        assert torch.equal(a, b)
        rows = torch.from_numpy(rng.randint(0, 12, 5000))
        vals = torch.from_numpy(rng.randn(5000, 4).astype(np.float32))
        ref = torch.zeros(12, 4, dtype=torch.float64).index_add_(
            0, rows, vals.double())
        assert int(torch.bincount(rows).min()) > 64
        bound = 5000 * 6e-8 * float(vals.abs().max())
        for block in (64, 16):
            got = grid.scatter_rows(rows, vals, 12, block=block)
            assert torch.equal(got, grid.scatter_rows(rows, vals, 12,
                                                      block=block))
            assert float((got.double() - ref).abs().max()) <= bound

    def test_normalize_and_grid_coords(self):
        rng = np.random.RandomState(9)
        p = rng.uniform(-1, 5, (20, 3)).astype(np.float32)
        b = np.array([[-0.5, 4.5], [-0.5, 3.5], [-0.5, 4.5]], np.float32)
        pn = grid.normalize_coords(t(p), t(b))
        np.testing.assert_allclose(n(pn), n(jgrid.normalize_coords(p, b)),
                                   **VAL)
        np.testing.assert_allclose(n(grid.grid_coords(pn, (4, 5, 6))),
                                   n(jgrid.grid_coords(n(pn), (4, 5, 6))),
                                   **VAL)
        assert grid.grid_shape_for_bound(b, 0.32) == \
            jgrid.grid_shape_for_bound(b, 0.32)
