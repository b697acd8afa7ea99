"""Gauss-Newton pose refinement (nice_slam_torch/parallel/schur_ba.py)
against the JAX package's parallel/schur_ba.py, and the port's copies of
tests/test_schur_ba.py `TestGaussNewton` that need no mesh.

- pose_system's H, b and SSE against JAX's (jacfwd under plain_interp) on
  the same map and the same pixels (JAX's draws passed in), render
  perturbation off: rtol 1e-3, atol 1e-4 of the largest entry;
- the reverse-mode Jacobian (one copy of the camera per ray, through the
  fused decode's autograd Function) against torch.func.jacfwd of the same
  residuals through the plain route (reference_nice_decode and a plain
  trilinear gather, no autograd Function): rtol 1e-4, atol 1e-5 of the
  largest entry;
- gn_pose_update against JAX's on the same systems: rtol 1e-5, atol 1e-6.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from nice_slam_tpu.camera import Camera as JCamera  # noqa: E402
from nice_slam_tpu.models.decoders import nice_model_spec  # noqa: E402
from nice_slam_tpu.ops import sample_pixels as jax_sample_pixels  # noqa: E402
from nice_slam_tpu.ops import tensor_from_cam as jax_tensor_from_cam  # noqa: E402
from nice_slam_tpu.ops.grid import plain_interp  # noqa: E402
from nice_slam_tpu.parallel import schur_ba as jschur  # noqa: E402
from nice_slam_tpu.render import RenderSpec as JRenderSpec  # noqa: E402
from nice_slam_tpu.state import make_map_state as jax_make_map_state  # noqa: E402

from nice_slam_torch import mapping  # noqa: E402
from nice_slam_torch.camera import Camera  # noqa: E402
from nice_slam_torch.config import load_config, specs_from_config  # noqa: E402
from nice_slam_torch.convert import params_from_jax  # noqa: E402
from nice_slam_torch.keyframes import (  # noqa: E402
    add_keyframe,
    build_window,
    make_store,
)
from nice_slam_torch.models import decoders  # noqa: E402
from nice_slam_torch.models.decoders import ModelSpec  # noqa: E402
from nice_slam_torch.ops import grid as grid_ops  # noqa: E402
from nice_slam_torch.ops.fused_decode import reference_nice_decode  # noqa: E402
from nice_slam_torch.ops.se3 import (  # noqa: E402
    cam_from_tensor,
    tensor_from_cam,
    to_homogeneous,
)
from nice_slam_torch.parallel import schur_ba  # noqa: E402
from nice_slam_torch.render import RenderSpec  # noqa: E402
from nice_slam_torch.state import make_map_state  # noqa: E402
from nice_slam_torch.tracking import track_step  # noqa: E402
from nice_slam_torch.utils.datasets import get_dataset  # noqa: E402

CAM = dict(H=30, W=40, fx=30.0, fy=30.0, cx=19.5, cy=14.5)
BOUND_SYN = [[-0.5, 4.5], [-0.5, 3.5], [-0.5, 4.5]]
GRID_LEN = {"coarse": 1.0, "middle": 0.32, "fine": 0.16, "color": 0.16}


def n(x):
    return x.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# Against the JAX package

@pytest.fixture(scope="module")
def world():
    """Three synthetic frames (the third slot invalid), a random map of the
    JAX package carried into the port, perturbed cameras."""
    cfg = load_config(overrides={
        "dataset": "synthetic", "synthetic": {"n_frames": 3},
        "cam": {**CAM, "crop_edge": 0}, "mapping": {"bound": BOUND_SYN}})
    ds = get_dataset(cfg)
    frames = [ds[i] for i in range(3)]
    st = jax_make_map_state(jax.random.PRNGKey(1), nice_model_spec(),
                            BOUND_SYN, GRID_LEN, 0.32)
    rng = np.random.RandomState(0)
    cams = np.stack([np.asarray(jax_tensor_from_cam(f[3])) for f in frames])
    cams = (cams + rng.randn(*cams.shape) * 0.01).astype(np.float32)
    return {
        "params": jax.tree.map(np.asarray, st.params),
        "grids": {k: np.asarray(v) for k, v in st.grids.items()},
        "bound": np.asarray(st.bound),
        "depths": np.stack([f[2] for f in frames]).astype(np.float32),
        "valid": np.array([True, True, False]),
        "cams": cams,
    }


def _jax_pixels(key, wn, p):
    """The pixels JAX's pose_system draws from `key`, as (Wn, P) arrays."""
    pix_keys, _ = jschur._frame_keys(key, wn)
    ij = [jax_sample_pixels(k, p, 0, CAM["H"], 0, CAM["W"])
          for k in pix_keys]
    return (np.stack([np.asarray(a) for a, _ in ij]),
            np.stack([np.asarray(b) for _, b in ij]))


def _port_args(w):
    return (params_from_jax(w["params"], device="cpu"),
            params_from_jax(w["grids"], device="cpu"),
            torch.from_numpy(w["bound"].copy()),
            {"depths": torch.from_numpy(w["depths"]),
             "valid": torch.from_numpy(w["valid"])})


def test_pose_system_matches_jax(world):
    w, P = world, 48
    key = jax.random.PRNGKey(7)
    rj = JRenderSpec(n_samples=12, n_surface=6, train_decoders=False)
    rt = RenderSpec(n_samples=12, n_surface=6, train_decoders=False)
    with plain_interp():
        Hj, bj, sj = jschur.pose_system(
            jax.tree.map(jnp.asarray, w["params"]),
            jax.tree.map(jnp.asarray, w["grids"]), jnp.asarray(w["bound"]),
            {"depths": jnp.asarray(w["depths"]),
             "valid": jnp.asarray(w["valid"])}, jnp.asarray(w["cams"]), key,
            JCamera(**CAM), rj, nice_model_spec(), P,
            jnp.asarray(w["valid"]))
    i, j = _jax_pixels(key, 3, P)
    params, grids, bound, window = _port_args(w)
    Ht, bt, st = schur_ba.pose_system(
        params, grids, bound, window, torch.from_numpy(w["cams"]),
        Camera(**CAM), rt, ModelSpec(), P, window["valid"],
        pix=(torch.from_numpy(i), torch.from_numpy(j)))
    for got, want in ((Ht, Hj), (bt, bj), (st, sj)):
        want = np.asarray(want)
        assert np.isfinite(want).all() and np.abs(want).max() > 0
        np.testing.assert_allclose(n(got), want, rtol=1e-3,
                                   atol=1e-4 * np.abs(want).max())
    # the invalid slot contributes nothing
    assert float(Ht[2].abs().max()) == 0.0 and float(st[2]) == 0.0


def test_gn_pose_update_matches_jax():
    rng = np.random.RandomState(4)
    A = rng.randn(4, 7, 9).astype(np.float32)
    H = A @ A.transpose(0, 2, 1)
    H[3] = np.nan                       # a non-finite system: no step
    b = rng.randn(4, 7).astype(np.float32)
    b[1] *= 1e4                         # a step the clamp shortens
    cams = rng.randn(4, 7).astype(np.float32)
    mask = np.array([0.0, 1.0, 1.0, 1.0], np.float32)
    want = np.asarray(jschur.gn_pose_update(cams, H, b, mask, 1e-3))
    got = n(schur_ba.gn_pose_update(torch.from_numpy(cams),
                                    torch.from_numpy(H), torch.from_numpy(b),
                                    torch.from_numpy(mask), 1e-3))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got[0], cams[0])
    np.testing.assert_array_equal(got[3], cams[3])
    assert abs(np.linalg.norm(got[1] - cams[1]) - 0.2) < 1e-5


def _plain_trilinear(grid, p_nor):
    """The interpolation as plain differentiable ops (no autograd
    Function), for forward mode."""
    C = grid.shape[-1]
    i0, i1, f, _ = grid_ops._cell(grid.shape, p_nor)
    rows = grid_ops._corner_rows(grid.shape, i0, i1)
    c = grid.reshape(-1, C)[rows.reshape(-1)].reshape(8, -1, C)
    fx, fy, fz = f[:, 0:1], f[:, 1:2], f[:, 2:3]
    c00 = c[0] * (1 - fz) + c[1] * fz
    c01 = c[2] * (1 - fz) + c[3] * fz
    c10 = c[4] * (1 - fz) + c[5] * fz
    c11 = c[6] * (1 - fz) + c[7] * fz
    return ((c00 * (1 - fy) + c01 * fy) * (1 - fx)
            + (c10 * (1 - fy) + c11 * fy) * fx)


def test_reverse_jacobian_equals_jacfwd_of_plain_route(world, monkeypatch):
    w, P = world, 40
    params, grids, bound, window = _port_args(w)
    window = {"depths": window["depths"][:1], "valid": window["valid"][:1]}
    cams = torch.from_numpy(w["cams"][:1])
    rt = RenderSpec(n_samples=12, n_surface=6, train_decoders=False)
    camera = Camera(**CAM)
    pix = schur_ba.window_pixels(torch.Generator().manual_seed(2), 1, P,
                                 camera, "cpu")
    J, r = schur_ba.pose_jacobian(params, grids, bound, window, cams, camera,
                                  rt, ModelSpec(), pix)
    f, gt_d, max_d = schur_ba._samples(window, *pix)
    monkeypatch.setattr(decoders, "trilinear_interp", _plain_trilinear)
    monkeypatch.setattr(
        decoders, "fused_nice_decode",
        lambda wc, _tw, p, cm, cf, cc, *ws: reference_nice_decode(
            wc, p, cm, cf, cc, *ws))

    def resid(c):
        return schur_ba._frame_residuals(
            c[None].expand(P, 7), pix[0].reshape(-1), pix[1].reshape(-1),
            gt_d, max_d, params, grids, bound, camera, rt, ModelSpec())

    J_fwd = torch.func.jacfwd(resid)(cams[0])
    np.testing.assert_allclose(n(resid(cams[0])), n(r[0]), rtol=1e-5,
                               atol=1e-6)
    scale = float(J_fwd.abs().max())
    assert scale > 0 and int((r[0] != 0).sum()) > P // 2
    np.testing.assert_allclose(n(J[0]), n(J_fwd), rtol=1e-4,
                               atol=1e-5 * scale)


# ---------------------------------------------------------------------------
# tests/test_schur_ba.py TestGaussNewton, on the port

BOUND = [[-2.0, 2.0], [-2.0, 2.0], [-2.0, 2.0]]


def _setup(seed=0):
    cfg = load_config(overrides={
        "cam": {"H": 24, "W": 32, "fx": 24.0, "fy": 24.0,
                "cx": 15.5, "cy": 11.5},
        "grid_len": GRID_LEN,
        "mapping": {"bound": BOUND, "pixels": 64,
                    "mapping_window_size": 3},
        "rendering": {"N_samples": 8, "N_surface": 4},
    })
    specs = specs_from_config(cfg)
    state = make_map_state(torch.Generator().manual_seed(seed), ModelSpec(),
                           BOUND, GRID_LEN, 0.32, device="cpu")
    cam = specs.camera
    store = make_store(4, cam.H, cam.W, device="cpu")
    eye = torch.eye(4)
    color = torch.full((cam.H, cam.W, 3), 0.5)
    depth = torch.full((cam.H, cam.W), 1.0)
    add_keyframe(store, color, depth, eye, eye, 0)
    window = build_window(store, torch.zeros(1, dtype=torch.int64),
                          torch.ones(1, dtype=torch.bool), color, depth, eye)
    cams0 = tensor_from_cam(window["c2ws"][:, :3, :])
    rspec = dataclasses.replace(specs.render, train_decoders=False)
    return specs, state, window, cams0, cam, rspec


def _trained_map(specs, state, window, cams0, cam, iters=120):
    """Fit the grids to the window so the render reproduces the observed
    depth: the regime GN refines in."""
    masks = mapping.grid_masks(state.grids, state.bound, torch.eye(4),
                               window["depths"][-1], cam, False)
    params, grids, _, _ = mapping.map_optimize(
        state.params, state.grids, state.bound, window, cams0, masks,
        torch.zeros(3), 5.0, cam, (("middle", iters), ("fine", iters // 2)),
        specs.mapper, specs.render, specs.model, ba=False,
        gen=torch.Generator().manual_seed(9))
    return params, grids


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_guarded_iteration_never_increases_sse():
    specs, state, window, cams0, cam, rspec = _setup()
    mask = torch.tensor([0.0, 0.0, 1.0])
    pix = schur_ba.window_pixels(_gen(3), 3, 128, cam, "cpu")
    args = (state.params, state.grids, state.bound, window)
    sse0 = schur_ba.residual_sse(*args, cams0, cam, rspec, specs.model, 128,
                                 window["valid"], pix=pix)
    cams1, sse_acc, accept = schur_ba.gn_iteration(
        *args, cams0, mask, cam, rspec, specs.model, 128, 1e-3, pix=pix)
    sse1 = schur_ba.residual_sse(*args, cams1, cam, rspec, specs.model, 128,
                                 window["valid"], pix=pix)
    assert bool(torch.all(torch.isfinite(sse1)))
    assert bool(torch.all(sse1 <= sse0 + 1e-3))
    assert not bool(accept[:2].any())


def test_guard_takes_the_same_jitter(monkeypatch):
    """With stratified jitter on (perturb > 0) the candidate's SSE is taken
    on the jitter of the system's render, as JAX reuses the frame's key:
    both renders get the same uniforms, drawn once from the generator
    right after the pixels (the draw the system's render made before, so
    the stream advances as it did), and a candidate that cannot move
    (mask 0) has the current SSE exactly."""
    specs, state, window, cams0, cam, rspec = _setup()
    rspec = dataclasses.replace(rspec, perturb=1.0)
    seen, sses = [], []
    orig_render, orig_sse = schur_ba.render_rays, schur_ba.residual_sse

    def render(*a, **k):
        seen.append(k["draws"])
        return orig_render(*a, **k)

    def capture(*a, **k):
        sses.append(orig_sse(*a, **k))
        return sses[-1]

    monkeypatch.setattr(schur_ba, "render_rays", render)
    monkeypatch.setattr(schur_ba, "residual_sse", capture)
    gen = _gen(5)
    cams1, sse, accept = schur_ba.gn_iteration(
        state.params, state.grids, state.bound, window, cams0,
        torch.zeros(3), cam, rspec, specs.model, 64, 1e-3, gen=gen)
    assert not bool(accept.any()) and torch.equal(cams1, cams0)
    assert float(sse[0]) > 0 and torch.equal(sses[0], sse)
    # the system's render and the candidate's: the same uniforms
    assert len(seen) == 2 and seen[0] is seen[1]
    u, u_imp = seen[0]
    assert u_imp is None and u.shape == (3 * 64, rspec.n_samples)
    ref = _gen(5)
    schur_ba.window_pixels(ref, 3, 64, cam, "cpu")
    assert torch.equal(u, torch.rand((3 * 64, rspec.n_samples),
                                     generator=ref))
    assert torch.equal(gen.get_state(), ref.get_state())


def test_frozen_rows_untouched():
    specs, state, window, cams0, cam, rspec = _setup()
    mask = torch.tensor([0.0, 0.0, 1.0])
    out = schur_ba.schur_pose_refine(
        state.params, state.grids, state.bound, window, cams0, mask, cam,
        rspec, specs.model, 2, 64, 1e-3, gen=_gen(7))
    assert torch.equal(out[:2], cams0[:2])


def test_degenerate_candidate_rejected():
    """A pose that pushes (almost) every ray out of bound zeroes the
    residual weights and so its SSE; the guard must not take it."""
    specs, state, window, cams0, cam, rspec = _setup()
    far = cams0.clone()
    far[2, 4:] = torch.tensor([50.0, 50.0, 50.0])
    pix = schur_ba.window_pixels(_gen(3), 3, 128, cam, "cpu")
    cnt_good = schur_ba.mask_count(state.bound, window, cams0, cam, 128,
                                   pix=pix)
    cnt_far = schur_ba.mask_count(state.bound, window, far, cam, 128,
                                  pix=pix)
    assert float(cnt_far[2]) < 0.5 * float(cnt_good[2])
    cams1, _, _ = schur_ba.gn_iteration(
        state.params, state.grids, state.bound, window, cams0,
        torch.tensor([0.0, 0.0, 1.0]), cam, rspec, specs.model, 128, 1e-3,
        pix=pix)
    cnt_after = schur_ba.mask_count(state.bound, window, cams1, cam, 128,
                                    pix=pix)
    assert float(cnt_after[2]) >= 0.5 * float(cnt_good[2])


def test_zero_mask_is_identity():
    specs, state, window, cams0, cam, rspec = _setup()
    out = schur_ba.schur_pose_refine(
        state.params, state.grids, state.bound, window, cams0,
        torch.zeros(3), cam, rspec, specs.model, 1, 64, 1e-3, gen=_gen(7))
    assert torch.equal(out, cams0)


def test_tracking_gn_polish_recovers_perturbed_pose():
    """track_step's GN polish (TrackSpec.gn_iters) pulls a perturbed pose
    closer to the truth on a trained map than one Adam step alone."""
    specs, state, _, _, cam, rspec = _setup()
    # smooth bumps make all six degrees of freedom observable
    jj, ii = torch.meshgrid(torch.arange(cam.H), torch.arange(cam.W),
                            indexing="ij")
    depth = (1.0 + 0.25 * torch.sin(2 * np.pi * ii / cam.W)
             + 0.2 * torch.cos(2 * np.pi * jj / cam.H)).float()
    color = torch.full((cam.H, cam.W, 3), 0.5)
    eye = torch.eye(4)
    store = make_store(4, cam.H, cam.W, device="cpu")
    add_keyframe(store, color, depth, eye, eye, 0)
    window = build_window(store, torch.zeros(1, dtype=torch.int64),
                          torch.ones(1, dtype=torch.bool), color, depth, eye)
    cams0 = tensor_from_cam(window["c2ws"][:, :3, :])
    params, grids = _trained_map(specs, state, window, cams0, cam,
                                 iters=200)
    true7 = cams0[2]
    pert7 = true7.clone()
    pert7[4:] += torch.tensor([0.03, -0.02, 0.02])
    pre = to_homogeneous(cam_from_tensor(pert7))

    def run(gn_iters):
        # (the JAX test keeps the 20-pixel edges, which exceed this
        # 24x32 image; JAX's randint then draws from its clamped range)
        ts = dataclasses.replace(specs.track, iters=1, pixels=64,
                                 ignore_edge_w=4, ignore_edge_h=4,
                                 const_speed=False, gn_iters=gn_iters,
                                 gn_pixels=256)
        est = pre[None].repeat(3, 1, 1)
        losses = track_step(params, grids, state.bound, est, 2, color, depth,
                            cam, ts, rspec, specs.model, gen=_gen(11))
        assert losses.shape == (3,) and bool(torch.isfinite(losses).all())
        return est[2]

    true_c2w = to_homogeneous(cam_from_tensor(true7))
    err_off = float(torch.linalg.norm(run(0)[:3, 3] - true_c2w[:3, 3]))
    err_gn = float(torch.linalg.norm(run(3)[:3, 3] - true_c2w[:3, 3]))
    assert err_gn < err_off * 0.7, (err_off, err_gn)


def test_map_optimize_pose_gn_path():
    """map_optimize with pose_gn_iters > 0 and BA on refines only the
    poses the BA mask frees, after the staged Adam."""
    specs, state, window, cams0, cam, rspec = _setup()
    masks = mapping.grid_masks(state.grids, state.bound, torch.eye(4),
                               window["depths"][-1], cam, True)
    lr_mask = torch.tensor([0.0, 1.0, 1.0])
    calls = []
    orig = schur_ba.gn_iteration

    def counted(*a, **k):
        out = orig(*a, **k)
        calls.append(out[2])
        return out

    schur_ba.gn_iteration = counted
    try:
        mapspec = dataclasses.replace(specs.mapper, pose_gn_iters=1,
                                      pose_gn_pixels=32)
        _, _, cams, _ = mapping.map_optimize(
            state.params, state.grids, state.bound, window, cams0, masks,
            lr_mask, 1.0, cam, (("middle", 1), ("color", 1)), mapspec,
            specs.render, specs.model, ba=True, gen=_gen(1))
    finally:
        schur_ba.gn_iteration = orig
    assert len(calls) == 1 and not bool(calls[0][0])
    assert bool(torch.all(torch.isfinite(cams)))
    assert torch.equal(cams[0], cams0[0])
    assert not torch.allclose(cams[1:], cams0[1:])
