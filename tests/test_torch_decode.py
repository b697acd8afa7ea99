"""The port's plain fused decode and the port's decoders against the JAX
package: same weights (carried across with convert.params_from_jax), same
numpy inputs.  Tolerance: atol 1e-4 (rtol 1e-4 where values reach O(10)).
The kernel wrapper's own tests, which import no JAX, are in
test_torch_kernels.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from nice_slam_tpu.models.decoders import init_model as jax_init_model  # noqa: E402
from nice_slam_tpu.models.decoders import model_apply as jax_model_apply  # noqa: E402
from nice_slam_tpu.models.decoders import nice_model_spec  # noqa: E402
from nice_slam_tpu.ops.pallas import fused_decode as jfd  # noqa: E402
from nice_slam_tpu.state import make_map_state as jax_make_map_state  # noqa: E402

from nice_slam_torch.convert import params_from_jax, params_to_numpy  # noqa: E402
from nice_slam_torch.models.decoders import (  # noqa: E402
    ModelSpec,
    fused_route,
    model_apply,
)
from nice_slam_torch.ops import fused_decode as fd  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)


def n(x):
    return x.detach().cpu().numpy()


@pytest.fixture(scope="module")
def weights():
    params = jax.tree.map(np.asarray,
                          jax_init_model(jax.random.PRNGKey(0),
                                         nice_model_spec()))
    ws_j = [np.asarray(w) for w in jfd.pack_nice_weights(params)]
    ws_t = list(fd.pack_nice_weights(params_from_jax(params, device="cpu")))
    return params, ws_j, ws_t


def _inputs(N=96, seed=1):
    rng = np.random.RandomState(seed)
    p = rng.uniform(-2, 2, (N, 3)).astype(np.float32)
    cs = [(rng.randn(N, 32) * 0.2).astype(np.float32) for _ in range(3)]
    g = rng.randn(N, 4).astype(np.float32)
    return p, cs, g


@pytest.mark.parametrize("with_color", [False, True], ids=["fine", "color"])
def test_plain_decode_matches_jax(weights, with_color):
    """reference_nice_decode forward, and its gradients with respect to
    points, features and all 69 weights (jax.grad vs torch autograd)."""
    _, ws_j, ws_t = weights
    p, (cm, cf, cc), g = _inputs()

    def f_j(p_, cm_, cf_, cc_, *w):
        return jnp.sum(jfd.reference_nice_decode(with_color, p_, cm_, cf_,
                                                 cc_, *w) * g)

    out_j = jfd.reference_nice_decode(with_color, p, cm, cf, cc, *ws_j)
    grads_j = jax.grad(f_j, argnums=tuple(range(4 + len(ws_j))))(
        p, cm, cf, cc, *ws_j)
    xs = [torch.tensor(a, requires_grad=True) for a in (p, cm, cf, cc)]
    wt = [w.clone().requires_grad_(True) for w in ws_t]
    out_t = fd.reference_nice_decode(with_color, *xs, *wt)
    grads_t = torch.autograd.grad((out_t * torch.tensor(g)).sum(), xs + wt,
                                  allow_unused=True)
    np.testing.assert_allclose(n(out_t), np.asarray(out_j), **TOL)
    for a, b in zip(grads_t, grads_j):
        a = np.zeros_like(b) if a is None else n(a)
        np.testing.assert_allclose(a, np.asarray(b), **TOL)


@pytest.mark.parametrize("with_color", [False, True], ids=["fine", "color"])
@pytest.mark.parametrize("live", [0, 4, 7], ids=["none", "color", "all"])
def test_plain_bwd_live_matches_jax(weights, with_color, live):
    """plain_nice_decode_bwd (the backward kernel's oracle) with a live mask
    against the JAX package's _mlp_backward of each decoder on the same
    numpy inputs: dp (summed over the decoders), dc_mid, dc_fine (the
    c_fine half), dc_color and the live decoders' weight gradients; the
    frozen decoders' are None."""
    _, ws_j, ws_t = weights
    p, (cm, cf, cc), g = _inputs(N=64, seed=7)
    cc_in = cc if with_color else cm
    T = torch.tensor
    dp, dcm, dcf, dcc, wg = fd.plain_nice_decode_bwd(
        with_color, live, T(p), T(cm), T(cf), T(cc_in), T(g), ws_t)
    docc = g[:, 3:4]
    dout_c = np.concatenate([g[:, :3], np.zeros_like(g[:, :1])], axis=-1)
    cases = [(docc, cm, dcm), (docc, np.concatenate([cf, cm], -1), dcf),
             (dout_c, cc, dcc)][:3 if with_color else 2]
    dp_j = 0.0
    for d, (dout, c, dc_t) in enumerate(cases):
        dp_d, dc_d, wg_d = jfd._mlp_backward(dout, p, c, *jfd._unpack(ws_j, d))
        dp_j = dp_j + np.asarray(dp_d)
        np.testing.assert_allclose(n(dc_t), np.asarray(dc_d)[:, :32], **TOL)
        for k in range(fd.N_PER_DEC):
            a = wg[d * fd.N_PER_DEC + k]
            if live >> d & 1:
                np.testing.assert_allclose(n(a), np.asarray(wg_d[k]), **TOL)
            else:
                assert a is None
    np.testing.assert_allclose(n(dp), dp_j, **TOL)
    if not with_color:
        colour = wg[2 * fd.N_PER_DEC:]
        assert all(a is None for a in colour) if not live & 4 else \
            all(float(a.abs().max()) == 0.0 for a in colour)


@pytest.mark.parametrize("stage", ["coarse", "middle", "fine", "color"])
def test_model_apply_matches_jax(stage):
    """model_apply of every stage against JAX model_apply(fused=False) on
    the same weights and grids, with the gradients of the grids."""
    spec_j = nice_model_spec()
    st = jax_make_map_state(jax.random.PRNGKey(4), spec_j,
                            [[-1.0, 2.0], [-1.0, 1.5], [-0.5, 2.0]],
                            {"coarse": 1.0, "middle": 0.32, "fine": 0.16,
                             "color": 0.16}, 0.32)
    params = jax.tree.map(np.asarray, st.params)
    grids = {k: np.asarray(v) for k, v in st.grids.items()}
    bound = np.asarray(st.bound)
    rng = np.random.RandomState(5)
    p = rng.uniform(bound[:, 0], bound[:, 1], (120, 3)).astype(np.float32)
    w = rng.randn(120, 4).astype(np.float32)

    def f(g):
        return jnp.sum(jax_model_apply(params, spec_j, g, bound, p, stage,
                                       fused=False) * w)

    out_j = jax_model_apply(params, spec_j, grids, bound, p, stage,
                            fused=False)
    gg_j = jax.grad(f)(grids)
    gt = {k: v.clone().requires_grad_(True)
          for k, v in params_from_jax(grids, device="cpu").items()}
    out_t = model_apply(params_from_jax(params, device="cpu"), ModelSpec(),
                        gt, torch.tensor(bound), torch.tensor(p), stage)
    used = [k for k in gt if k in {"coarse": ["coarse"],
                                   "middle": ["middle"],
                                   "fine": ["middle", "fine"],
                                   "color": ["middle", "fine",
                                             "color"]}[stage]]
    gg_t = torch.autograd.grad((out_t * torch.tensor(w)).sum(),
                               [gt[k] for k in used])
    np.testing.assert_allclose(n(out_t), np.asarray(out_j), **TOL)
    for k, a in zip(used, gg_t):
        np.testing.assert_allclose(n(a), np.asarray(gg_j[k]), **TOL)


@pytest.mark.parametrize("stage", ["fine", "color"])
@pytest.mark.parametrize("width", [(16, 64, "fourier"), (32, 32, "nerf")],
                         ids=["c16_h64_fourier", "c32_h32_nerf"])
def test_model_apply_other_widths_match_jax(width, stage):
    """At widths or embeddings the fused decode does not take, model_apply
    runs the unfused composition (on every device; here the CPU): its
    output and its gradients with respect to the points, every grid and
    every decoder weight against JAX model_apply on the same weights and
    grids.  atol 1e-5 (rtol 1e-5 where weight gradients reach O(1))."""
    c_dim, hidden, emb = width
    spec_j = nice_model_spec(c_dim=c_dim, hidden=hidden,
                             pos_embedding_method=emb)
    spec = ModelSpec(c_dim=c_dim, hidden=hidden, pos_embedding_method=emb)
    assert not fused_route(spec) and fused_route(ModelSpec())
    st = jax_make_map_state(jax.random.PRNGKey(6), spec_j,
                            [[-1.0, 2.0], [-1.0, 1.5], [-0.5, 2.0]],
                            {"coarse": 1.0, "middle": 0.32, "fine": 0.16,
                             "color": 0.16}, 0.32)
    params = jax.tree.map(np.asarray, st.params)
    grids = {k: np.asarray(v) for k, v in st.grids.items()}
    bound = np.asarray(st.bound)
    rng = np.random.RandomState(7)
    p = rng.uniform(bound[:, 0], bound[:, 1], (96, 3)).astype(np.float32)
    w = rng.randn(96, 4).astype(np.float32)

    def f(params_, grids_, p_):
        return jnp.sum(jax_model_apply(params_, spec_j, grids_, bound, p_,
                                       stage, fused=False) * w)

    out_j = jax_model_apply(params, spec_j, grids, bound, p, stage,
                            fused=False)
    gp_j, gg_j, gpt_j = jax.grad(f, argnums=(0, 1, 2))(params, grids, p)
    pt = jax.tree.map(lambda a: torch.tensor(a, requires_grad=True), params)
    gt = {k: torch.tensor(v, requires_grad=True) for k, v in grids.items()}
    ptt = torch.tensor(p, requires_grad=True)
    out_t = model_apply(pt, spec, gt, torch.tensor(bound), ptt, stage)
    leaves_j = jax.tree.leaves(gp_j)
    leaves_t = jax.tree.leaves(pt)
    used = ["middle", "fine"] + (["color"] if stage == "color" else [])
    got = torch.autograd.grad((out_t * torch.tensor(w)).sum(),
                              leaves_t + [gt[k] for k in used] + [ptt],
                              allow_unused=True)
    tol = dict(atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(n(out_t), np.asarray(out_j), **tol)
    for a, b in zip(got[:len(leaves_t)], leaves_j):
        a = np.zeros_like(b) if a is None else n(a)
        np.testing.assert_allclose(a, np.asarray(b), **tol)
    for k, a in zip(used, got[len(leaves_t):-1]):
        np.testing.assert_allclose(n(a), np.asarray(gg_j[k]), **tol)
    np.testing.assert_allclose(n(got[-1]), np.asarray(gpt_j), **tol)


def test_convert_roundtrip():
    params = jax.tree.map(np.asarray, jax_init_model(jax.random.PRNGKey(1),
                                                     nice_model_spec()))
    back = params_to_numpy(params_from_jax(params, device="cpu"))
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)


def test_engine_runs_at_other_width(tmp_path):
    """A 5-frame NICE run of the port's engine on the CPU at c_dim 16,
    hidden 64 (the decoders keep their random init: the repository's
    pretrained weights are width 32), without the coarse level, whose
    feature-only MLP takes c_dim == hidden in both packages as in the
    reference: every pose finite, ATE finite."""
    from nice_slam_torch.config import load_config
    from nice_slam_torch.engine import SlamEngine

    cfg = load_config(overrides={
        "dataset": "synthetic", "synthetic": {"n_frames": 5},
        "model": {"c_dim": 16, "hidden_size": 64}, "coarse": False,
        "cam": {"H": 30, "W": 40, "fx": 30.0, "fy": 30.0, "cx": 19.5,
                "cy": 14.5, "crop_edge": 0},
        "mapping": {"bound": [[-0.5, 4.5], [-0.5, 3.5], [-0.5, 4.5]],
                    "every_frame": 2, "iters_first": 20, "iters": 6,
                    "pixels": 120, "keyframe_every": 2},
        "tracking": {"iters": 4, "pixels": 60, "ignore_edge_W": 2,
                     "ignore_edge_H": 2},
        "rendering": {"N_samples": 8, "N_surface": 4}})
    eng = SlamEngine(cfg, output=str(tmp_path), device="cpu")
    assert eng.map_state.grids["fine"].shape[-1] == 16
    eng.run()
    assert eng.frames_done == 5
    assert np.isfinite(eng.est_c2w).all()
    assert np.isfinite(eng.ate()["rmse"])
