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
from nice_slam_torch.models.decoders import ModelSpec, model_apply  # noqa: E402
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
    ws_t = list(fd.pack_nice_weights(params_from_jax(params)))
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
          for k, v in params_from_jax(grids).items()}
    out_t = model_apply(params_from_jax(params), ModelSpec(), gt,
                        torch.tensor(bound), torch.tensor(p), stage)
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


def test_convert_roundtrip():
    params = jax.tree.map(np.asarray, jax_init_model(jax.random.PRNGKey(1),
                                                     nice_model_spec()))
    back = params_to_numpy(params_from_jax(params))
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)
