"""The fused decode's wrapper and kernels, with no JAX imported (so this
file also runs on a GPU machine: `pytest tests/test_torch_kernels.py -m
cuda --noconftest`).

On the CPU: the autograd Function (plain forward + the hand VJP that the
backward kernel transcribes) against autograd of the plain forward, the
hand VJP against autograd, the packed weight layout against the CUDA
source.  On a card (marker `cuda`, skipped without one): the kernels
against the plain version, and the engine's main path on a tiny config.
Tolerance: atol 1e-4, rtol 1e-4 unless stated."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nice_slam_torch.models.decoders import ModelSpec, init_model  # noqa: E402
from nice_slam_torch.ops import fused_decode as fd  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def n(x):
    return x.detach().cpu().numpy()


@pytest.fixture(scope="module")
def weights():
    params = init_model(torch.Generator().manual_seed(0), ModelSpec())
    return list(fd.pack_nice_weights(params))


def _inputs(N=96, seed=1):
    rng = np.random.RandomState(seed)
    p = rng.uniform(-2, 2, (N, 3)).astype(np.float32)
    cs = [(rng.randn(N, 32) * 0.2).astype(np.float32) for _ in range(3)]
    g = rng.randn(N, 4).astype(np.float32)
    return p, cs, g


@pytest.mark.parametrize("with_color", [False, True], ids=["fine", "color"])
@pytest.mark.parametrize("train", [False, True], ids=["frozen", "train"])
def test_fused_function_cpu_matches_autograd(weights, with_color, train):
    """FusedNiceDecode on CPU tensors (plain forward + the hand VJP that
    the backward kernel transcribes) against autograd of the plain
    forward; train=False returns no weight gradient."""
    ws_t = weights
    p, (cm, cf, cc), g = _inputs(N=80, seed=2)
    cc_in = cc if with_color else cm

    def grads(fn):
        xs = [torch.tensor(a, requires_grad=True) for a in (p, cm, cf, cc_in)]
        wt = [w.clone().requires_grad_(True) for w in ws_t]
        out = fn(xs, wt)
        return out, torch.autograd.grad((out * torch.tensor(g)).sum(),
                                        xs + wt, allow_unused=True)

    out_f, g_f = grads(lambda xs, wt: fd.fused_nice_decode(
        with_color, train, *xs, *wt))
    out_r, g_r = grads(lambda xs, wt: fd.reference_nice_decode(
        with_color, *xs, *wt))
    np.testing.assert_allclose(n(out_f), n(out_r), atol=1e-6)
    n_in = 4 if with_color else 3   # c_color is not read in the fine stage
    for a, b in zip(g_f[:n_in], g_r[:n_in]):
        np.testing.assert_allclose(n(a), n(b), **TOL)
    for a, b in zip(g_f[4:], g_r[4:]):
        if not train:
            assert a is None
        else:
            b = torch.zeros_like(a) if b is None else b
            np.testing.assert_allclose(n(a), n(b), **TOL)


@pytest.mark.parametrize("dec", [0, 1, 2], ids=["middle", "fine", "color"])
def test_mlp_backward_matches_autograd(weights, dec):
    ws_t = weights
    rng = np.random.RandomState(3)
    N = 40
    C = 64 if dec == 1 else 32
    O = 4 if dec == 2 else 1
    p = torch.tensor(rng.uniform(-2, 2, (N, 3)).astype(np.float32),
                     requires_grad=True)
    c = torch.tensor((rng.randn(N, C) * 0.2).astype(np.float32),
                     requires_grad=True)
    dout = torch.tensor(rng.randn(N, O).astype(np.float32))
    args = [a.clone().requires_grad_(True) if isinstance(a, torch.Tensor)
            else [x.clone().requires_grad_(True) for x in a]
            for a in fd._unpack(ws_t, dec)]
    flat_w = [args[0]] + args[1] + args[2] + args[3] + args[4] + args[5:]
    out = fd._mlp_forward(p, c, *args)
    want = torch.autograd.grad((out * dout).sum(), [p, c] + flat_w)
    dp, dc, wg = fd._mlp_backward(dout, p.detach(), c.detach(),
                                  *[a.detach() if isinstance(a, torch.Tensor)
                                    else [x.detach() for x in a]
                                    for a in args])
    for a, b in zip([dp, dc] + wg, want):
        np.testing.assert_allclose(n(a), n(b), **TOL)


def test_weight_layout_matches_kernel_source():
    """The padded packed layout of ops/fused_decode.py is the one the CUDA
    source compiles in (B padded to 280 floats, decoders at 0 / 15804 /
    36728, 52628 floats in all)."""
    offs, total = fd.weight_offsets()
    assert offs[1] == 280 and total == 52628
    assert [offs[0], offs[23], offs[46]] == [0, 15804, 36728]
    src = open(os.path.join(REPO, "nice_slam_torch", "csrc",
                            "fused_decode.cu")).read()
    assert "static constexpr int W0 = 280;" in src
    assert "__sinf" not in src and "__cosf" not in src
    shapes = fd.weight_shapes()
    assert sum(r * c for r, c in shapes) == 15800 + 20920 + 15899


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the fused decode kernels)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("with_color", [False, True], ids=["fine", "color"])
def test_kernels_match_plain_on_cuda(weights, cuda_device, with_color):
    """K1/K2 against the plain version on the card (N=700, ragged):
    forward atol 1e-4; dp/dc rtol 1e-3 atol 1e-4 (this input has no ReLU
    within reach of a flip); weight gradients cosine > 0.9999."""
    ws_t = weights
    p, (cm, cf, cc), g = _inputs(N=700, seed=6)
    dev = cuda_device
    ws = [w.to(dev).contiguous() for w in ws_t]
    cc_in = cc if with_color else cm

    def run(fn):
        xs = [torch.tensor(a, device=dev, requires_grad=True)
              for a in (p, cm, cf, cc_in)]
        wt = [w.clone().requires_grad_(True) for w in ws]
        out = fn(xs, wt)
        gr = torch.autograd.grad((out * torch.tensor(g, device=dev)).sum(),
                                 xs + wt, allow_unused=True)
        torch.cuda.synchronize()
        return out, gr

    before = fd.launch_counts()
    out_k, g_k = run(lambda xs, wt: fd.fused_nice_decode(with_color, True,
                                                         *xs, *wt))
    after = fd.launch_counts()
    assert after["fused_decode_fwd"] == before["fused_decode_fwd"] + 1
    assert after["fused_decode_bwd"] == before["fused_decode_bwd"] + 1
    out_r, g_r = run(lambda xs, wt: fd.reference_nice_decode(with_color,
                                                             *xs, *wt))
    np.testing.assert_allclose(n(out_k), n(out_r), atol=1e-4)
    for a, b in zip(g_k[:3], g_r[:3]):
        np.testing.assert_allclose(n(a), n(b), rtol=1e-3, atol=1e-4)
    for a, b in zip(g_k[4:], g_r[4:]):
        b = torch.zeros_like(a) if b is None else b
        if float(b.norm()) > 0:
            cos = float((a * b).sum() / (a.norm() * b.norm()))
            assert cos > 0.9999


@pytest.mark.cuda
def test_engine_main_path_on_cuda(cuda_device):
    """The strict main path on a tiny synthetic config on the card: both
    kernels launch, the trajectory is finite and tracks the scene."""
    from nice_slam_torch.config import load_config
    from nice_slam_torch.engine import SlamEngine

    cfg = load_config(overrides={
        "dataset": "synthetic", "synthetic": {"n_frames": 5},
        "cam": {"H": 60, "W": 80, "fx": 60.0, "fy": 60.0, "cx": 39.5,
                "cy": 29.5, "crop_edge": 0},
        "grid_len": {"coarse": 1.0},
        "mapping": {"bound": [[-0.5, 4.5], [-0.5, 3.5], [-0.5, 4.5]],
                    "every_frame": 2, "iters_first": 60, "iters": 10,
                    "pixels": 300, "keyframe_every": 2},
        "tracking": {"iters": 8, "pixels": 100, "ignore_edge_W": 5,
                     "ignore_edge_H": 5},
        "rendering": {"N_samples": 16, "N_surface": 8}})
    eng = SlamEngine(cfg, device="cuda")
    fd.reset_launch_counts()
    eng.run()
    counts = fd.launch_counts()
    assert counts["fused_decode_fwd"] > 0 and counts["fused_decode_bwd"] > 0
    assert np.isfinite(eng.est_c2w).all()
    assert eng.ate()["rmse"] < 0.25
