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
CSRC = os.path.join(REPO, "nice_slam_torch", "csrc")


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
    sources compile in, csrc/fused_decode_layout.cuh (B padded to 280
    floats, decoders at 0 / 15804 / 36728, 52628 floats in all)."""
    offs, total = fd.weight_offsets()
    assert offs[1] == 280 and total == 52628
    assert [offs[0], offs[23], offs[46]] == [0, 15804, 36728]
    src = open(os.path.join(CSRC, "fused_decode_layout.cuh")).read()
    assert "static constexpr int W0 = 280;" in src
    shapes = fd.weight_shapes()
    assert sum(r * c for r, c in shapes) == 15800 + 20920 + 15899


LIVE_CPU = {"none": (), "color": ("color",), "fine_color": ("fine", "color")}


@pytest.mark.parametrize("with_color", [False, True], ids=["fine", "color"])
@pytest.mark.parametrize("live", list(LIVE_CPU), ids=list(LIVE_CPU))
def test_fused_function_live_sets_cpu(weights, with_color, live):
    """Weight gradients only for the live decoders, taken from which
    weights require a gradient (train_weights=True): the live decoders'
    gradients equal autograd of the plain forward (atol/rtol 1e-4), the
    frozen ones are None; dp and dc as in autograd."""
    decs = LIVE_CPU[live]
    p, (cm, cf, cc), g = _inputs(N=72, seed=4)
    cc_in = cc if with_color else cm

    def grads(fn):
        xs = [torch.tensor(a, requires_grad=True) for a in (p, cm, cf, cc_in)]
        wt = [w.clone().requires_grad_(
            fd.DECS[k // fd.N_PER_DEC] in decs) for k, w in enumerate(weights)]
        out = fn(xs, wt)
        want = xs + [w for w in wt if w.requires_grad]
        got = list(torch.autograd.grad((out * torch.tensor(g)).sum(), want,
                                       allow_unused=True))
        return got[:4], [got.pop(4) if w.requires_grad else None for w in wt]

    x_f, w_f = grads(lambda xs, wt: fd.fused_nice_decode(with_color, True,
                                                         *xs, *wt))
    x_r, w_r = grads(lambda xs, wt: fd.reference_nice_decode(with_color,
                                                             *xs, *wt))
    for a, b in zip(x_f[:4 if with_color else 3], x_r):
        np.testing.assert_allclose(n(a), n(b), **TOL)
    for k, (a, b) in enumerate(zip(w_f, w_r)):
        if fd.DECS[k // fd.N_PER_DEC] not in decs:
            assert a is None and b is None
            continue
        b = torch.zeros_like(a) if b is None else b
        np.testing.assert_allclose(n(a), n(b), **TOL)


def test_live_mask_from_needs_input_grad():
    """The backward's live mask: bit d when weight gradients are asked for
    and any of decoder d's 23 weights needs one."""
    class Ctx:
        pass

    ctx = Ctx()
    ctx.train_weights = True
    need = [False] * 6 + [False] * (3 * fd.N_PER_DEC)
    need[6 + 2 * fd.N_PER_DEC + 22] = True     # the colour decoder's bo
    need[6 + fd.N_PER_DEC] = True              # the fine decoder's B
    ctx.needs_input_grad = tuple(need)
    assert fd._live_mask(ctx) == 0b110
    ctx.train_weights = False
    assert fd._live_mask(ctx) == 0


def test_kernel_sources_keep_fp32():
    """The embedding stays in full-precision sinf/cosf in both kernels, and
    every tensor-core product of the backward is 3xTF32: each operand split
    into its round-to-nearest TF32 part (cvt.rna.tf32, or for a weight the
    same rounding by integer add-and-mask) and the remainder, and the only
    caller of the TF32 mma is the three-product mma3_split."""
    srcs = {name: open(os.path.join(CSRC, name)).read()
            for name in ("fused_decode.cu", "fused_decode_bwd.cu",
                         "fused_decode_layout.cuh")}
    for name, src in srcs.items():
        assert "__sinf" not in src and "__cosf" not in src, name
        assert "__sincosf" not in src, name
        assert "bf16" not in src and "__half" not in src, name
    bwd = srcs["fused_decode_bwd.cu"]
    assert "cvt.rna.tf32.f32" in bwd
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in bwd
    assert "big = to_tf32(x);" in bwd
    assert "small = __float_as_uint(x - __uint_as_float(big));" in bwd
    # mma_tf32: one definition and the three calls inside mma3_split, which
    # mma3 calls after splitting its operand
    assert bwd.count("mma_tf32(") == 4
    body = bwd[bwd.index("void mma3_split("):]
    body = body[:body.index("\n}\n")]
    assert body.count("mma_tf32(") == 3
    assert "a.lo, b0h" in body and "a.hi, b0l" in body and "a.hi, b0h" in body
    for name, split in (("mma3", "split_w("), ("mma3_act", "split_tf32(")):
        body = bwd[bwd.index(f"void {name}("):]
        body = body[:body.index("\n}\n")]
        assert body.count(split) == 2 and "mma3_split(" in body
    # a weight's rounding: cvt.rna's result by integer add-and-mask
    assert "big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;" in bwd


def test_sincos_fp32_accuracy():
    """The backward's branch-free sin/cos (sincos_fp32, constants read from
    the CUDA source) stays within 2 ulp of double precision, the bound
    CUDA gives for sinf/cosf: random arguments up to 3,000, magnitudes
    from 1e-6 to 1e5, and the floats next to multiples of pi/2 (where the
    reduction cancels) up to 1.5e5.  FMA is emulated in float64 (the
    product of two floats is exact there)."""
    import re

    src = open(os.path.join(CSRC, "fused_decode_bwd.cu")).read()
    body = src[src.index("void sincos_fp32("):]
    body = body[:body.index("\n}\n")]
    k = [np.float32(v[:-1]) for v in
         re.findall(r"-?\d+\.\d+(?:e[-+]?\d+)?f", body)]
    assert len(k) == 12
    f32, f64 = np.float32, np.float64

    def fma(a, b, c):
        return (a.astype(f64) * f64(b) + f64(c)).astype(f32) if np.ndim(a) \
            else f32(f64(a) * f64(b) + f64(c))

    def sincos(x):
        j = np.rint(x * k[0]).astype(f32)
        r = fma(j, k[1], x)
        r = fma(j, k[2], r)
        r = fma(j, k[3], r)
        z = (r * r).astype(f32)
        ps = fma(z, k[4], k[5])
        ps = (z.astype(f64) * ps + f64(k[6])).astype(f32)
        sr = ((r * z).astype(f32).astype(f64) * ps + r).astype(f32)
        pc = fma(z, k[7], k[8])
        pc = (z.astype(f64) * pc + f64(k[9])).astype(f32)
        pc = (z.astype(f64) * pc + f64(k[10])).astype(f32)
        cr = (z.astype(f64) * pc + f64(k[11])).astype(f32)
        q = j.astype(np.int64)
        sv, cv = np.where(q & 1, cr, sr), np.where(q & 1, sr, cr)
        return (np.where(q & 2, -sv, sv),
                np.where((q + 1) & 2, -cv, cv))

    def ulps(got, want):
        w = np.abs(want.astype(f32)).astype(f64)
        ulp = np.maximum(np.ldexp(1.0, np.frexp(np.maximum(w, 1e-30))[1]
                                  - 24), 2.0 ** -149)
        return np.abs(got.astype(f64) - want) / ulp

    rng = np.random.RandomState(0)
    mags = np.exp(rng.uniform(np.log(1e-6), np.log(1e5), 200000))
    near = (np.arange(1, 100000, 7) * (np.pi / 2)).astype(f32)
    near = (near.view(np.int32)[:, None] + np.arange(-8, 9)).ravel()
    x = np.concatenate([rng.uniform(-3000, 3000, 300000), mags, -mags,
                        near.view(f32)]).astype(f32)
    s_, c_ = sincos(x)
    xd = x.astype(f64)
    assert ulps(s_, np.sin(xd)).max() < 2.0
    assert ulps(c_, np.cos(xd)).max() < 2.0


def test_bwd_image_layout():
    """The backward's shared-memory image (built by one gather from the
    packed buffer) holds every weight exactly once, reads its padding from
    a zero slot, and lays each 32-wide matrix out so that both fragment
    reads of the kernel touch 32 distinct banks: the forward's W[8kb + 2t
    + j][8nb + g] and the transposed float2 W[8nb + g][8kb + 2t : +2]
    (lane = 4g + t)."""
    idx = fd.bwd_image_index()
    offs, total = fd.weight_offsets()
    img_offs, img_total = fd.bwd_image_layout()
    assert idx.shape == (img_total,) and img_offs == [0, 19940, 46280]
    counts = np.bincount(idx, minlength=total)
    real = np.zeros(total, bool)
    for o, (r, c) in zip(offs, fd.weight_shapes()):
        real[o:o + r * c] = True
    assert (counts[real] == 1).all()
    zero = offs[0] + 3 * fd.EMB
    assert not real[zero] and set(np.unique(idx[~real[idx]])) == {zero}
    flat = fd.pack_flat(weights_list := [
        torch.randn(r, c) for r, c in fd.weight_shapes()])
    img = flat[torch.from_numpy(idx)]
    # W1 of the fine decoder, element (r, c) at r * 40 + (c ^ ((r & 4) << 1))
    w1 = weights_list[fd.N_PER_DEC + 2]
    base = img_offs[1] + 288 + 96 * 40
    for r in range(32):
        for c in range(32):
            assert float(img[base + r * 40 + (c ^ ((r & 4) << 1))]) == \
                float(w1[r, c])

    def addr(r, c):
        return r * 40 + (c ^ ((r & 4) << 1))

    lanes = [(lane >> 2, lane & 3) for lane in range(32)]
    for kb in range(16):
        for nb in range(4):
            for j in (0, 1):
                banks = {addr(8 * kb + 2 * t + j, 8 * nb + g) % 32
                         for g, t in lanes}
                assert len(banks) == 32
    for nb in range(16):
        for kb in range(4):
            for half in (lanes[:16], lanes[16:]):   # 64-bit: two phases
                banks = [(addr(8 * nb + g, 8 * kb + 2 * t) + w) % 32
                         for g, t in half for w in (0, 1)]
                assert len(set(banks)) == 32


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the fused decode kernels)")
    return torch.device("cuda")


LIVE_SETS = {"none": 0, "color": 4, "all": 7}


@pytest.mark.cuda
@pytest.mark.parametrize("N", [700, 9600])
@pytest.mark.parametrize("live", list(LIVE_SETS), ids=list(LIVE_SETS))
@pytest.mark.parametrize("with_color", [False, True], ids=["fine", "color"])
def test_kernels_match_plain_on_cuda(weights, cuda_device, with_color, live,
                                     N):
    """K1/K2 against the plain version on the card (N=700, ragged, and the
    tracking shape 9,600), with weight gradients for no decoder, for the
    colour decoder (the main path's colour stage) and for all three, set
    by which weights require a gradient.  Forward atol 1e-4; dp/dc rtol
    1e-3 atol 1e-4; live weight gradients cosine > 0.9999 and norm ratio
    within 1e-3; frozen decoders get None.  The cotangent of a point with
    a ReLU pre-activation within 1e-4 of zero is set to zero in both runs
    (the two summation orders can flip such a ReLU)."""
    mask = LIVE_SETS[live]
    p, (cm, cf, cc), g = _inputs(N=N, seed=6)
    dev = cuda_device
    ws = [w.to(dev).contiguous() for w in weights]
    cc_in = cc if with_color else cm
    pt, cmt, cft, cct = (torch.tensor(a, device=dev)
                         for a in (p, cm, cf, cc_in))
    with torch.no_grad():
        mins = []
        for d, c in ((0, cmt), (1, torch.cat([cft, cmt], dim=-1)),
                     (2, cct))[:3 if with_color else 2]:
            _, (_, _, zs, _) = fd._mlp_forward(pt, c, *fd._unpack(ws, d),
                                               save=True)
            mins.append(torch.stack([z.abs().amin(1) for z in zs]).amin(0))
        steady = torch.stack(mins).amin(0) >= 1e-4
    assert float(steady.float().mean()) > 0.9
    cot = torch.tensor(g, device=dev) * steady[:, None]

    def run(fn):
        xs = [t.clone().requires_grad_(True) for t in (pt, cmt, cft, cct)]
        wt = [w.clone().requires_grad_(bool(mask >> (k // fd.N_PER_DEC) & 1))
              for k, w in enumerate(ws)]
        out = fn(xs, wt)
        want = xs + [w for w in wt if w.requires_grad]
        gr = list(torch.autograd.grad((out * cot).sum(), want,
                                      allow_unused=True))
        torch.cuda.synchronize()
        wg = [gr.pop(4) if w.requires_grad else None for w in wt]
        return out, gr[:4], wg

    before = fd.launch_counts()
    out_k, g_k, w_k = run(lambda xs, wt: fd.fused_nice_decode(
        with_color, True, *xs, *wt))
    after = fd.launch_counts()
    assert after["fused_decode_fwd"] == before["fused_decode_fwd"] + 1
    assert after["fused_decode_bwd"] == before["fused_decode_bwd"] + 1
    out_r, g_r, w_r = run(lambda xs, wt: fd.reference_nice_decode(
        with_color, *xs, *wt))
    np.testing.assert_allclose(n(out_k), n(out_r), atol=1e-4)
    for a, b in zip(g_k[:4 if with_color else 3],
                    g_r[:4 if with_color else 3]):
        np.testing.assert_allclose(n(a), n(b), rtol=1e-3, atol=1e-4)
    for k, (a, b) in enumerate(zip(w_k, w_r)):
        if not mask >> (k // fd.N_PER_DEC) & 1:
            assert a is None
            continue
        b = torch.zeros_like(a) if b is None else b
        na, nb = float(a.norm()), float(b.norm())
        if nb == 0.0:
            assert na == 0.0, k
            continue
        cos = float((a * b).sum()) / (na * nb)
        assert cos > 0.9999 and abs(na / nb - 1) < 1e-3, (k, cos, na / nb)


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
