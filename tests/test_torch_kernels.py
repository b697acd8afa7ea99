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
import re

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
    params = init_model(torch.Generator().manual_seed(0), ModelSpec(),
                        device="cpu")
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


def _body(src: str, signature: str) -> str:
    """The text of a function of a CUDA source, from its signature to the
    closing brace at column 0."""
    body = src[src.index(signature):]
    return body[:body.index("\n}\n")]


def test_kernel_sources_keep_fp32():
    """The embedding stays in full-precision fp32 sin/cos in both kernels,
    and every tensor-core product is 3xTF32: each operand split into its
    round-to-nearest TF32 part (cvt.rna.tf32, or for a weight the same
    rounding by integer add-and-mask) and the remainder, and the only
    caller of the TF32 mma is the three-product mma3_split of the shared
    trunk (fused_decode_mma.cuh), which K2 includes."""
    import re

    srcs = {name: open(os.path.join(CSRC, name)).read()
            for name in ("fused_decode.cu", "fused_decode_bwd.cu",
                         "fused_decode_layout.cuh", "fused_decode_mma.cuh")}
    for name, src in srcs.items():
        assert "__sinf" not in src and "__cosf" not in src, name
        assert "__sincosf" not in src, name
        assert "bf16" not in src and "__half" not in src, name
    bwd, mma = srcs["fused_decode_bwd.cu"], srcs["fused_decode_mma.cuh"]
    assert '#include "fused_decode_mma.cuh"' in bwd
    assert "cvt.rna.tf32.f32" in mma
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in mma
    assert "big = to_tf32(x);" in mma
    assert "small = __float_as_uint(x - __uint_as_float(big));" in mma
    # mma_tf32: one definition and the three calls inside mma3_split, which
    # mma3 calls after splitting its operand
    assert mma.count("mma_tf32(") == 4
    bwd_code = re.sub(r"//[^\n]*", "", bwd)
    assert "mma_tf32(" not in bwd_code and "mma.sync" not in bwd_code
    body = _body(mma, "void mma3_split(")
    assert body.count("mma_tf32(") == 3
    assert "a.lo, b0h" in body and "a.hi, b0l" in body and "a.hi, b0h" in body
    for name, split in (("mma3", "split_w("), ("mma3_act", "split_tf32(")):
        body = _body(mma, f"void {name}(")
        assert body.count(split) == 2 and "mma3_split(" in body
    # a weight's rounding: cvt.rna's result by integer add-and-mask
    assert "big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;" in mma


def test_forward_kernel_source():
    """K1 (fused_decode.cu) is built on the shared trunk: it includes
    fused_decode_mma.cuh, takes its TF32 products only through mma3 (and
    mm_fwd, which calls it), computes sin with the branch-free sin_fp32
    (no library sinf/cosf/sincosf, no fast intrinsic), and the old
    per-thread trunk with its Hs/mask outputs is gone."""
    import re

    src = open(os.path.join(CSRC, "fused_decode.cu")).read()
    code = re.sub(r"//[^\n]*", "", src)   # comments may name what is not used
    assert '#include "fused_decode_mma.cuh"' in code
    for name in ("sinf(", "cosf(", "sincosf(", "__sinf", "__cosf", "__expf",
                 "__sincosf", "__fdividef", "__powf"):
        assert not re.search(r"(?<![\w])" + re.escape(name), code), name
    assert "sin_fp32(" in code
    assert "mma_tf32(" not in code and "mma.sync" not in code
    assert "asm(" not in code and "asm volatile" not in code
    assert "mma3(" in code and "mm_fwd<" in code
    for gone in ("Hs", "mask", "mlp_trunk", "axpy32"):
        assert not re.search(r"\b" + gone + r"\b", code), gone
    # the sine is sincos_fp32's own reduction and polynomials
    mma = open(os.path.join(CSRC, "fused_decode_mma.cuh")).read()
    assert "sincos_fp32(x, &s, &c);" in _body(mma, "float sin_fp32(")


def test_sincos_fp32_accuracy():
    """The kernels' branch-free sin/cos (sincos_fp32, constants read from
    the shared trunk, fused_decode_mma.cuh) stays within 2 ulp of double precision, the bound
    CUDA gives for sinf/cosf: random arguments up to 3,000, magnitudes
    from 1e-6 to 1e5, and the floats next to multiples of pi/2 (where the
    reduction cancels) up to 1.5e5.  FMA is emulated in float64 (the
    product of two floats is exact there)."""
    import re

    src = open(os.path.join(CSRC, "fused_decode_mma.cuh")).read()
    body = _body(src, "void sincos_fp32(")
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
    """The kernels' shared-memory image (K1 builds it, K2 reads it; here as
    one gather from the packed buffer) holds every weight exactly once, reads its padding from
    a zero slot, and lays each 32-wide matrix out so that both fragment
    reads of the kernel touch 32 distinct banks: the forward's W[8kb + 2t
    + j][8nb + g] and the transposed float2 W[8nb + g][8kb + 2t : +2]
    (lane = 4g + t)."""
    idx = fd.image_index()
    offs, total = fd.weight_offsets()
    img_offs, img_total = fd.image_layout()
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


def test_build_image_matches_packed_gather():
    """The image the forward builds straight from the weights (one
    concatenation and one gather) equals the gather of the packed buffer,
    pack_flat(ws)[image_index()], bit for bit, for random weights of which
    some are Fortran-order (transposed) views, as the npz decoders load."""
    rng = np.random.RandomState(7)
    ws = []
    for k, (r, c) in enumerate(fd.weight_shapes()):
        a = rng.randn(r, c).astype(np.float32)
        if k % 3 == 0 and r > 1 and c > 1:
            t = torch.from_numpy(np.asfortranarray(a))
            assert not t.is_contiguous()
        else:
            t = torch.from_numpy(a)
        ws.append(t)
    img = fd.build_image(ws)
    want = fd.pack_flat(ws)[torch.from_numpy(fd.image_index())]
    assert img.dtype == torch.float32 and img.shape == want.shape
    assert torch.equal(img.view(torch.int32), want.view(torch.int32))
    # padding reads the zero slot
    zero = fd.image_index() == fd.weight_offsets()[0][0] + 3 * fd.EMB
    assert zero.sum() > 0 and float(img[torch.from_numpy(zero)].abs().max()) == 0.0


def test_schedule_launches_by_kind():
    """chip_smoke.py's schedule of the main path (11 frames of the synthetic
    config): K1 517 times at 48,000 points in the colour stage, 112 in the
    fine stage and 518 at the tracking shape (500 iterations and 18
    init_select renders); K2 1129 times."""
    import runpy

    from nice_slam_torch.config import load_config

    cs = runpy.run_path(os.path.join(REPO, "chip_smoke.py"),
                        run_name="not_main")
    cfg = load_config(cs["SYN_CFG"], overrides={"synthetic": {"n_frames": 11}})
    fwd, bwd, kinds = cs["expected_launches"](cfg, 11)
    assert (fwd, bwd) == (1147, 1129)
    assert kinds == {"color n=48000": 517, "fine n=48000": 112,
                     "color n=9600": 518}


def test_forward_launch_kinds_counter():
    """fwd_launch_kinds and bwd_launch_kinds start empty after
    reset_launch_counts, and the CPU path launches no kernel."""
    fd.reset_launch_counts()
    assert fd.fwd_launch_kinds() == {} and fd.bwd_launch_kinds() == {}
    assert fd.launch_counts() == {"fused_decode_fwd": 0,
                                  "fused_decode_bwd": 0}


def test_ablation_patches_apply():
    """Every variant of the decode ablation tool finds its patch targets in
    the current sources (a stale target raises there), changes something
    (apart from base), and patches the shared trunk only in its own copy."""
    from nice_slam_torch.tools import decode_ablation as da

    for kernel, (source, variants) in da.VARIANTS.items():
        base = da.patched_sources(kernel, "base")
        assert set(base) == {source, *da.HEADERS}
        assert base[source] == open(os.path.join(CSRC, source)).read()
        for name in variants:
            texts = da.patched_sources(kernel, name)
            changed = [f for f in texts if texts[f] != base[f]]
            assert (name == "base") == (not changed), (kernel, name)
    mma = open(os.path.join(CSRC, da.MMA)).read()
    assert da.patched_sources("k1", "one_mma")[da.MMA] != mma
    assert mma.count("mma_tf32(d, a.lo, b0h, b1h);") == 1


def test_wrappers_launch_inside_the_tensors_device_guard(monkeypatch):
    """K1's and K2's C entries launch on the current device, so each
    wrapper makes p's device current around its launch (a mocked launch
    records the device guards open at the call)."""
    from types import SimpleNamespace

    open_guards = []

    class Guard:
        def __init__(self, dev):
            self.dev = dev

        def __enter__(self):
            open_guards.append(self.dev)

        def __exit__(self, *exc):
            open_guards.pop()

    seen = []

    class Lib:
        def nice_decode_fwd(self, *args):
            seen.append(("fwd", list(open_guards)))
            return 0

        def nice_decode_bwd(self, *args):
            seen.append(("bwd", list(open_guards)))
            return 0

    dev = torch.device("cuda", 1)
    part = torch.zeros(2, 1, 3)
    monkeypatch.setattr(fd.torch.cuda, "device", Guard)
    monkeypatch.setattr(fd, "_kernels", Lib)
    monkeypatch.setattr(fd, "_bwd_kernels", Lib)
    monkeypatch.setattr(fd, "_fwd_prepare", lambda *a: ((), "out", None))
    monkeypatch.setattr(fd, "_bwd_prepare",
                        lambda *a: ((), (part, 1, 2, 3, 4), None))
    p = SimpleNamespace(device=dev)
    assert fd._launch_fwd(True, p, None, None, None, None) == "out"
    dp, *rest = fd._launch_bwd(True, 0, p, None, None, None, None, None)
    assert torch.equal(dp, part.sum(0)) and rest == [1, 2, 3, 4]
    assert seen == [("fwd", [dev]), ("bwd", [dev])]
    assert open_guards == []


def test_smem_limit_is_set_per_device():
    """The shared-memory attribute is set once per device ordinal (a
    process that launches on a second card sets it there too), not once
    per process."""
    for name, fn in (("fused_decode.cu", "int set_smem_limit() {"),
                     ("fused_decode_bwd.cu", "int set_smem_limits() {")):
        src = open(os.path.join(CSRC, name)).read()
        body = _body(src, fn)
        assert "cudaGetDevice(&dev)" in body, name
        assert "done[dev]" in body and "static int done = 0" not in body


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
    kind = f"{'color' if with_color else 'fine'} n={N}"
    kinds_before = fd.fwd_launch_kinds().get(kind, 0)
    out_k, g_k, w_k = run(lambda xs, wt: fd.fused_nice_decode(
        with_color, True, *xs, *wt))
    after = fd.launch_counts()
    assert after["fused_decode_fwd"] == before["fused_decode_fwd"] + 1
    assert after["fused_decode_bwd"] == before["fused_decode_bwd"] + 1
    assert fd.fwd_launch_kinds()[kind] == kinds_before + 1
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
def test_kernels_launch_on_a_second_card(weights):
    """With cuda:0 current, K1 and K2 on tensors of the last card match
    the plain version there (the per-device shared-memory attribute and
    the wrappers' device guard; atol 1e-4 forward, rtol 1e-3 atol 1e-4 on
    dp and dc, the cotangent of ReLU-flip points zeroed, as the one-card
    check)."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices (a launch on a second card)")
    dev = torch.device("cuda", torch.cuda.device_count() - 1)
    p, (cm, cf, cc), g = _inputs(N=700, seed=8)
    ws = [w.to(dev).contiguous() for w in weights]
    pt, cmt, cft, cct = (torch.tensor(a, device=dev) for a in (p, cm, cf, cc))
    with torch.no_grad():
        mins = []
        for d, c in ((0, cmt), (1, torch.cat([cft, cmt], dim=-1)),
                     (2, cct)):
            _, (_, _, zs, _) = fd._mlp_forward(pt, c, *fd._unpack(ws, d),
                                               save=True)
            mins.append(torch.stack([z.abs().amin(1) for z in zs]).amin(0))
        # points whose ReLU could flip between summation orders: no
        # cotangent (as test_kernels_match_plain_on_cuda)
        g = (torch.tensor(g, device=dev)
             * (torch.stack(mins).amin(0) >= 1e-4)[:, None]).cpu().numpy()
    with torch.cuda.device(0):
        out = []
        for fn in (fd.fused_nice_decode, None):
            xs = [torch.tensor(a, device=dev, requires_grad=True)
                  for a in (p, cm, cf, cc)]
            y = (fn(True, False, *xs, *ws) if fn is not None
                 else fd.reference_nice_decode(True, *xs, *ws))
            grads = torch.autograd.grad(
                (y * torch.tensor(g, device=dev)).sum(), xs)
            torch.cuda.synchronize(dev)
            out.append((y, grads))
    (y_k, g_k), (y_r, g_r) = out
    assert y_k.device == dev
    np.testing.assert_allclose(n(y_k), n(y_r), atol=1e-4)
    for a, b in zip(g_k, g_r):
        np.testing.assert_allclose(n(a), n(b), rtol=1e-3, atol=1e-4)


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


@pytest.mark.cuda
def test_grid_backward_repeats_on_cuda(cuda_device):
    """The grid backward's fixed-order scatter on the card, at the mapping
    shape (48,000 points x 8 corners into a fine grid of the synthetic
    scene's size): 20 runs give bit-equal grid gradients."""
    from nice_slam_torch.ops.grid import trilinear_interp

    gen = torch.Generator().manual_seed(3)
    grid = (torch.randn(32, 26, 32, 32, generator=gen) * 0.01).to(
        cuda_device)
    p = (torch.rand(48000, 3, generator=gen) * 2.0 - 1.0).to(cuda_device)
    cot = torch.randn(48000, 32, generator=gen).to(cuda_device)

    def run():
        g = grid.clone().requires_grad_(True)
        return torch.autograd.grad((trilinear_interp(g, p) * cot).sum(),
                                   g)[0]

    first = run()
    for _ in range(19):
        assert torch.equal(run(), first)


@pytest.mark.cuda
def test_engine_graphs_equal_eager_on_cuda(cuda_device):
    """The strict path with its tracking and mapping iterations replayed as
    CUDA graphs (every signature: tracking, middle, fine, colour, the
    coarse mapper, the colour refinement) against the same run with the
    graphs off: trajectory, decoders, grids and tracking losses bit for
    bit, and the same kernel launch counts."""
    from nice_slam_torch.config import load_config
    from nice_slam_torch.engine import SlamEngine
    from nice_slam_torch.graphs import StepGraphs
    from nice_slam_torch.ops.tree import tree_leaves

    cfg = load_config(overrides={
        "dataset": "synthetic", "synthetic": {"n_frames": 5},
        "cam": {"H": 60, "W": 80, "fx": 60.0, "fy": 60.0, "cx": 39.5,
                "cy": 29.5, "crop_edge": 0},
        "grid_len": {"coarse": 1.0},
        "mapping": {"bound": [[-0.5, 4.5], [-0.5, 3.5], [-0.5, 4.5]],
                    "every_frame": 2, "iters_first": 30, "iters": 10,
                    "pixels": 300, "keyframe_every": 2},
        "tracking": {"iters": 8, "pixels": 100, "ignore_edge_W": 5,
                     "ignore_edge_H": 5},
        "rendering": {"N_samples": 16, "N_surface": 8}})
    runs = []
    for graphed in (True, False):
        eng = SlamEngine(cfg, device="cuda")
        if not graphed:
            eng._track_graphs = StepGraphs(cuda_device, capture=False)
            eng._map_graphs = StepGraphs(cuda_device, capture=False,
                                         max_iters=30)
        fd.reset_launch_counts()
        eng.run()
        torch.cuda.synchronize()
        st = eng.map_state
        runs.append(([eng.est_c2w_dev] + tree_leaves(st.params)
                     + list(st.grids.values()),
                     [r["best_loss"] for r in eng.stats()],
                     fd.launch_counts(), eng.graph_stats()))
    (s_g, l_g, c_g, g_g), (s_e, l_e, c_e, g_e) = runs
    assert g_g["track"]["replays"] > 0 and g_g["map"]["replays"] > 0
    assert g_e["track"]["graphs"] == g_e["map"]["graphs"] == 0
    assert all(torch.equal(a, b) for a, b in zip(s_g, s_e))
    assert l_g == l_e and c_g == c_e


@pytest.mark.cuda
def test_bias_reciprocal_matches_cuda_division(cuda_device):
    """Adam's bias corrections as the port's loops apply them (a multiply
    by ops/optim.inv_bias, read from a device table) equal the division of
    a float32 tensor by the host scalar 1 - b**step on the card, bit for
    bit, at every step of a 500-iteration call."""
    from nice_slam_torch.ops.optim import bias_tables

    gen = torch.Generator(device=cuda_device).manual_seed(0)
    m = torch.randn(1 << 16, device=cuda_device, generator=gen) * 1e-3
    tab = bias_tables(500, cuda_device)
    for r, b in enumerate((0.9, 0.999)):
        for step in range(1, 501):
            assert torch.equal(m * tab[r, step], m / (1.0 - b ** step)), (
                b, step)


# ---------------------------------------------------------------------------
# The grid backward's fixed-order scatter (ops/grid.grid_grad,
# csrc/grid_scatter.cu)

def _corner_inputs(shape, n, C, seed, sink=False, dyadic=False,
                   device="cpu"):
    """(rows (8, n), f (n, 3), g (n, C), grid rows) of n points at
    uniform random positions in [-1.1, 1.1]^3 of a grid of `shape`; with
    `sink`, about 40% of the points left out to the sink row; `dyadic`
    puts every f on a multiple of 1/4 and every g on a multiple of 1/8
    in [-2, 2), so every product is a multiple of 2^-9 under 2 and every
    partial sum of fewer than 2^14 of them is exact in fp32: any
    summation order gives the same bits."""
    from nice_slam_torch.ops.grid import _cell, _corner_rows

    rng = np.random.RandomState(seed)
    p = rng.uniform(-1.1, 1.1, (n, 3)).astype(np.float32)
    full = tuple(shape) + (C,)
    i0, i1, f, _ = _cell(full, torch.from_numpy(p))
    rows = _corner_rows(full, i0, i1)
    n_rows = shape[0] * shape[1] * shape[2]
    if sink:
        own = torch.from_numpy(rng.rand(n) < 0.6)
        rows = torch.where(own, rows, n_rows)
    if dyadic:
        f = torch.from_numpy(rng.randint(0, 5, (n, 3)).astype(np.float32)
                             / 4)
        g = torch.from_numpy(rng.randint(-16, 16, (n, C)).astype(np.float32)
                             / 8)
    else:
        g = torch.from_numpy(rng.randn(n, C).astype(np.float32))
    return rows.to(device), f.to(device), g.to(device), n_rows


def _weighted_rows(rows, f, g, dtype):
    """(8 n,) rows and (8 n, C) products g * (wx * wy) * wz in `dtype`."""
    f, g = f.to(dtype), g.to(dtype)
    w = [(1 - f[:, k:k + 1], f[:, k:k + 1]) for k in range(3)]
    vals = torch.stack([g * (w[0][a] * w[1][b] * w[2][c])
                        for a in (0, 1) for b in (0, 1) for c in (0, 1)])
    return rows.reshape(-1), vals.reshape(-1, g.shape[1])


@pytest.mark.parametrize("sink", [False, True], ids=["dense", "sink"])
def test_grid_grad_cpu_takes_the_plain_route(sink):
    """On CPU tensors grid_grad is the plain route, bit-equal to the
    weighted rows summed by scatter_rows (the sink row n sorts last and
    is dropped), and launches no kernel."""
    from nice_slam_torch.ops import grid

    rows, f, g, n_rows = _corner_inputs((2, 3, 2), 700, 16, 4, sink=sink)
    grid.reset_launch_counts()
    got = grid.grid_grad(rows, f, g, n_rows)
    r, vals = _weighted_rows(rows, f, g, torch.float32)
    want = (grid.scatter_rows(r, vals, n_rows + 1)[:n_rows] if sink
            else grid.scatter_rows(r, vals, n_rows))
    assert torch.equal(got, want)
    assert grid.launch_counts() == {"grid_scatter": 0,
                                    "grid_scatter_plain_cuda": 0}


def test_grid_grad_cuda_tensor_reaches_the_library(monkeypatch):
    """A CUDA tensor goes to the C entry of the scatter library (a mocked
    library records the call and the device guard open at it) with its
    operands in order, returns the output buffer, counts one kernel
    launch, and a CUDA error from the entry raises."""
    from types import SimpleNamespace

    from nice_slam_torch.ops import grid, launches

    open_guards, seen = [], []

    class Guard:
        def __init__(self, dev):
            self.dev = dev

        def __enter__(self):
            open_guards.append(self.dev)

        def __exit__(self, *exc):
            open_guards.pop()

    class Lib:
        err = 0

        def grid_scatter(self, *args):
            seen.append((args, list(open_guards)))
            return self.err

        def grid_scatter_error_string(self, err):
            return b"an error"

    lib = Lib()
    dev = torch.device("cuda", 1)

    def fake(shape, dtype):
        return SimpleNamespace(device=dev, dtype=dtype, shape=shape,
                               is_cuda=True)

    n = 5
    rows, f = fake((8, n), torch.int64), fake((n, 3), torch.float32)
    g = fake((n, 32), torch.float32)
    bufs = [SimpleNamespace(data_ptr=lambda i=i: 100 + i) for i in range(6)]
    monkeypatch.setattr(grid.torch.cuda, "device", Guard)
    monkeypatch.setattr(grid.torch.cuda, "current_stream",
                        lambda device: SimpleNamespace(cuda_stream=77))
    monkeypatch.setattr(grid, "_scatter_lib", lambda: lib)
    monkeypatch.setattr(grid, "_scatter_buffers", lambda *a: bufs)
    monkeypatch.setattr(launches, "_stream_state",
                        lambda device: (4242, False))
    grid.reset_launch_counts()
    assert grid.grid_grad(rows, f, g, 12) is bufs[-1]
    assert seen == [((100, 101, 102, 103, 104, 105, n, 12, 32, 77), [dev])]
    assert open_guards == []
    assert grid.launch_counts() == {"grid_scatter": 1,
                                    "grid_scatter_plain_cuda": 0}
    lib.err = 700
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        grid.grid_grad(rows, f, g, 12)
    with pytest.raises(TypeError, match="f must be torch.float32"):
        grid.grid_grad(rows, fake((n, 3), torch.float64), g, 12)
    grid.reset_launch_counts()


def test_grid_scatter_launches_credited_per_replay(monkeypatch):
    """A kernel launch made while a watched stream captures goes into the
    capture's record, not the counts, and each StepGraphs replay of the
    graph credits it, apart from the fused decode's counts; a launch into
    an unwatched capture raises."""
    from types import SimpleNamespace

    from nice_slam_torch.graphs import StepGraphs, _Graph
    from nice_slam_torch.ops import grid, launches

    stream = SimpleNamespace(cuda_stream=4242)
    state = {"capturing": True}
    monkeypatch.setattr(launches, "_stream_state",
                        lambda device: (4242, state["capturing"]))
    grid.reset_launch_counts()
    fd.reset_launch_counts()
    with launches.count_captured(stream) as rec:
        launches.count(None, "grid_scatter")
        launches.count(None, "grid_scatter")
    assert rec == {"grid_scatter": 2}
    assert grid.launch_counts()["grid_scatter"] == 0
    runner = StepGraphs("cpu", capture=False)
    graph = _Graph(SimpleNamespace(replay=lambda: None), rec, ())
    for _ in range(3):
        runner._replay(graph)
    assert grid.launch_counts() == {"grid_scatter": 6,
                                    "grid_scatter_plain_cuda": 0}
    assert fd.launch_counts() == {"fused_decode_fwd": 0,
                                  "fused_decode_bwd": 0}
    with pytest.raises(RuntimeError, match="no count_captured"):
        launches.count(None, "grid_scatter")
    state["capturing"] = False
    grid.plain_grid_grad(*_corner_inputs((2, 3, 2), 7, 16, 4)[:3], 12)
    assert grid.launch_counts()["grid_scatter_plain_cuda"] == 0
    launches.count(None, "grid_scatter_plain_cuda")
    assert grid.launch_counts()["grid_scatter_plain_cuda"] == 1
    grid.reset_launch_counts()


def test_grid_scatter_source_note_and_launch_checks():
    """csrc/grid_scatter.cu says which TPU kernel it replaces (none), why it
    was added, its byte bound and how it fixes the order; it sums with no
    atomics and rounded fp32 operations, and its C entry returns the
    error of the memset and of each launch."""
    src = open(os.path.join(CSRC, "grid_scatter.cu")).read()
    note = src[:src.index("#include")]
    for words in ("Replaces no TPU kernel", ".at[].add",
                  "segment_reduce alone took 0.624 s", "What bounds it",
                  "~35 MB", "no atomics", "fixed summation order"):
        assert words in note, words
    code = re.sub(r"//[^\n]*", "", src)
    assert "atomic" not in code
    assert "__fmul_rn(__fmul_rn(wx, wy), wz)" in code
    assert "__fadd_rn(acc, __fmul_rn(v[t], wt))" in code
    body = _body(src, "int grid_scatter(const int* keys")
    assert body.count("<<<") == 2
    assert body.count("cudaGetLastError()") == 2
    assert "err = (int)cudaMemsetAsync(" in body
    for launch in re.findall(r"<<<[^;]*;\n\s*[^\n]*", body):
        assert "cudaGetLastError()" in launch


def test_slab_grid_gradient_equals_the_dense_rows():
    """The slab form's grid gradient (points left out by `own` go to the
    sink row) equals, bit for bit, the dense grid's gradient from the
    owned points alone, over the slab's rows; the dense rows outside the
    slab are zero (every owned point's cell lies in the slab)."""
    from nice_slam_torch.ops.grid import (_cell, slab_trilinear,
                                          trilinear_interp)

    rng = np.random.RandomState(6)
    shape, C, x0, sx = (6, 3, 4), 8, 2, 3
    p = torch.from_numpy(rng.uniform(-1.1, 1.1, (900, 3)).astype(np.float32))
    i0, _, _, _ = _cell(shape + (C,), p)
    own = (i0[:, 0] >= x0) & (i0[:, 0] + 1 < x0 + sx)
    grid_ = torch.from_numpy(rng.randn(*shape, C).astype(np.float32))
    cot = torch.from_numpy(rng.randn(900, C).astype(np.float32))
    slab = grid_[x0:x0 + sx].clone().requires_grad_(True)
    out = slab_trilinear(slab, p, shape, x0, own)
    (d_slab,) = torch.autograd.grad((out * cot).sum(), slab)
    dense = grid_.clone().requires_grad_(True)
    out_d = trilinear_interp(dense, p[own])
    (d_dense,) = torch.autograd.grad((out_d * cot[own]).sum(), dense)
    assert int(own.sum()) > 100
    assert torch.equal(d_slab, d_dense[x0:x0 + sx])
    assert not d_dense[:x0].any() and not d_dense[x0 + sx:].any()


SCATTER_SHAPES = {"room0_fine": ((74, 56, 44), 48000),
                  "tiny": ((2, 3, 2), 2000)}


def _f64_bound(rows, f, g, n_rows):
    """Per-row bound of an fp32 fixed-order sum against the float64 sum:
    three roundings in each product and one in each add of a sum that is
    at most min(L, 64) deep inside a piece and ceil(L / 64) deep over the
    pieces (L: the row's entries), each at most 2^-24 of the sum of the
    terms' magnitudes."""
    r, vals = _weighted_rows(rows, f, g, torch.float64)
    keep = r < n_rows
    r, vals = r[keep], vals[keep]
    ref = torch.zeros(n_rows, g.shape[1], dtype=torch.float64,
                      device=g.device).index_add_(0, r, vals)
    mag = torch.zeros_like(ref).index_add_(0, r, vals.abs())
    length = torch.bincount(r, minlength=n_rows).double()
    depth = torch.clamp(length, max=64) + torch.ceil(length / 64) + 3
    return ref, 1.01 * depth[:, None] * 2.0**-24 * mag, length


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(SCATTER_SHAPES))
@pytest.mark.parametrize("C", [32, 16, 48])
def test_grid_scatter_kernel_on_cuda(cuda_device, shape, C):
    """The kernel against the float64 sum within the fp32 bound of its
    summation order (_f64_bound), bit-equal over 20 calls, bit-equal to
    the plain route on the card (the same pieces in the same order) on
    random and on dyadic inputs, empty rows exactly zero; one launch
    counted a call, none of the plain route but where it is called."""
    from nice_slam_torch.ops import grid

    dims, n = SCATTER_SHAPES[shape]
    rows, f, g, n_rows = _corner_inputs(dims, n, C, 9, device=cuda_device)
    grid.reset_launch_counts()
    got = grid.grid_grad(rows, f, g, n_rows)
    assert got.shape == (n_rows, C) and got.dtype == torch.float32
    ref, bound, length = _f64_bound(rows, f, g, n_rows)
    assert bool(((got.double() - ref).abs() <= bound).all())
    for _ in range(19):
        assert torch.equal(grid.grid_grad(rows, f, g, n_rows), got)
    assert grid.launch_counts() == {"grid_scatter": 20,
                                    "grid_scatter_plain_cuda": 0}
    assert torch.equal(got, grid.plain_grid_grad(rows, f, g, n_rows))
    assert grid.launch_counts()["grid_scatter_plain_cuda"] == 1
    empty = length == 0
    assert bool((got[empty] == 0).all())
    assert not bool(torch.signbit(got[empty]).any())
    if shape == "room0_fine":
        assert int(empty.sum()) > 0
    else:
        assert int(length.min()) >= 100
    rows, f, g, n_rows = _corner_inputs(dims, n, C, 10, dyadic=True,
                                        device=cuda_device)
    got = grid.grid_grad(rows, f, g, n_rows)
    r, vals = _weighted_rows(rows, f, g, torch.float32)
    assert torch.equal(got, grid.plain_grid_grad(rows, f, g, n_rows))
    assert torch.equal(got, torch.zeros_like(got).index_add_(0, r, vals))
    grid.reset_launch_counts()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(SCATTER_SHAPES))
@pytest.mark.parametrize("C", [32, 16, 48])
def test_grid_scatter_sink_rows_on_cuda(cuda_device, shape, C):
    """The slab form on the card: the sink row's entries are dropped, and
    the grid's rows equal the dense call on the owned points alone bit
    for bit (their sorted positions and so their pieces are the same)."""
    from nice_slam_torch.ops import grid

    dims, n = SCATTER_SHAPES[shape]
    rows, f, g, n_rows = _corner_inputs(dims, n, C, 11, sink=True,
                                        device=cuda_device)
    got = grid.grid_grad(rows, f, g, n_rows)
    own = rows[0] < n_rows
    dense = grid.grid_grad(rows[:, own], f[own], g[own], n_rows)
    assert int(own.sum()) < n
    assert torch.equal(got, dense)
    assert torch.equal(got, grid.plain_grid_grad(rows, f, g, n_rows))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(SCATTER_SHAPES))
@pytest.mark.parametrize("C", [32, 16, 48])
def test_grid_scatter_graph_replay_on_cuda(cuda_device, shape, C):
    """A call captured into a CUDA graph and replayed on new inputs (copied
    into the captured buffers) equals the eager call on them bit for bit;
    the capture's record holds one launch."""
    from nice_slam_torch.ops import grid, launches

    dims, n = SCATTER_SHAPES[shape]
    bufs = _corner_inputs(dims, n, C, 12, device=cuda_device)
    rows, f, g, n_rows = bufs
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        grid.grid_grad(rows, f, g, n_rows)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with launches.count_captured(side) as rec:
        with torch.cuda.graph(graph, stream=side):
            out = grid.grid_grad(rows, f, g, n_rows)
    assert rec == {"grid_scatter": 1}
    for seed in (13, 14):
        new = _corner_inputs(dims, n, C, seed, device=cuda_device)
        for buf, x in zip(bufs[:3], new[:3]):
            buf.copy_(x)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, grid.grid_grad(*new))
