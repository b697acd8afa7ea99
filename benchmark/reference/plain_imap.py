"""Plain PyTorch iMAP*, the reference that decides `correct` for a
configuration with `nice: false`.

A frozen, kernel-free copy of the mathematics that the port's iMAP*
tracking and mapping steps compute (the reference NICE-SLAM's iMAP*
mode: decoder.py's MLP at c_dim 0, Renderer.py, common.py), in the
port's parameter layout {"imap": {"embed": {"B"}, "pts": [{"w", "b"}] x 4,
"out": {"w", "b"}}}: the Fourier embedding sin(p B), four 256-wide ReLU
layers, a linear head giving rgb and density; density compositing; the
first pass at N_samples (+ N_surface) depths, then `sample_pdf` over its
weights at N_importance deterministic draws and the sorted second pass;
the free-space regulation's densities; the tracking loss and
init_select's median.  It imports nothing of the program and runs in
plain float32 with TF32 off, unless a caller asks for TF32 (the
precision control); reference/plain.py gives the poses, rays and Adam.

Where it departs from upstream NICE-SLAM, as the port does:
- `init_decoder`'s head is the port's calibrated one (weights x 0.1, the
  density bias -0.2), not DenseLayer's plain init with a zero bias;
- rendering with `perturb` above 0 (jittered samples, random importance
  draws) is not followed: no configuration of the port sets it, and the
  iMAP* mode (benchmark/modes/imap.py) refuses it.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import plain

EMB = 93
HIDDEN = 256
BLOCKS = 4


# -- parameters ------------------------------------------------------------

def _xavier(gen, n_in, n_out, gain, device):
    a = gain * np.sqrt(6.0 / (n_in + n_out))
    u = torch.rand(n_in, n_out, generator=gen, device=device)
    return u * (2 * a) - a


def init_decoder(seed: int, device) -> dict:
    """The program's initial iMAP* decoder, drawn from tpu.seed in its
    order: B ~ N(0, 25^2) (3, 93); each hidden layer's weights by xavier
    uniform at ReLU's gain, then the head's at gain 1; zero biases; the
    head's weights x 0.1 and its density bias -0.2."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    B = torch.randn(3, EMB, generator=gen, device=device) * 25.0
    pts = [{"w": _xavier(gen, EMB if i == 0 else HIDDEN, HIDDEN,
                         np.sqrt(2.0), device),
            "b": torch.zeros(HIDDEN, device=device)}
           for i in range(BLOCKS)]
    w = _xavier(gen, HIDDEN, 4, 1.0, device)
    b = torch.zeros(4, device=device)
    b[3] = -0.2
    return {"imap": {"embed": {"B": B}, "pts": pts,
                     "out": {"w": w * 0.1, "b": b}}}


# -- the decoder and compositing ---------------------------------------------

def mlp(dec, p):
    """(N, 4) [rgb, density] at points p (N, 3) (decoder.py:91-203 at
    c_dim 0, no skips)."""
    h = torch.sin(p @ dec["embed"]["B"])
    for layer in dec["pts"]:
        h = torch.relu(h @ layer["w"] + layer["b"])
    return h @ dec["out"]["w"] + dec["out"]["b"]


def decode(params, bound, p):
    """raw (N, 4), the density forced to 100 outside the AABB
    (Renderer.py:57)."""
    raw = mlp(params["imap"], p)
    inside = torch.all((p > bound[:, 0]) & (p < bound[:, 1]), dim=-1)
    sigma = torch.where(inside, raw[..., 3], torch.full_like(raw[..., 3],
                                                             100.0))
    return torch.cat([raw[..., :3], sigma[..., None]], -1)


def composite(raw, z, d):
    """Density compositing (common.py:204-245, occupancy off): alpha =
    1 - exp(-relu(sigma) dist), the distances times |d| with a 1e10 tail.
    Returns (depth, variance, colour, weights)."""
    dists = z[..., 1:] - z[..., :-1]
    dists = torch.cat([dists, torch.full_like(dists[..., :1], 1e10)], -1)
    dists = dists * torch.linalg.norm(d, dim=-1, keepdim=True)
    alpha = 1.0 - torch.exp(-torch.relu(raw[..., 3]) * dists)
    trans = torch.cumprod(torch.cat(
        [torch.ones_like(alpha[..., :1]), 1.0 - alpha[..., :-1] + 1e-10],
        -1), -1)
    w = alpha * trans
    depth = torch.sum(w * z, -1)
    var = torch.sum(w * (z - depth[..., None]) ** 2, -1)
    return depth, var, torch.sum(w[..., None] * raw[..., :3], -2), w


def sample_pdf(bins, weights, n):
    """Inverse-CDF sampling at n deterministic draws linspace(0, 1, n)
    (common.py:19-63, det): bins (B, M) interval midpoints, weights (B,
    M - 1)."""
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, -1, keepdim=True)
    cdf = torch.cumsum(pdf, -1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1)
    u = torch.linspace(0.0, 1.0, n, dtype=cdf.dtype,
                       device=cdf.device).expand(cdf.shape[:-1] + (n,))
    u = u.contiguous()
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=cdf.shape[-1] - 1)
    cdf_lo, cdf_hi = torch.gather(cdf, -1, below), torch.gather(cdf, -1,
                                                                above)
    b_lo, b_hi = torch.gather(bins, -1, below), torch.gather(bins, -1, above)
    denom = cdf_hi - cdf_lo
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    return b_lo + (u - cdf_lo) / denom * (b_hi - b_lo)


def render(params, bound, o, d, gt_depth, render_args):
    """(depth, variance, colour) of rays (Renderer.py:88-196): the first
    pass at the stratified (and surface) depths, then N_importance depths
    drawn from its weights, and the second pass over both, sorted.  The
    depths span the batch's deepest pixel."""
    n_samples, n_surface = render_args["samples"]
    n_imp = render_args["importance"]
    max_d = torch.max(gt_depth)
    z = plain.z_values(o, d, gt_depth, max_d, bound, n_samples, n_surface)

    def one_pass(z):
        pts = o[:, None, :] + d[:, None, :] * z[..., None]
        raw = decode(params, bound, pts.reshape(-1, 3)).reshape(
            z.shape + (4,))
        return composite(raw, z, d)

    out = one_pass(z)
    if n_imp > 0:
        z_mid = 0.5 * (z[..., 1:] + z[..., :-1])
        z_imp = sample_pdf(z_mid, out[3][..., 1:-1], n_imp).detach()
        z, _ = torch.sort(torch.cat([z, z_imp], -1), -1)
        out = one_pass(z)
    return out[:3]


def regulation_sigma(params, bound, o, d, gt_depth, n_samples, gen):
    """The densities at n_samples jittered depths on [0, 0.85 x depth] of
    each ray (Renderer.py:258-296): (N * n_samples,).  The jitter's
    uniforms are drawn from `gen` in float32, as the program draws them."""
    dd = gt_depth[:, None]
    t = torch.linspace(0.0, 1.0, n_samples, dtype=dd.dtype, device=dd.device)
    z = torch.zeros_like(dd) * (1.0 - t) + dd * 0.85 * t
    mids = 0.5 * (z[..., 1:] + z[..., :-1])
    upper = torch.cat([mids, z[..., -1:]], -1)
    lower = torch.cat([z[..., :1], mids], -1)
    u = torch.rand(z.shape, generator=gen, device=gen.device).to(z.dtype)
    z = lower + (upper - lower) * u
    pts = o[:, None, :] + d[:, None, :] * z[..., None]
    return decode(params, bound, pts.reshape(-1, 3))[:, 3]


# -- losses ------------------------------------------------------------------

def tracking_loss(cam, params, grids, bound, color, depth, pix, cfg,
                  render_args):
    """Tracker.py:71-128 in iMAP* mode: the depth residual over
    sqrt(variance), no AABB prefilter, pixels beyond 10x its median
    dropped under handle_dynamic, plus w_color_loss x the L1 colour
    residual.  `grids` is unused (iMAP* has none)."""
    c2w = plain.cam_to_c2w(cam)
    i, j = pix
    o, d = plain.rays(i, j, c2w, render_args["cam"])
    bd = depth[j.long(), i.long()]
    bc = color[j.long(), i.long()]
    dep, var, col = render(params, bound, o, d, bd, render_args)
    tmp = torch.abs(bd - dep) / torch.sqrt(var.detach() + 1e-10)
    t = cfg["tracking"]
    if t["handle_dynamic"]:
        med = plain.lower_median(tmp.detach(), torch.ones_like(bd,
                                                               dtype=bool))
        mask = (tmp < 10.0 * med) & (bd > 0)
    else:
        mask = bd > 0
    loss = torch.sum(tmp * mask)
    if t["use_color_in_tracking"]:
        loss = loss + t["w_color_loss"] * torch.sum(
            torch.abs(bc - col) * mask[:, None])
    return loss


def depth_median(c2w, params, grids, bound, depth, pix, render_args):
    """init_select's signal: the median absolute depth residual of a
    candidate pose over the valid pixels."""
    i, j = pix
    o, d = plain.rays(i, j, c2w, render_args["cam"])
    bd = depth[j.long(), i.long()]
    dep, _, _ = render(params, bound, o, d, bd, render_args)
    return plain.lower_median(torch.abs(bd - dep), bd > 0)
