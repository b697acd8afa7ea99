"""Depth sampling along rays: stratified bins, depth-guided surface
samples (reference src/utils/Renderer.py:112-170), hierarchical
inverse-CDF resampling (src/common.py:19-63) and occupancy-guided
placement of the stratified samples (the JAX package's
`occ_guided_zvals`).

The per-ray "depth hole" case is a `torch.where` select, so batch shapes
never depend on the data.
"""

from __future__ import annotations

from typing import Optional

import torch


def stratified_zvals(near: torch.Tensor, far: torch.Tensor, n: int,
                     lindisp: bool = False) -> torch.Tensor:
    """Evenly spaced z values between per-ray near/far.

    near/far broadcast against (..., 1); returns (..., n)."""
    t = torch.linspace(0.0, 1.0, n, dtype=far.dtype, device=far.device)
    if lindisp:
        return 1.0 / (1.0 / near * (1.0 - t) + 1.0 / far * t)
    return near * (1.0 - t) + far * t


def perturb_zvals(z_vals: torch.Tensor,
                  gen: Optional[torch.Generator] = None,
                  u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stratified jitter within each bin (reference Renderer.py:159-166).

    The uniforms `u` (same shape as z_vals) are drawn from `gen` unless
    passed in."""
    mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
    upper = torch.cat([mids, z_vals[..., -1:]], dim=-1)
    lower = torch.cat([z_vals[..., :1], mids], dim=-1)
    if u is None:
        u = torch.rand(z_vals.shape, generator=gen, dtype=z_vals.dtype,
                       device=z_vals.device)
    return lower + (upper - lower) * u


def surface_zvals(gt_depth: torch.Tensor, n_surface: int,
                  max_depth) -> torch.Tensor:
    """Depth-guided samples: [0.95, 1.05]*d for valid-depth rays, uniform
    [0.001, max_depth] for depth holes (reference Renderer.py:121-150).

    gt_depth: (N,). Returns (N, n_surface)."""
    t = torch.linspace(0.0, 1.0, n_surface, dtype=gt_depth.dtype,
                       device=gt_depth.device)
    d = gt_depth[..., None]
    z_surf = 0.95 * d * (1.0 - t) + 1.05 * d * t
    z_hole = 0.001 * (1.0 - t) + max_depth * t
    return torch.where(d > 0, z_surf, z_hole.expand(z_surf.shape))


def occ_guided_zvals(rays_o, rays_d, near, far, occ_proxy: torch.Tensor,
                     bound: torch.Tensor, n: int, n_probe: int = 32,
                     floor: float = 0.05) -> torch.Tensor:
    """Occupancy-guided stratified sampling (nice_slam_tpu/ops/
    sampling.py:47-84): probe the occupancy proxy at n_probe uniform bin
    centres along each ray, then place the same n samples by deterministic
    inverse-CDF over the floored per-bin occupancy.  Shapes never depend
    on the data: samples are moved, never dropped.

    Measured by the JAX package to degrade depth-supervised SLAM (the
    depth loss needs free-space samples); off by default.

    occ_proxy: (Nx, Ny, Nz, 1) in [0, 1]; no gradient flows into it.
    near/far: (N, 1).  Returns (N, n) sorted z values in [near, far]."""
    from nice_slam_torch.ops.grid import normalize_coords, trilinear_interp

    edges = stratified_zvals(near, far, n_probe + 1)          # (N, P+1)
    mids = 0.5 * (edges[..., 1:] + edges[..., :-1])           # (N, P)
    pts = rays_o[:, None, :] + rays_d[:, None, :] * mids[..., None]
    pn = normalize_coords(pts.reshape(-1, 3), bound)
    w = trilinear_interp(occ_proxy.detach(), pn)[..., 0].reshape(mids.shape)
    w = torch.clamp(w, floor, 1.0)
    # the bins include near and far, so the first and last half probe-bins
    # stay covered (the uniform sampler places samples at near and far)
    bins = torch.cat([near, mids, far], dim=-1)                # (N, P+2)
    w_edge = torch.cat([w[..., :1], 0.5 * (w[..., 1:] + w[..., :-1]),
                        w[..., -1:]], dim=-1)                 # (N, P+1)
    return sample_pdf(bins, w_edge, n, det=True)


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n: int,
               det: bool = False, gen: Optional[torch.Generator] = None,
               u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Hierarchical inverse-CDF sampling (reference src/common.py:19-63).

    bins: (B, M) interval midpoints; weights: (B, M-1) interior weights.
    det=True places the n draws at linspace(0, 1, n); otherwise the
    uniforms `u` (B, n) are drawn from `gen` unless passed in.
    Returns (B, n)."""
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)
    shape = cdf.shape[:-1] + (n,)
    if det:
        u = torch.linspace(0.0, 1.0, n, dtype=cdf.dtype,
                           device=cdf.device).expand(shape)
    elif u is None:
        u = torch.rand(shape, generator=gen, dtype=cdf.dtype,
                       device=cdf.device)
    u = u.contiguous()
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=cdf.shape[-1] - 1)
    cdf_lo = torch.gather(cdf, -1, below)
    cdf_hi = torch.gather(cdf, -1, above)
    bins_lo = torch.gather(bins, -1, below)
    bins_hi = torch.gather(bins, -1, above)
    denom = cdf_hi - cdf_lo
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_lo) / denom
    return bins_lo + t * (bins_hi - bins_lo)
