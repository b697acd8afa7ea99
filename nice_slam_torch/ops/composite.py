"""Alpha compositing of raw decoder outputs along rays.

Matches the reference's `raw2outputs_nerf_color` (src/common.py:204-245):
occupancy mode uses alpha = sigmoid(10 * raw); density mode (iMAP*) uses
alpha = 1 - exp(-relu(raw) * dist), the dists scaled by |ray_d| with a
1e10 tail.  Also returns the depth variance ("uncertainty") that the
tracker's robust loss reads.
"""

from __future__ import annotations

import torch


def exclusive_cumprod(x: torch.Tensor) -> torch.Tensor:
    """cumprod shifted right by one with a leading 1 (transmittance)."""
    ones = torch.ones_like(x[..., :1])
    return torch.cumprod(torch.cat([ones, x[..., :-1]], dim=-1), dim=-1)


def raw2outputs(raw: torch.Tensor, z_vals: torch.Tensor,
                rays_d: torch.Tensor, occupancy: bool = True):
    """Composite raw (N, S, 4) predictions into per-ray outputs.

    Returns (depth (N,), depth_var (N,), rgb (N,3), weights (N,S))."""
    rgb = raw[..., :3]
    if occupancy:
        alpha = torch.sigmoid(10.0 * raw[..., 3])
    else:
        dists = z_vals[..., 1:] - z_vals[..., :-1]
        dists = torch.cat([dists, torch.full_like(dists[..., :1], 1e10)],
                          dim=-1)
        dists = dists * torch.linalg.norm(rays_d, dim=-1, keepdim=True)
        alpha = 1.0 - torch.exp(-torch.relu(raw[..., 3]) * dists)
    weights = alpha * exclusive_cumprod(1.0 - alpha + 1e-10)
    rgb_map = torch.sum(weights[..., None] * rgb, dim=-2)
    depth = torch.sum(weights * z_vals, dim=-1)
    resid = z_vals - depth[..., None]
    depth_var = torch.sum(weights * resid * resid, dim=-1)
    return depth, depth_var, rgb_map, weights
