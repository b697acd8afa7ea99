"""Alpha compositing of raw decoder outputs along rays.

Matches the reference's `raw2outputs_nerf_color` (src/common.py:204-245):
occupancy mode uses alpha = sigmoid(10 * raw); density mode (iMAP*) uses
alpha = 1 - exp(-relu(raw) * dist), the dists scaled by |ray_d| with a
1e10 tail.  Also returns the depth variance ("uncertainty") that the
tracker's robust loss reads.
"""

from __future__ import annotations

import torch


class _CumprodNonzero(torch.autograd.Function):
    """torch.cumprod over the last dim of a tensor without zeros, with the
    derivatives PyTorch takes for such a tensor (`cumprod_backward`: the
    reversed cumulative sum of output * grad, divided by the input;
    `cumprod_jvp`: the cumulative sum of tangent / input, times the
    output), bit for bit, but without the check for zeros that comes
    first there: that check reads a flag from the device, which stalls
    the host and is illegal inside a CUDA-graph capture."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x):
        return torch.cumprod(x, dim=-1)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0], output)
        ctx.save_for_forward(inputs[0], output)

    @staticmethod
    def jvp(ctx, t):
        x, out = ctx.saved_tensors
        return (t / x).cumsum(-1) * out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        if x.numel() <= 1 or x.shape[-1] == 1:
            return g
        return (out * g).flip(-1).cumsum(-1).flip(-1).div(x)


def exclusive_cumprod(x: torch.Tensor) -> torch.Tensor:
    """cumprod shifted right by one with a leading 1 (transmittance).  x
    must hold no zero: `raw2outputs` passes 1 - alpha + 1e-10 with alpha
    in [0, 1]."""
    ones = torch.ones_like(x[..., :1])
    return _CumprodNonzero.apply(torch.cat([ones, x[..., :-1]], dim=-1))


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
