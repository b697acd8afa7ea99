"""Differentiable volume renderer (src/utils/Renderer.py), as in the JAX
package:

- per-ray near/far: near = 0.01 * sensor depth, far = ray/AABB exit + 0.01
  clamped to 1.2 * max depth (Renderer.py:88-111);
- N_samples stratified bins + N_surface depth-guided samples, with the
  depth-hole uniform fallback as a per-ray `where` (Renderer.py:112-150);
- merge by sort, decode all points in one batch, alpha-composite;
- optional N_importance inverse-CDF refinement (Renderer.py:181-196);
- optional occupancy-guided placement of the stratified samples
  (`RenderSpec.occ_guided`, the grid `occ_proxy`; the JAX package's
  render.py:85-92), for every stage but coarse.

Out-of-bound points get occupancy forced to +100 (an opaque wall at the
AABB, Renderer.py:57), in iMAP* mode too.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from nice_slam_torch.models.decoders import ModelSpec, model_apply
from nice_slam_torch.ops.composite import raw2outputs
from nice_slam_torch.ops.rays import image_rays, ray_aabb_far
from nice_slam_torch.ops.sampling import (
    occ_guided_zvals,
    perturb_zvals,
    sample_pdf,
    stratified_zvals,
    surface_zvals,
)


@dataclass(frozen=True)
class RenderSpec:
    n_samples: int = 32
    n_surface: int = 16
    n_importance: int = 0
    lindisp: bool = False
    perturb: float = 0.0
    occupancy: bool = True
    # occupancy-guided stratified sampling (ops/sampling.occ_guided_zvals):
    # the same n_samples, moved to where grids["occ_proxy"] is high
    occ_guided: bool = False
    # False: no decoder weight gradient is wanted (tracking, and mapping
    # stages whose decoders are frozen); the fused decode skips that work
    train_decoders: bool = True


def eval_points(params, mspec: ModelSpec, grids, bound, p: torch.Tensor,
                stage: str, train_decoders: bool = True) -> torch.Tensor:
    """Decode raw (N, 4) predictions; occupancy forced to 100 outside the
    AABB (reference Renderer.py:38-61)."""
    raw = model_apply(params, mspec, grids, bound, p, stage,
                      train_decoders=train_decoders)
    inside = torch.all((p > bound[:, 0]) & (p < bound[:, 1]), dim=-1)
    occ = torch.where(inside, raw[..., 3], torch.full_like(raw[..., 3], 100.0))
    return torch.cat([raw[..., :3], occ[..., None]], dim=-1)


def _zvals(rays_o, rays_d, gt_depth, bound, rspec: RenderSpec,
           with_depth: bool, gen: Optional[torch.Generator] = None,
           occ_proxy=None, max_depth=None):
    """Sample depths along each ray.  Returns (N, S) sorted z values.
    max_depth: the sensor depth that caps far and spans the depth-hole
    samples, a scalar or (N, 1) (default the batch's max)."""
    far_bb = ray_aabb_far(rays_o.detach(), rays_d.detach(),
                          bound)[:, None] + 0.01
    if with_depth:
        d = gt_depth[:, None]
        near = d * 0.01
        max_d = torch.max(gt_depth) if max_depth is None else max_depth
        far = torch.minimum(torch.clamp(far_bb, min=0.0), max_d * 1.2)
    else:
        near = torch.full_like(far_bb, 0.01)
        far = far_bb
    if occ_proxy is not None:
        if rspec.lindisp:
            raise ValueError(
                "occ_guided sampling builds linear-in-depth probe bins and "
                "does not support lindisp=True; set occupancy_guided=False "
                "or lindisp=False")
        z_vals = occ_guided_zvals(rays_o, rays_d, near, far, occ_proxy,
                                  bound, rspec.n_samples)
    else:
        z_vals = stratified_zvals(near, far, rspec.n_samples, rspec.lindisp)
    if rspec.perturb > 0.0:
        z_vals = perturb_zvals(z_vals, gen)
    if with_depth and rspec.n_surface > 0:
        z_surf = surface_zvals(gt_depth, rspec.n_surface, max_d)
        z_vals, _ = torch.sort(torch.cat([z_vals, z_surf], dim=-1), dim=-1)
    return z_vals


def render_rays(params, mspec: ModelSpec, grids, bound,
                rays_o: torch.Tensor, rays_d: torch.Tensor,
                rspec: RenderSpec, stage: str,
                gt_depth: Optional[torch.Tensor] = None,
                gen: Optional[torch.Generator] = None, max_depth=None,
                decode_fn=None):
    """Render a batch of rays.

    gt_depth=None (e.g. the coarse mapper) disables surface sampling and
    uses scalar near (reference Renderer.py:88-92).  `gen` feeds the
    stratified jitter when rspec.perturb > 0, and the importance draws
    (det when perturb == 0).  max_depth (scalar or (N, 1)) replaces the
    batch's max sensor depth, so rays of several frames render in one
    batch as each frame's alone would (parallel/schur_ba.py).

    decode_fn: (M, 3) points -> raw (M, 4) in place of `eval_points`,
    with the out-of-AABB occupancy forcing (the grid-sharded decode,
    parallel/grid_sharded.py; JAX render.py:104-123).  The occupancy
    proxy is read only from a dict of grids, as in JAX (render.py:130-132):
    with `grids` None the samples are unguided.

    Returns (depth (N,), uncertainty (N,), color (N, 3), weights (N, S))."""
    if decode_fn is None:
        def decode_fn(pp):
            return eval_points(params, mspec, grids, bound, pp, stage,
                               train_decoders=rspec.train_decoders)

    with_depth = gt_depth is not None and stage != "coarse"
    occ_proxy = (grids.get("occ_proxy")
                 if (rspec.occ_guided and stage != "coarse"
                     and isinstance(grids, dict)) else None)
    z_vals = _zvals(rays_o, rays_d, gt_depth if with_depth else None, bound,
                    rspec, with_depth, gen, occ_proxy, max_depth)
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
    n, s, _ = pts.shape
    raw = decode_fn(pts.reshape(-1, 3))
    out = raw2outputs(raw.reshape(n, s, 4), z_vals, rays_d, rspec.occupancy)
    if rspec.n_importance > 0:
        weights = out[3]
        z_mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        z_imp = sample_pdf(z_mid, weights[..., 1:-1], rspec.n_importance,
                           det=rspec.perturb == 0.0, gen=gen).detach()
        z_vals, _ = torch.sort(torch.cat([z_vals, z_imp], dim=-1), dim=-1)
        pts = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
        raw = decode_fn(pts.reshape(-1, 3))
        out = raw2outputs(raw.reshape(n, s + rspec.n_importance, 4), z_vals,
                          rays_d, rspec.occupancy)
    return out


def regulation_sigma(params, mspec: ModelSpec, grids, bound, rays_o, rays_d,
                     gt_depth, n_samples: int, stage: str = "color",
                     gen: Optional[torch.Generator] = None, u=None):
    """iMAP* free-space regulation: the density at n_samples stratified
    points on [0, 0.85 * depth] with jitter (reference Renderer.py:258-296).
    The jitter's uniforms `u` (N, n_samples) come from `gen` unless passed
    in.  Returns (N * n_samples,)."""
    d = gt_depth[:, None]
    z_vals = stratified_zvals(torch.zeros_like(d), d * 0.85, n_samples)
    z_vals = perturb_zvals(z_vals, gen, u)
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
    raw = eval_points(params, mspec, grids, bound, pts.reshape(-1, 3), stage)
    return raw[:, 3]


@torch.no_grad()
def render_image(params, mspec: ModelSpec, grids, bound, c2w, camera,
                 rspec: RenderSpec, stage: str = "color", gt_depth=None,
                 chunk: int = 16384, decode_fn=None):
    """Full-image rendering in fixed-size chunks of rays (reference
    Renderer.py:200-255).  `camera` carries (H, W, fx, fy, cx, cy);
    decode_fn as in `render_rays` (the grid-sharded panels).  No
    generator: with rspec.perturb 0 the render draws nothing.
    Returns (depth (H, W), uncertainty (H, W), color (H, W, 3))."""
    H, W = camera.H, camera.W
    rays_o, rays_d = image_rays(H, W, camera.fx, camera.fy, camera.cx,
                                camera.cy, c2w)
    rays_o = rays_o.reshape(-1, 3)
    rays_d = rays_d.reshape(-1, 3)
    gt = gt_depth.reshape(-1) if gt_depth is not None else None
    depth, var, color = [], [], []
    for s in range(0, H * W, chunk):
        d, v, c, _ = render_rays(
            params, mspec, grids, bound, rays_o[s:s + chunk],
            rays_d[s:s + chunk], rspec, stage,
            gt_depth=gt[s:s + chunk] if gt is not None else None,
            decode_fn=decode_fn)
        depth.append(d)
        var.append(v)
        color.append(c)
    return (torch.cat(depth).reshape(H, W), torch.cat(var).reshape(H, W),
            torch.cat(color).reshape(H, W, 3))
