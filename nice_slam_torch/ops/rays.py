"""Ray generation and pixel sampling.

Camera convention matches the reference (x right, y up, -z forward):
``dir = [(i-cx)/fx, -(j-cy)/fy, -1]`` rotated by the c2w rotation
(reference src/common.py:74-89, 248-266).  Random pixel draws come from an
explicit `torch.Generator`, or are passed in as tensors, so tests can feed
both packages the same draws.
"""

from __future__ import annotations

import torch


def ray_dirs(i: torch.Tensor, j: torch.Tensor, fx, fy, cx, cy) -> torch.Tensor:
    """Camera-frame ray directions for pixel coords i (x/col), j (y/row)."""
    return torch.stack([(i - cx) / fx, -(j - cy) / fy, -torch.ones_like(i)],
                       dim=-1)


def rays_from_uv(i, j, c2w, fx, fy, cx, cy):
    """World-space rays for pixel coords. c2w is (3|4, 4).

    Returns (rays_o (N,3), rays_d (N,3))."""
    dirs = ray_dirs(i, j, fx, fy, cx, cy)
    # world_dir[k] = sum_m R[k, m] * dir[m], as an elementwise fp32 sum:
    # pose geometry must not depend on the matmul precision setting
    rays_d = torch.sum(dirs[..., None, :] * c2w[:3, :3], dim=-1)
    rays_o = c2w[:3, 3].expand(rays_d.shape)
    return rays_o, rays_d


def image_rays(H: int, W: int, fx, fy, cx, cy, c2w):
    """Rays for every pixel of an HxW image. Returns ((H,W,3), (H,W,3))."""
    j, i = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=c2w.device),
        torch.arange(W, dtype=torch.float32, device=c2w.device),
        indexing="ij")
    return rays_from_uv(i, j, c2w, fx, fy, cx, cy)


def sample_pixels(gen: torch.Generator, n: int, H0: int, H1: int, W0: int,
                  W1: int):
    """Sample n pixel coords uniformly (with replacement) from rows
    [H0, H1) x cols [W0, W1), on the generator's device.  Returns float
    (i, j) = (x, y)."""
    dev = gen.device
    i = torch.randint(W0, W1, (n,), generator=gen, device=dev)
    j = torch.randint(H0, H1, (n,), generator=gen, device=dev)
    return i.to(torch.float32), j.to(torch.float32)


def gather_pixels(img: torch.Tensor, i: torch.Tensor, j: torch.Tensor):
    """Values at integer pixel coords (i=x/col, j=y/row); img (H, W[, C])."""
    return img[j.long(), i.long()]


def ray_aabb_far(rays_o: torch.Tensor, rays_d: torch.Tensor,
                 bound: torch.Tensor):
    """Distance along each ray to its exit from the scene AABB (3, 2):
    min over axes of max over the two faces (reference
    src/utils/Renderer.py:98-105).  Returns (N,)."""
    d = torch.where(torch.abs(rays_d) < 1e-10,
                    torch.full_like(rays_d, 1e-10), rays_d)
    t = (bound[None, :, :] - rays_o[..., None]) / d[..., None]
    return torch.amin(torch.amax(t, dim=2), dim=1)
