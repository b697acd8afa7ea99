"""Feature-grid trilinear interpolation.

Grids are stored `[Nx, Ny, Nz, C]` with channels last, the JAX package's
layout.  Interpolation is an 8-corner gather + lerp with align_corners=True
and border clamping, which is `F.grid_sample(..., padding_mode='border',
align_corners=True)` (reference src/common.py:269-284,
src/conv_onet/models/decoder.py:168-175).

`trilinear_interp` is a `torch.autograd.Function`: the forward gathers the
8 corner rows, the backward scatters the 8 weighted cotangent rows into
the grid (`scatter_rows`) and takes the gradient with respect to the
points from the fp32 corners.  On the H100 both run as PyTorch's own
gather/sort/segment sum; the JAX package also leaves them to XLA (no
Pallas).
"""

from __future__ import annotations

import torch

from nice_slam_torch.ops.consts import const


def normalize_coords(p: torch.Tensor, bound: torch.Tensor) -> torch.Tensor:
    """World coords (..., 3) -> [-1, 1]^3 w.r.t. AABB `bound` (3, 2)."""
    lo = bound[:, 0]
    hi = bound[:, 1]
    return (p - lo) / (hi - lo) * 2.0 - 1.0


def _sizes(shape, like: torch.Tensor) -> torch.Tensor:
    return const(shape, like.dtype, like.device)


def grid_coords(p_nor: torch.Tensor, shape) -> torch.Tensor:
    """[-1,1] coords -> continuous voxel coords with align_corners=True,
    clamped to the valid range (border padding)."""
    sizes = _sizes(shape, p_nor)
    u = (p_nor + 1.0) * 0.5 * (sizes - 1.0)
    return torch.minimum(torch.clamp(u, min=0.0), sizes - 1.0)


def _cell(grid_shape, p_nor: torch.Tensor):
    """Lower corner index i0 (clipped to n-2, or 0 for a side under 2),
    upper corner i1, fractional offsets f, and the d(u)/d(p_nor) factor
    (zero where the border clamp is active)."""
    nx, ny, nz, _ = grid_shape
    shape = (nx, ny, nz)
    sizes = _sizes(shape, p_nor)
    u_raw = (p_nor + 1.0) * 0.5 * (sizes - 1.0)
    u = torch.minimum(torch.clamp(u_raw, min=0.0), sizes - 1.0)
    hi0 = const([max(n - 2, 0) for n in shape], torch.int64, p_nor.device)
    i0 = torch.minimum(torch.clamp(torch.floor(u).long(), min=0), hi0)
    f = u - i0.to(u.dtype)
    i1 = torch.minimum(i0 + 1, const([n - 1 for n in shape], torch.int64,
                                     p_nor.device))
    inside = (u_raw >= 0.0) & (u_raw <= sizes - 1.0)
    du = torch.where(inside, 0.5 * (sizes - 1.0), torch.zeros_like(u))
    return i0, i1, f, du


def _corner_rows(grid_shape, i0, i1):
    """Flat row index of the 8 corners, x-major (a, b, c) order: (8, N)."""
    _, ny, nz, _ = grid_shape
    xs = (i0[:, 0], i1[:, 0])
    ys = (i0[:, 1], i1[:, 1])
    zs = (i0[:, 2], i1[:, 2])
    return torch.stack([(xs[a] * ny + ys[b]) * nz + zs[c]
                        for a in (0, 1) for b in (0, 1) for c in (0, 1)])


def scatter_rows(rows: torch.Tensor, vals: torch.Tensor, n_rows: int,
                 block: int = 64) -> torch.Tensor:
    """(n_rows, C) sums of the rows of vals (M, C) by their target row
    (M,), in a fixed order, so the result repeats bit for bit on every
    device (`index_add_` sums with atomics on CUDA, in an order that
    changes from run to run).  The targets are sorted stably; each row's
    run is summed in pieces of at most `block` entries in their original
    order, then the pieces in order.  Rows near the surface take thousands
    of entries, and one sequential sum over a whole run made the segment
    sum the slowest kernel of the mapping step."""
    m = rows.shape[0]
    dev = rows.device
    sorted_rows, perm = torch.sort(rows, stable=True)
    starts = torch.searchsorted(sorted_rows,
                                torch.arange(n_rows + 1, device=dev))
    # piece boundaries: every row start and every block-th entry
    bounds, _ = torch.sort(torch.cat(
        [starts[:-1], torch.arange(0, m, block, device=dev)]))
    pieces = torch.segment_reduce(
        vals[perm], "sum", offsets=torch.cat([bounds, starts[-1:]]), axis=0)
    # row r's pieces start at the first bound equal to its start (empty
    # pieces between equal bounds add zero wherever they fall)
    first = torch.searchsorted(bounds, starts[:-1])
    n_pieces = torch.full((1,), bounds.shape[0], device=dev)
    return torch.segment_reduce(pieces, "sum",
                                offsets=torch.cat([first, n_pieces]), axis=0)


class _TrilinearInterp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, grid: torch.Tensor, p_nor: torch.Tensor, shape,
                x_offset: int, own=None):
        nx, ny, nz, C = grid.shape
        i0, i1, f, du = _cell(shape, p_nor)
        if x_offset:
            shift = const([x_offset, 0, 0], torch.int64, i0.device)
            i0, i1 = i0 - shift, i1 - shift
        rows = _corner_rows(grid.shape, i0, i1)
        extra = ()
        if own is not None:
            # the points that `own` leaves out read row 0 and give 0;
            # their cotangent rows go to a sink row past the grid
            extra = (torch.where(own, rows, nx * ny * nz), own)
            rows = torch.where(own, rows, 0)
        flat = grid.reshape(nx * ny * nz, C)
        c = flat[rows.reshape(-1)].reshape(8, -1, C)
        fx, fy, fz = f[:, 0:1], f[:, 1:2], f[:, 2:3]
        c00 = c[0] * (1 - fz) + c[1] * fz
        c01 = c[2] * (1 - fz) + c[3] * fz
        c10 = c[4] * (1 - fz) + c[5] * fz
        c11 = c[6] * (1 - fz) + c[7] * fz
        c0 = c00 * (1 - fy) + c01 * fy
        c1 = c10 * (1 - fy) + c11 * fy
        out = c0 * (1 - fx) + c1 * fx
        if own is not None:
            out = torch.where(own[:, None], out, 0.0)
        ctx.save_for_backward(grid, rows, f, du, *extra)
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        grid, rows, f, du, *extra = ctx.saved_tensors
        nx, ny, nz, C = grid.shape
        fx, fy, fz = f[:, 0:1], f[:, 1:2], f[:, 2:3]
        d_grid = d_p = None
        if ctx.needs_input_grad[0]:
            wx = (1 - fx, fx)
            wy = (1 - fy, fy)
            wz = (1 - fz, fz)
            vals = torch.stack([g * (wx[a] * wy[b] * wz[cc])
                                for a in (0, 1) for b in (0, 1)
                                for cc in (0, 1)])
            n = nx * ny * nz
            if extra:
                # the sink row sorts last, so the grid's rows are summed
                # in the same pieces as without the left-out points
                d_grid = scatter_rows(extra[0].reshape(-1),
                                      vals.reshape(-1, C), n + 1)[:n]
            else:
                d_grid = scatter_rows(rows.reshape(-1), vals.reshape(-1, C),
                                      n)
            d_grid = d_grid.reshape(nx, ny, nz, C)
        if ctx.needs_input_grad[1]:
            flat = grid.reshape(nx * ny * nz, C)
            c = flat[rows.reshape(-1)].reshape(8, -1, C)
            c00 = c[0] * (1 - fz) + c[1] * fz
            c01 = c[2] * (1 - fz) + c[3] * fz
            c10 = c[4] * (1 - fz) + c[5] * fz
            c11 = c[6] * (1 - fz) + c[7] * fz
            c0 = c00 * (1 - fy) + c01 * fy
            c1 = c10 * (1 - fy) + c11 * fy
            d_fx = c1 - c0
            d_fy = (1 - fx) * (c01 - c00) + fx * (c11 - c10)
            d_fz = ((1 - fx) * ((1 - fy) * (c[1] - c[0])
                                + fy * (c[3] - c[2]))
                    + fx * ((1 - fy) * (c[5] - c[4])
                            + fy * (c[7] - c[6])))
            d_f = torch.stack([torch.sum(g * d_fx, dim=-1),
                               torch.sum(g * d_fy, dim=-1),
                               torch.sum(g * d_fz, dim=-1)], dim=-1)
            d_p = d_f * du
            if extra:
                d_p = torch.where(extra[1][:, None], d_p, 0.0)
        return d_grid, d_p, None, None, None


def trilinear_interp(grid: torch.Tensor, p_nor: torch.Tensor) -> torch.Tensor:
    """Trilinearly interpolate `grid` [Nx, Ny, Nz, C] at p_nor (N, 3) in
    [-1, 1]^3 (x, y, z order).  Returns (N, C).  Differentiable with
    respect to both the grid and the points."""
    return _TrilinearInterp.apply(grid, p_nor, tuple(grid.shape), 0)


def slab_trilinear(slab: torch.Tensor, p_nor: torch.Tensor, global_shape,
                   x_offset: int, own=None) -> torch.Tensor:
    """`trilinear_interp` of the global grid of shape `global_shape`
    (Nx, Ny, Nz) at p_nor, read from `slab`, its rows [x_offset,
    x_offset + slab.shape[0]) (parallel/grid_sharded.py).  Every point's
    base cell and the row after it must lie in the slab, or the point be
    left out by `own` (N,) bool: its row is 0 and it adds nothing to the
    slab's gradient or its own.  The cell, the corner order and the lerps
    are the dense function's, so each row equals the dense interpolation
    bit for bit."""
    return _TrilinearInterp.apply(
        slab, p_nor, tuple(global_shape) + (slab.shape[-1],), x_offset,
        own)


def grid_shape_for_bound(bound, voxel_len: float, enlarge: int = 1):
    """Voxel counts [Nx, Ny, Nz] for an AABB, reference grid sizing
    (src/NICE_SLAM.py:216-248): int(xyz_len * enlarge / voxel_len)."""
    import numpy as np

    b = np.asarray(bound)
    xyz_len = b[:, 1] - b[:, 0]
    return [int(v) for v in (xyz_len * enlarge / voxel_len)]
