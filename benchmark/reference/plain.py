"""Plain PyTorch NICE-SLAM, the reference that decides `correct`.

A frozen, kernel-free copy of the mathematics that the port's tracking
and mapping steps compute (the reference NICE-SLAM's Tracker.py,
Mapper.py, Renderer.py and decoder.py, in the port's parameter layout):
pixel draws, rays, depth samples, trilinear grid features, the NICE
decoders with their Fourier embedding, occupancy compositing, the
tracking and mapping losses, keyframe selection, frustum masks and Adam.
It imports nothing of the program and runs in plain float32 with TF32
off, unless a caller asks for TF32 (the precision control).
"""

from __future__ import annotations

import numpy as np
import torch

EMB = 93


# -- parameters ------------------------------------------------------------

def load_decoders(path: str, device) -> dict:
    """The decoders of the repository's npz ('params/<decoder>/...'
    keys) as nested dicts and lists of float32 tensors."""
    with np.load(path) as z:
        flat = {k: np.asarray(z[k], np.float32) for k in z.files}
    tree: dict = {}
    for key, arr in flat.items():
        parts = key.split("/")[1:]
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = torch.as_tensor(arr, device=device)
    return listify(tree)


def listify(node):
    """Dicts whose keys are 0..n-1 become lists (the layer lists)."""
    if not isinstance(node, dict):
        return node
    out = {k: listify(v) for k, v in node.items()}
    if out and all(k.isdigit() for k in out):
        return [out[str(i)] for i in range(len(out))]
    return out


def flatten(tree, prefix=""):
    """{'a/b/0/w': tensor} of a nested dict/list tree."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flatten(tree[k], f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(flatten(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tree}


def pad_bound(bound, divisible: float) -> np.ndarray:
    """Each side's upper end moved out to a whole number of `divisible`
    steps, one more than fits (src/NICE_SLAM.py:147-150)."""
    b = np.array(bound, dtype=np.float64)
    b[:, 1] = (((b[:, 1] - b[:, 0]) / divisible).astype(int) + 1) \
        * divisible + b[:, 0]
    return b


def grid_shape(bound: np.ndarray, voxel: float, enlarge: int = 1):
    return [int(v) for v in (bound[:, 1] - bound[:, 0]) * enlarge / voxel]


# -- poses -----------------------------------------------------------------

def quat_to_rot(q):
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    s = 2.0 / torch.sum(q * q, dim=-1)
    rows = [torch.stack([1 - s * (y * y + z * z), s * (x * y - z * w),
                         s * (x * z + y * w)], -1),
            torch.stack([s * (x * y + z * w), 1 - s * (x * x + z * z),
                         s * (y * z - x * w)], -1),
            torch.stack([s * (x * z - y * w), s * (y * z + x * w),
                         1 - s * (x * x + y * y)], -1)]
    return torch.stack(rows, dim=-2)


def rot_to_quat(R):
    """Rotation (..., 3, 3) -> unit quaternion [w x y z], w >= 0, by the
    largest of the four pivots (Shepperd)."""
    r = [[R[..., i, j] for j in range(3)] for i in range(3)]
    tr = r[0][0] + r[1][1] + r[2][2]
    p = torch.stack([1.0 + tr, 1.0 + r[0][0] - r[1][1] - r[2][2],
                     1.0 - r[0][0] + r[1][1] - r[2][2],
                     1.0 - r[0][0] - r[1][1] + r[2][2]], dim=-1)
    p = torch.clamp(p, min=1e-12)
    s = torch.sqrt(p)
    c = [torch.stack([p[..., 0], r[2][1] - r[1][2], r[0][2] - r[2][0],
                      r[1][0] - r[0][1]], -1) / s[..., 0:1],
         torch.stack([r[2][1] - r[1][2], p[..., 1], r[0][1] + r[1][0],
                      r[0][2] + r[2][0]], -1) / s[..., 1:2],
         torch.stack([r[0][2] - r[2][0], r[0][1] + r[1][0], p[..., 2],
                      r[1][2] + r[2][1]], -1) / s[..., 2:3],
         torch.stack([r[1][0] - r[0][1], r[0][2] + r[2][0],
                      r[1][2] + r[2][1], p[..., 3]], -1) / s[..., 3:4]]
    cands = torch.stack(c, dim=-2) * 0.5
    case = torch.argmax(p, dim=-1)
    q = torch.gather(cands, -2, case[..., None, None].expand(
        *case.shape, 1, 4))[..., 0, :]
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    return torch.where(q[..., 0:1] < 0, -q, q)


def cam_to_c2w(t):
    """7-vector [q, t] -> (..., 3, 4)."""
    return torch.cat([quat_to_rot(t[..., :4]), t[..., 4:7][..., :, None]],
                     dim=-1)


def c2w_to_cam(c2w):
    return torch.cat([rot_to_quat(c2w[..., :3, :3]), c2w[..., :3, 3]], -1)


def homogeneous(c2w34):
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=c2w34.dtype,
                          device=c2w34.device).expand(
        *c2w34.shape[:-2], 1, 4)
    return torch.cat([c2w34, bottom], dim=-2)


def se3_inverse(c2w):
    R, t = c2w[..., :3, :3], c2w[..., :3, 3]
    Rt = R.transpose(-1, -2)
    ti = -(Rt @ t[..., None])[..., 0]
    top = torch.cat([Rt, ti[..., None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=c2w.dtype,
                          device=c2w.device).expand(top.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


# -- rays and samples ------------------------------------------------------

def draw_pixels(gen, n, h0, h1, w0, w1, shape=None):
    """n pixel coordinates (x, y) drawn as the program draws them: x
    first, then y, each uniform over its range."""
    size = (n,) if shape is None else shape
    i = torch.randint(w0, w1, size, generator=gen, device=gen.device)
    j = torch.randint(h0, h1, size, generator=gen, device=gen.device)
    return i.to(torch.float32), j.to(torch.float32)


def rays(i, j, c2w, cam):
    dirs = torch.stack([(i - cam["cx"]) / cam["fx"],
                        -(j - cam["cy"]) / cam["fy"], -torch.ones_like(i)],
                       -1)
    d = torch.sum(dirs[..., None, :] * c2w[..., :3, :3], dim=-1)
    return c2w[..., :3, 3].expand(d.shape), d


def aabb_exit(o, d, bound):
    dd = torch.where(torch.abs(d) < 1e-10, torch.full_like(d, 1e-10), d)
    t = (bound[None, :, :] - o[..., None]) / dd[..., None]
    return torch.amin(torch.amax(t, dim=2), dim=1)


def z_values(o, d, gt_depth, max_d, bound, n_samples, n_surface):
    """n_samples stratified samples between 0.01 depth and the AABB exit
    (capped at 1.2 x the batch's deepest pixel `max_d`) plus n_surface
    samples on [0.95, 1.05] x depth (uniform to the deepest pixel for a
    hole), sorted (Renderer.py:88-150)."""
    far_bb = aabb_exit(o.detach(), d.detach(), bound)[:, None] + 0.01
    dcol = gt_depth[:, None]
    far = torch.minimum(torch.clamp(far_bb, min=0.0), max_d * 1.2)
    near = dcol * 0.01
    t = torch.linspace(0.0, 1.0, n_samples, dtype=far.dtype,
                       device=far.device)
    z = near * (1.0 - t) + far * t
    if n_surface > 0:
        ts = torch.linspace(0.0, 1.0, n_surface, dtype=far.dtype,
                            device=far.device)
        zs = torch.where(dcol > 0, 0.95 * dcol * (1.0 - ts)
                         + 1.05 * dcol * ts,
                         (0.001 * (1.0 - ts) + max_d * ts).expand(
                             dcol.shape[0], n_surface))
        z, _ = torch.sort(torch.cat([z, zs], -1), -1)
    return z


# -- grids and decoders ----------------------------------------------------

def trilinear(grid, p_nor):
    """grid (Nx, Ny, Nz, C) at points in [-1, 1]^3, align_corners and
    border clamping (F.grid_sample's 'border', align_corners=True)."""
    nx, ny, nz, C = grid.shape
    sizes = torch.tensor([nx, ny, nz], dtype=p_nor.dtype,
                         device=p_nor.device)
    u = (p_nor + 1.0) * 0.5 * (sizes - 1.0)
    u = torch.minimum(torch.clamp(u, min=0.0), sizes - 1.0)
    hi0 = torch.tensor([max(n - 2, 0) for n in (nx, ny, nz)],
                       device=p_nor.device)
    i0 = torch.minimum(torch.clamp(torch.floor(u).long(), min=0), hi0)
    f = u - i0.to(u.dtype)
    i1 = torch.minimum(i0 + 1, torch.tensor([nx - 1, ny - 1, nz - 1],
                                            device=p_nor.device))
    flat = grid.reshape(-1, C)
    xs, ys, zs = (i0[:, 0], i1[:, 0]), (i0[:, 1], i1[:, 1]), \
        (i0[:, 2], i1[:, 2])
    c = [flat[(xs[a] * ny + ys[b]) * nz + zs[cc]]
         for a in (0, 1) for b in (0, 1) for cc in (0, 1)]
    fx, fy, fz = f[:, 0:1], f[:, 1:2], f[:, 2:3]
    c00 = c[0] * (1 - fz) + c[1] * fz
    c01 = c[2] * (1 - fz) + c[3] * fz
    c10 = c[4] * (1 - fz) + c[5] * fz
    c11 = c[6] * (1 - fz) + c[7] * fz
    return (c00 * (1 - fy) + c01 * fy) * (1 - fx) + (
        c10 * (1 - fy) + c11 * fy) * fx


def mlp(dec, p, c, color: bool):
    """A NICE decoder (decoder.py:91-203): Fourier embedding sin(p B), five
    ReLU blocks each adding fc_c(c), the embedding concatenated after
    block 2, a linear head."""
    e = torch.sin(p @ dec["embed"]["B"])
    h = e
    for i in range(5):
        h = torch.relu(h @ dec["pts"][i]["w"] + dec["pts"][i]["b"])
        h = h + (c @ dec["fc_c"][i]["w"] + dec["fc_c"][i]["b"])
        if i == 2:
            h = torch.cat([e, h], -1)
    out = h @ dec["out"]["w"] + dec["out"]["b"]
    return out if color else out[..., 0]


def decode(params, grids, bound, p, stage: str):
    """raw (N, 4) [rgb, occupancy] of a stage (decoder.py:312-342), with
    the occupancy forced to 100 outside the AABB (Renderer.py:57)."""
    lo, hi = bound[:, 0], bound[:, 1]
    p_nor = (p - lo) / (hi - lo) * 2.0 - 1.0
    c_mid = trilinear(grids["middle"], p_nor)
    occ = mlp(params["middle"], p, c_mid, False)
    rgb = torch.zeros(p.shape[:-1] + (3,), dtype=p.dtype, device=p.device)
    if stage in ("fine", "color"):
        c_fine = trilinear(grids["fine"], p_nor)
        occ = occ + mlp(params["fine"], p,
                        torch.cat([c_fine, c_mid.detach()], -1), False)
    if stage == "color":
        rgb = mlp(params["color"], p, trilinear(grids["color"], p_nor),
                  True)[..., :3]
    inside = torch.all((p > lo) & (p < hi), dim=-1)
    occ = torch.where(inside, occ, torch.full_like(occ, 100.0))
    return torch.cat([rgb, occ[..., None]], -1)


def render(params, grids, bound, o, d, gt_depth, stage, n_samples,
           n_surface, chunk: int = 1 << 16):
    """(depth, variance, colour) of rays, occupancy compositing
    (common.py:204-245), in blocks of rays; the depth samples span the
    whole batch's deepest pixel."""
    outs = []
    max_d = torch.max(gt_depth)
    for s in range(0, o.shape[0], chunk):
        oo, dd, gd = o[s:s + chunk], d[s:s + chunk], gt_depth[s:s + chunk]
        z = z_values(oo, dd, gd, max_d, bound, n_samples, n_surface)
        pts = oo[:, None, :] + dd[:, None, :] * z[..., None]
        raw = decode(params, grids, bound, pts.reshape(-1, 3),
                     stage).reshape(z.shape + (4,))
        alpha = torch.sigmoid(10.0 * raw[..., 3])
        trans = torch.cumprod(torch.cat(
            [torch.ones_like(alpha[..., :1]), 1.0 - alpha[..., :-1] + 1e-10],
            -1), -1)
        w = alpha * trans
        depth = torch.sum(w * z, -1)
        var = torch.sum(w * (z - depth[..., None]) ** 2, -1)
        outs.append((depth, var, torch.sum(w[..., None] * raw[..., :3], -2)))
    return tuple(torch.cat(x) for x in zip(*outs))


# -- losses ----------------------------------------------------------------

def lower_median(x, mask):
    """torch.median's lower middle of x over mask."""
    srt, _ = torch.sort(torch.where(mask, x, torch.full_like(x, np.inf)))
    n = int(mask.sum())
    return srt[max((n - 1) // 2, 0)]


def tracking_loss(cam, params, grids, bound, color, depth, pix, cfg,
                  render_args):
    """Tracker.py:71-128: the depth residual over sqrt(variance), pixels
    beyond 10x its median or outside the AABB dropped, plus 0.5 x the L1
    colour residual."""
    c2w = cam_to_c2w(cam)
    i, j = pix
    o, d = rays(i, j, c2w, render_args["cam"])
    bd = depth[j.long(), i.long()]
    bc = color[j.long(), i.long()]
    inside = aabb_exit(o.detach(), d.detach(), bound) >= bd
    dep, var, col = render(params, grids, bound, o, d, bd, "color",
                           *render_args["samples"])
    tmp = torch.abs(bd - dep) / torch.sqrt(var.detach() + 1e-10)
    t = cfg["tracking"]
    if t["handle_dynamic"]:
        med = lower_median(tmp.detach(), inside)
        mask = (tmp < 10.0 * med) & (bd > 0) & inside
    else:
        mask = (bd > 0) & inside
    loss = torch.sum(tmp * mask)
    if t["use_color_in_tracking"]:
        loss = loss + t["w_color_loss"] * torch.sum(
            torch.abs(bc - col) * mask[:, None])
    return loss


def depth_median(c2w, params, grids, bound, depth, pix, render_args):
    """init_select's signal: the median absolute depth residual of a
    candidate pose over the valid pixels."""
    i, j = pix
    o, d = rays(i, j, c2w, render_args["cam"])
    bd = depth[j.long(), i.long()]
    dep, _, _ = render(params, grids, bound, o, d, bd, "color",
                       *render_args["samples"])
    return lower_median(torch.abs(bd - dep), bd > 0)


def adam(p, g, m, v, k, lr, b1=0.9, b2=0.999, eps=1e-8):
    """torch.optim.Adam's step k (from 1), in place."""
    m.mul_(b1).add_((1 - b1) * g)
    v.mul_(b2).add_((1 - b2) * g * g)
    mh = m / (1.0 - b1 ** k)
    vh = v / (1.0 - b2 ** k)
    p.sub_(lr * mh / (torch.sqrt(vh) + eps))
