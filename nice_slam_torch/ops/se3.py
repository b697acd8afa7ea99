"""Differentiable SE(3) <-> tensor conversions.

The camera is the 7-vector ``[qw qx qy qz tx ty tz]`` (quaternion +
translation), the JAX package's layout (reference src/common.py:137-201).
Matrix -> quaternion is the branchless Shepperd method, so pose
initialisation stays on the device.
"""

from __future__ import annotations

import torch

from nice_slam_torch.ops.consts import const


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """Quaternion(s) (..., 4) [w x y z] -> rotation matrices (..., 3, 3).

    Non-unit quaternions are handled through the 2/|q|^2 normalisation, so
    gradient steps on the raw 4-vector stay valid rotations."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    s = 2.0 / torch.sum(q * q, dim=-1)
    r00 = 1 - s * (y * y + z * z)
    r01 = s * (x * y - z * w)
    r02 = s * (x * z + y * w)
    r10 = s * (x * y + z * w)
    r11 = 1 - s * (x * x + z * z)
    r12 = s * (y * z - x * w)
    r20 = s * (x * z - y * w)
    r21 = s * (y * z + x * w)
    r22 = 1 - s * (x * x + y * y)
    rows = [torch.stack([r00, r01, r02], dim=-1),
            torch.stack([r10, r11, r12], dim=-1),
            torch.stack([r20, r21, r22], dim=-1)]
    return torch.stack(rows, dim=-2)


def rot_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) -> unit quaternions (..., 4) [w x y z],
    with the sign fixed to w >= 0."""
    r00, r01, r02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    r10, r11, r12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    r20, r21, r22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = r00 + r11 + r22
    p = torch.stack([1.0 + tr, 1.0 + r00 - r11 - r22,
                     1.0 - r00 + r11 - r22, 1.0 - r00 - r11 + r22], dim=-1)
    p = torch.clamp(p, min=1e-12)
    s = torch.sqrt(p)  # 2*|q_pivot|
    # one candidate per pivot: [numerators] / (2 s_i), pivot numerator p_i
    qw = torch.stack([p[..., 0], r21 - r12, r02 - r20, r10 - r01], -1) / s[..., 0:1]
    qx = torch.stack([r21 - r12, p[..., 1], r01 + r10, r02 + r20], -1) / s[..., 1:2]
    qy = torch.stack([r02 - r20, r01 + r10, p[..., 2], r12 + r21], -1) / s[..., 2:3]
    qz = torch.stack([r10 - r01, r02 + r20, r12 + r21, p[..., 3]], -1) / s[..., 3:4]
    cands = torch.stack([qw, qx, qy, qz], dim=-2) * 0.5  # (..., 4 cases, 4)
    case = torch.argmax(p, dim=-1)
    idx = case[..., None, None].expand(*case.shape, 1, 4)
    q = torch.gather(cands, -2, idx)[..., 0, :]
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    return torch.where(q[..., 0:1] < 0, -q, q)


def cam_from_tensor(t: torch.Tensor) -> torch.Tensor:
    """Camera 7-vector(s) (..., 7) -> c2w matrices (..., 3, 4)."""
    R = quat_to_rot(t[..., :4])
    return torch.cat([R, t[..., 4:7][..., :, None]], dim=-1)


def tensor_from_cam(c2w: torch.Tensor) -> torch.Tensor:
    """c2w matrices (..., 3|4, 4) -> camera 7-vectors (..., 7)."""
    return torch.cat([rot_to_quat(c2w[..., :3, :3]), c2w[..., :3, 3]], dim=-1)


def to_homogeneous(c2w34: torch.Tensor) -> torch.Tensor:
    """(..., 3, 4) -> (..., 4, 4) with a [0 0 0 1] bottom row."""
    bottom = const([0.0, 0.0, 0.0, 1.0], c2w34.dtype, c2w34.device)
    bottom = bottom.expand(*c2w34.shape[:-2], 1, 4)
    return torch.cat([c2w34, bottom], dim=-2)
