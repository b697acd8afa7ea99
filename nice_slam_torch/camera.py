"""Pinhole camera model + preprocessing-aware intrinsics updates."""

from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class Camera:
    """Intrinsics after preprocessing (frozen, hashable)."""
    H: int
    W: int
    fx: float
    fy: float
    cx: float
    cy: float

    @staticmethod
    def from_cfg(cam_cfg: dict) -> "Camera":
        """Apply crop_size rescale and crop_edge trimming exactly like the
        reference (src/NICE_SLAM.py:113-135)."""
        H, W = cam_cfg["H"], cam_cfg["W"]
        fx, fy = cam_cfg["fx"], cam_cfg["fy"]
        cx, cy = cam_cfg["cx"], cam_cfg["cy"]
        if cam_cfg.get("crop_size") is not None:
            ch, cw = cam_cfg["crop_size"]
            sx, sy = cw / W, ch / H
            fx, fy, cx, cy = sx * fx, sy * fy, sx * cx, sy * cy
            H, W = ch, cw
        edge = cam_cfg.get("crop_edge", 0)
        if edge > 0:
            H -= 2 * edge
            W -= 2 * edge
            cx -= edge
            cy -= edge
        return Camera(H=int(H), W=int(W), fx=float(fx), fy=float(fy),
                      cx=float(cx), cy=float(cy))

    def scaled(self, s: float) -> "Camera":
        return replace(self, H=int(self.H * s), W=int(self.W * s),
                       fx=self.fx * s, fy=self.fy * s,
                       cx=self.cx * s, cy=self.cy * s)
