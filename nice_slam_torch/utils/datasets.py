"""Host-side dataset readers (numpy and the port's own image codec in
utils/imageio.py — I/O stays off-device).

Same dataset families and preprocessing semantics as the reference
(src/utils/datasets.py): PNG depth / png_depth_scale, optional color
undistortion, color resized to depth resolution, optional crop_size
resize + crop_edge trim, pose translation scaling, and the column-flip of
pose axes 1,2 into the internal (-y, -z) convention.  Plus a 'synthetic'
dataset (utils/synthetic.py) used by tests/bench.

The readers give the same arrays on every machine: JPEG and PNG go through
utils/imageio.py, never OpenCV.  Only CoFusion's OpenEXR depth is read with
cv2, imported on that path alone.
"""

from __future__ import annotations

import glob
import os
from typing import List, Optional, Tuple

import numpy as np

from nice_slam_torch.utils.imageio import (
    imread_color,
    imread_depth,
    resize_linear,
    resize_nearest,
    undistort,
)


def quantize_color_u8(color: np.ndarray) -> np.ndarray:
    """f32 [0,1] color -> uint8, round-half-up: the rule of the uint8
    host-to-device colour upload (the JAX package's
    nice_slam_tpu/utils/datasets.py quantize_color_u8)."""
    return np.clip(color * 255.0 + 0.5, 0, 255).astype(np.uint8)


def _read_exr_depth(path: str) -> np.ndarray:
    """OpenEXR depth (CoFusion's depth_noise/*.exr) through OpenCV: the one
    format the port has no reader of its own for."""
    try:
        import cv2
    except ImportError:
        raise IOError(f"cannot read {path}: OpenEXR depth needs OpenCV "
                      "(cv2), which is not installed") from None
    os.environ.setdefault("OPENCV_IO_ENABLE_OPENEXR", "1")
    depth = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if depth is None:
        raise IOError(f"cannot read EXR depth {path} "
                      "(cv2 lacks OpenEXR support)")
    if depth.ndim == 3:
        depth = depth[..., 0]
    return depth.astype(np.float32)


def as_intrinsics_matrix(fx, fy, cx, cy) -> np.ndarray:
    K = np.eye(3)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = fx, fy, cx, cy
    return K


class BaseDataset:
    """Yields (index, color (H,W,3) f32 [0,1], depth (H,W) f32 meters,
    gt_c2w (4,4) f32) as numpy arrays."""

    def __init__(self, cfg: dict, input_folder: Optional[str] = None,
                 scale: float = 1.0):
        cam = cfg["cam"]
        self.png_depth_scale = cam["png_depth_scale"]
        self.fx, self.fy = cam["fx"], cam["fy"]
        self.cx, self.cy = cam["cx"], cam["cy"]
        self.distortion = (np.array(cam["distortion"])
                           if cam.get("distortion") is not None else None)
        self.crop_size = cam.get("crop_size")
        self.crop_edge = cam.get("crop_edge", 0)
        self.scale = scale
        self.input_folder = input_folder or cfg["data"]["input_folder"]
        self.color_paths: List[str] = []
        self.depth_paths: List[str] = []
        self.poses: List[np.ndarray] = []
        self.n_img = 0

    # file-backed color is natively 8-bit: the engine uploads it as uint8
    # (4x fewer bytes) and dequantizes on the device, bit-exact with the
    # f32 upload for 8-bit sources.  The synthetic dataset overrides this
    # (its color is continuous f32).
    transfer_color_uint8 = True

    def __len__(self):
        return self.n_img

    def _read_depth(self, path: str) -> np.ndarray:
        if path.endswith(".exr"):
            return _read_exr_depth(path)
        return imread_depth(path).astype(np.float32) / self.png_depth_scale

    def __getitem__(self, index: int):
        color = imread_color(self.color_paths[index])
        depth = self._read_depth(self.depth_paths[index])
        if self.distortion is not None:
            K = as_intrinsics_matrix(self.fx, self.fy, self.cx, self.cy)
            color = undistort(color, K, self.distortion)
        color = color.astype(np.float32) / 255.0
        depth = depth * self.scale
        H, W = depth.shape
        if color.shape[:2] != (H, W):
            color = resize_linear(color, H, W)
        if self.crop_size is not None:
            ch, cw = self.crop_size
            color = resize_linear(color, ch, cw)
            depth = resize_nearest(depth, ch, cw)
        e = self.crop_edge
        if e > 0:
            color = color[e:-e, e:-e]
            depth = depth[e:-e, e:-e]
        pose = self.poses[index].copy()
        pose[:3, 3] *= self.scale
        return index, color, depth, pose.astype(np.float32)

    @staticmethod
    def _flip_yz(c2w: np.ndarray) -> np.ndarray:
        """Dataset camera convention -> internal (-y, -z) convention
        (reference datasets.py:134-135 et al.)."""
        c2w = c2w.copy()
        c2w[:3, 1] *= -1
        c2w[:3, 2] *= -1
        return c2w


class Replica(BaseDataset):
    def __init__(self, cfg, input_folder=None, scale=1.0):
        super().__init__(cfg, input_folder, scale)
        self.color_paths = sorted(
            glob.glob(f"{self.input_folder}/results/frame*.jpg"))
        self.depth_paths = sorted(
            glob.glob(f"{self.input_folder}/results/depth*.png"))
        self.n_img = len(self.color_paths)
        with open(f"{self.input_folder}/traj.txt") as f:
            lines = f.readlines()
        self.poses = [
            self._flip_yz(np.array(list(map(float, lines[i].split())),
                                   dtype=np.float64).reshape(4, 4))
            for i in range(self.n_img)
        ]


class ScanNet(BaseDataset):
    def __init__(self, cfg, input_folder=None, scale=1.0):
        super().__init__(cfg, input_folder, scale)
        root = os.path.join(self.input_folder, "frames")
        num = lambda p: int(os.path.basename(p).split(".")[0])
        self.color_paths = sorted(
            glob.glob(os.path.join(root, "color", "*.jpg")), key=num)
        self.depth_paths = sorted(
            glob.glob(os.path.join(root, "depth", "*.png")), key=num)
        pose_paths = sorted(
            glob.glob(os.path.join(root, "pose", "*.txt")), key=num)
        self.poses = []
        for p in pose_paths:
            mat = np.loadtxt(p).reshape(4, 4)
            self.poses.append(self._flip_yz(mat))
        self.n_img = len(self.color_paths)


class Azure(BaseDataset):
    def __init__(self, cfg, input_folder=None, scale=1.0):
        super().__init__(cfg, input_folder, scale)
        self.color_paths = sorted(
            glob.glob(os.path.join(self.input_folder, "color", "*.jpg")))
        self.depth_paths = sorted(
            glob.glob(os.path.join(self.input_folder, "depth", "*.png")))
        self.n_img = len(self.color_paths)
        traj = os.path.join(self.input_folder, "scene", "trajectory.log")
        self.poses = []
        if os.path.exists(traj):
            with open(traj) as f:
                content = f.readlines()
            for i in range(0, len(content), 5):
                mat = np.array(
                    list(map(float, ("".join(content[i + 1:i + 5])).split()))
                ).reshape(4, 4)
                self.poses.append(self._flip_yz(mat))
        else:
            self.poses = [np.eye(4) for _ in range(self.n_img)]


class CoFusion(BaseDataset):
    def __init__(self, cfg, input_folder=None, scale=1.0):
        super().__init__(cfg, input_folder, scale)
        self.color_paths = sorted(
            glob.glob(os.path.join(self.input_folder, "colour", "*.png")))
        self.depth_paths = sorted(
            glob.glob(os.path.join(self.input_folder, "depth_noise", "*.exr")))
        self.n_img = len(self.color_paths)
        # GT trajectory frame cannot be aligned; identity proxies are fine
        # for ATE (reference datasets.py:223-231)
        self.poses = [np.eye(4) for _ in range(self.n_img)]


class TUMRGBD(BaseDataset):
    def __init__(self, cfg, input_folder=None, scale=1.0, frame_rate=32):
        super().__init__(cfg, input_folder, scale)
        self.color_paths, self.depth_paths, self.poses = self._load_tum(
            self.input_folder, frame_rate)
        self.n_img = len(self.color_paths)

    @staticmethod
    def _parse_list(path, skiprows=0):
        return np.loadtxt(path, delimiter=" ", dtype=np.str_,
                          skiprows=skiprows)

    @staticmethod
    def _associate(t_img, t_depth, t_pose, max_dt=0.08):
        assoc = []
        for i, t in enumerate(t_img):
            j = np.argmin(np.abs(t_depth - t))
            k = np.argmin(np.abs(t_pose - t))
            if abs(t_depth[j] - t) < max_dt and abs(t_pose[k] - t) < max_dt:
                assoc.append((i, j, k))
        return assoc

    def _load_tum(self, root, frame_rate):
        from scipy.spatial.transform import Rotation

        pose_file = os.path.join(root, "groundtruth.txt")
        if not os.path.isfile(pose_file):
            pose_file = os.path.join(root, "pose.txt")
        img = self._parse_list(os.path.join(root, "rgb.txt"))
        dep = self._parse_list(os.path.join(root, "depth.txt"))
        pose = self._parse_list(pose_file, skiprows=1)
        pose_vecs = pose[:, 1:].astype(np.float64)
        t_img = img[:, 0].astype(np.float64)
        t_dep = dep[:, 0].astype(np.float64)
        t_pose = pose[:, 0].astype(np.float64)
        assoc = self._associate(t_img, t_dep, t_pose)

        keep = [0]
        for i in range(1, len(assoc)):
            if t_img[assoc[i][0]] - t_img[assoc[keep[-1]][0]] > 1.0 / frame_rate:
                keep.append(i)

        colors, depths, poses = [], [], []
        inv_first = None
        for ix in keep:
            i, j, k = assoc[ix]
            colors.append(os.path.join(root, str(img[i, 1])))
            depths.append(os.path.join(root, str(dep[j, 1])))
            v = pose_vecs[k]
            c2w = np.eye(4)
            c2w[:3, :3] = Rotation.from_quat(v[3:]).as_matrix()
            c2w[:3, 3] = v[:3]
            if inv_first is None:
                inv_first = np.linalg.inv(c2w)
                c2w = np.eye(4)
            else:
                c2w = inv_first @ c2w
            poses.append(self._flip_yz(c2w))
        return colors, depths, poses


class Synthetic(BaseDataset):
    """Procedurally ray-traced scene; renders frames lazily and caches."""

    transfer_color_uint8 = False  # continuous f32 color, keep exact

    def __init__(self, cfg, input_folder=None, scale=1.0):
        super().__init__(cfg, input_folder, scale)
        from nice_slam_torch.utils.synthetic import (
            SyntheticScene, orbit_trajectory)

        syn = cfg.get("synthetic", {})
        self.scene = SyntheticScene.default()
        self.n_img = int(syn.get("n_frames", 60))
        self.H0 = cfg["cam"]["H"]
        self.W0 = cfg["cam"]["W"]
        c2ws = orbit_trajectory(self.scene, self.n_img,
                                sweep=syn.get("sweep"))
        self.poses = [c2ws[i] for i in range(self.n_img)]
        self._cache = {}

    def __getitem__(self, index: int):
        from nice_slam_torch.utils.synthetic import render_frame

        if index not in self._cache:
            color, depth = render_frame(
                self.scene, self.poses[index], self.H0, self.W0,
                self.fx, self.fy, self.cx, self.cy)
            e = self.crop_edge
            if e > 0:
                color = color[e:-e, e:-e]
                depth = depth[e:-e, e:-e]
            self._cache[index] = (color, depth * self.scale)
        color, depth = self._cache[index]
        pose = self.poses[index].copy()
        pose[:3, 3] *= self.scale
        return index, color, depth, pose.astype(np.float32)


dataset_dict = {
    "replica": Replica,
    "scannet": ScanNet,
    "cofusion": CoFusion,
    "azure": Azure,
    "tumrgbd": TUMRGBD,
    "synthetic": Synthetic,
}


def get_dataset(cfg: dict, input_folder: Optional[str] = None,
                scale: Optional[float] = None) -> BaseDataset:
    scale = cfg["scale"] if scale is None else scale
    return dataset_dict[cfg["dataset"]](cfg, input_folder, scale)
