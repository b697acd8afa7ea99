"""The port's file-backed dataset path (nice_slam_torch/utils/imageio.py,
utils/datasets.py and the engine's uint8 colour upload), held against
OpenCV and the JAX package's readers on the CPU.

- The codec against cv2 (OpenCV with libjpeg-turbo and libpng here):
  JPEG files written by cv2.imwrite (4:2:0, 4:2:2, 4:4:4 and gray,
  quality 75 and 95, 37x53 and 60x80, with and without restart markers)
  decode bit-equal to cv2.imread; PNG at 8 and 16 bits, gray, RGB and
  RGBA, compression 0, 3 and 9, bit-equal; the port's PNG and JPEG
  writers read back by cv2 (JPEG: cv2's decode equals the port's, PSNR
  against the source >= 35 dB); the committed
  tests/data/codec_420_61x45.jpg decodes to the digest chip_smoke.py
  holds the card to.
- Resampling: resize_nearest bit-equal to cv2.resize(INTER_NEAREST);
  resize_linear within 1e-6 of cv2.resize(INTER_LINEAR) on float32 with
  OpenCV's own code path (cv2.ipp off), and with cv2's default path at
  the readers' scales (cv2 hands larger float resizes to Intel IPP,
  whose coordinates differ from OpenCV's own by up to ~7e-5 at
  non-integer scales); undistort with TUM freiburg1's coefficients at
  most 1 level on at most 0.1% of pixels.
- The readers against the JAX package's on the same files (the layouts
  of tests/test_datasets.py): Replica (plain, crop_edge, crop_size),
  ScanNet, Azure with and without trajectory.log and TUM (association,
  distortion).  Colour, depth and pose are equal; the crop_size colour
  within 1e-6 (bit-equal with cv2.ipp off), TUM's undistorted colour
  within the undistort tolerance.
- The port's readers read every fixture with cv2 poisoned (a fresh
  interpreter with sys.modules["cv2"] = None): the readers must not need
  OpenCV.  EXR depth raises an error naming the file and the format.
- The uint8 upload: 3 engine frames over the Replica fixture give state
  bit-equal to the f32 upload (tests/test_datasets.py:106's engine run).
- configs/Replica/room0.yaml's child (tests/test_configs_e2e.py:84-116's
  budget: 7 frames, crop_size [170, 300], 4 tracking and 9 mapping
  iterations) through run_torch.py --device cpu over a fixture written by
  chip_smoke.py's own writer (the one phase 21 uses on the card): rc 0,
  a finite ATE, checkpoints written.
"""

import hashlib
import json
import os
import runpy
import subprocess
import sys

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
torch = pytest.importorskip("torch")

from nice_slam_tpu.config import load_config as jax_load_config  # noqa: E402
from nice_slam_tpu.utils.datasets import get_dataset as jax_get_dataset  # noqa: E402
from nice_slam_tpu.utils.synthetic import (  # noqa: E402
    SyntheticScene,
    orbit_trajectory,
    render_frame,
)

from nice_slam_torch.config import load_config  # noqa: E402
from nice_slam_torch.utils import imageio  # noqa: E402
from nice_slam_torch.utils.datasets import get_dataset  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 48, 64
FX = FY = 48.0
CX, CY = 31.5, 23.5
DEPTH_SCALE = 6553.5
# TUM RGB-D freiburg1 (configs/TUM_RGBD/fr1_desk.yaml's distortion)
TUM_K = np.array([[517.3, 0.0, 318.6], [0.0, 516.5, 255.3], [0.0, 0.0, 1.0]])
TUM_DIST = [0.2624, -0.9531, -0.0054, 0.0026, 1.1633]


def _rgb(path):
    return cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)


def _image(h, w, seed):
    """Smooth colour content with noise (JPEG-like statistics)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 100 * np.sin(xx / 7.0 + k) * np.cos(yy / 5.0 - k)
                     for k in range(3)], -1)
    return np.clip(base + rng.normal(0, 20, base.shape), 0,
                   255).astype(np.uint8)


def _ipp(on: bool):
    prev = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(on)
    return prev


# ---------------------------------------------------------------------------
# codec against cv2

SAMPLING = {"420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "gray": None}


@pytest.mark.parametrize("rst", [0, 4])
@pytest.mark.parametrize("size", [(37, 53), (60, 80)])
@pytest.mark.parametrize("quality", [75, 95])
@pytest.mark.parametrize("sampling", sorted(SAMPLING))
def test_jpeg_decode_bit_equal_to_cv2(tmp_path, sampling, quality, size,
                                      rst):
    img = _image(*size, seed=quality + rst)
    path = str(tmp_path / "t.jpg")
    params = [cv2.IMWRITE_JPEG_QUALITY, quality]
    if rst:
        params += [cv2.IMWRITE_JPEG_RST_INTERVAL, rst]
    if SAMPLING[sampling] is None:
        assert cv2.imwrite(path, img[..., 0], params)
    else:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]
        assert cv2.imwrite(path, cv2.cvtColor(img, cv2.COLOR_RGB2BGR),
                           params)
    np.testing.assert_array_equal(imageio.imread_color(path), _rgb(path))


@pytest.mark.parametrize("level", [0, 3, 9])
@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_png_decode_bit_equal_to_cv2(tmp_path, dtype, channels, level):
    rng = np.random.default_rng(channels * 10 + level)
    shape = (37, 53) + ((channels,) if channels > 1 else ())
    img = rng.integers(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
    img[:12] = img[:1]          # flat rows: the encoder's filters differ
    img[20:, :9] = 7
    path = str(tmp_path / "t.png")
    assert cv2.imwrite(path, img, [cv2.IMWRITE_PNG_COMPRESSION, level])
    stored = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if channels > 1:             # cv2 keeps BGR(A)
        stored = stored[..., [2, 1, 0, 3][:channels]]
    with open(path, "rb") as f:
        np.testing.assert_array_equal(imageio.decode_png(f.read()), stored)
    np.testing.assert_array_equal(imageio.imread_color(path), _rgb(path))
    if channels == 1:
        np.testing.assert_array_equal(
            imageio.imread_depth(path), cv2.imread(path,
                                                   cv2.IMREAD_UNCHANGED))


@pytest.mark.parametrize("kind", ["gray8", "gray16", "gray_alpha", "rgb",
                                  "rgba16"])
def test_write_png_read_back_by_cv2(tmp_path, kind):
    rng = np.random.default_rng(3)
    shape, dtype = {"gray8": ((31, 17), np.uint8),
                    "gray16": ((31, 17), np.uint16),
                    "gray_alpha": ((31, 17, 2), np.uint8),
                    "rgb": ((31, 17, 3), np.uint8),
                    "rgba16": ((31, 17, 4), np.uint16)}[kind]
    img = rng.integers(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
    path = str(tmp_path / "w.png")
    imageio.write_png(path, img)
    got = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img.ndim == 2:
        np.testing.assert_array_equal(got, img)
    elif kind == "gray_alpha":   # cv2 reads gray+alpha as BGRA
        np.testing.assert_array_equal(got[..., 0], img[..., 0])
        np.testing.assert_array_equal(got[..., 3], img[..., 1])
    else:
        np.testing.assert_array_equal(got[..., [2, 1, 0, 3][:img.shape[2]]],
                                      img)
    np.testing.assert_array_equal(imageio.imread_color(path), _rgb(path))


@pytest.mark.parametrize("quality", [75, 95])
def test_write_jpeg_read_back_by_cv2(tmp_path, quality):
    scene = SyntheticScene.default()
    color, _ = render_frame(scene, orbit_trajectory(scene, 4)[1], 240,
                            320, 240.0, 240.0, 159.5, 119.5)
    src = (color * 255).astype(np.uint8)
    path = str(tmp_path / "w.jpg")
    imageio.write_jpeg(path, src, quality)
    got = imageio.imread_color(path)
    np.testing.assert_array_equal(got, _rgb(path))
    mse = np.mean((got.astype(np.float64) - src) ** 2)
    assert 10 * np.log10(255.0 ** 2 / mse) >= 35.0


def test_committed_jpeg_digest():
    """The file and digest phase 21 of chip_smoke.py decodes on the card:
    cv2's pixels and the port's give the digest the smoke holds."""
    cs = runpy.run_path(os.path.join(REPO, "chip_smoke.py"),
                        run_name="not_main")
    path = cs["CODEC_JPEG"]
    with open(path, "rb") as f:
        data = f.read()
    assert len(data) < 8192
    # baseline 4:2:0 (luma 2x2 in SOF0), a width not a multiple of 16
    sof = data.index(b"\xff\xc0")
    assert data[sof + 7:sof + 9] == (61).to_bytes(2, "big")
    assert data[sof + 11] == 0x22
    for img in (_rgb(path), imageio.imread_color(path)):
        assert hashlib.sha256(np.ascontiguousarray(img).tobytes()) \
            .hexdigest() == cs["CODEC_JPEG_SHA256"]


def test_codec_refuses_what_it_does_not_decode(tmp_path):
    img = _image(32, 40, 5)
    prog = str(tmp_path / "p.jpg")
    cv2.imwrite(prog, img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    with pytest.raises(ValueError, match="p.jpg: progressive"):
        imageio.imread_color(prog)
    # an Exif APP1 with orientation 6 right after SOI
    base = str(tmp_path / "b.jpg")
    cv2.imwrite(base, img)
    with open(base, "rb") as f:
        data = f.read()
    tiff = (b"MM\x00\x2a\x00\x00\x00\x08\x00\x01"
            + b"\x01\x12\x00\x03\x00\x00\x00\x01\x00\x06\x00\x00"
            + b"\x00\x00\x00\x00")
    app1 = b"Exif\x00\x00" + tiff
    rotated = (data[:2] + b"\xff\xe1" + (len(app1) + 2).to_bytes(2, "big")
               + app1 + data[2:])
    with pytest.raises(ValueError, match="orientation 6"):
        imageio.decode_jpeg(rotated)
    # a PNG named .jpg reads by its bytes, as cv2.imread does
    png_named_jpg = str(tmp_path / "png.jpg")
    cv2.imwrite(str(tmp_path / "x.png"), img)
    os.replace(str(tmp_path / "x.png"), png_named_jpg)
    np.testing.assert_array_equal(imageio.imread_color(png_named_jpg),
                                  _rgb(png_named_jpg))
    with pytest.raises(ValueError, match="not a JPEG or PNG"):
        (tmp_path / "t.txt").write_text("hello")
        imageio.imread_color(str(tmp_path / "t.txt"))


# ---------------------------------------------------------------------------
# resampling

# (source H, W, target H, W, a scale the readers of the tests use:
# room0's crop_size [170, 300] and the crop_size case below)
RESIZES = [(680, 1200, 170, 300, True), (48, 64, 24, 32, True),
           (48, 64, 30, 40, False), (37, 53, 60, 80, False),
           (480, 640, 340, 600, False), (968, 1296, 480, 640, False)]


@pytest.mark.parametrize("shape", RESIZES)
def test_resize_nearest_bit_equal_to_cv2(shape):
    h, w, oh, ow, _ = shape
    d = np.random.default_rng(0).random((h, w), dtype=np.float32)
    np.testing.assert_array_equal(
        imageio.resize_nearest(d, oh, ow),
        cv2.resize(d, (ow, oh), interpolation=cv2.INTER_NEAREST))


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("shape", RESIZES)
def test_resize_linear_matches_cv2(shape, channels):
    h, w, oh, ow, readers = shape
    img = np.random.default_rng(1).random((h, w, channels),
                                          dtype=np.float32)
    img = img[..., 0] if channels == 1 else img
    got = imageio.resize_linear(img, oh, ow)
    prev = _ipp(False)
    try:
        ref = cv2.resize(img, (ow, oh), interpolation=cv2.INTER_LINEAR)
    finally:
        _ipp(prev)
    assert got.dtype == np.float32 and got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-6
    if readers:   # cv2's default path too
        ref = cv2.resize(img, (ow, oh), interpolation=cv2.INTER_LINEAR)
        assert np.abs(got - ref).max() <= 1e-6


def test_undistort_tum_freiburg1():
    img = cv2.GaussianBlur(np.random.default_rng(2).integers(
        0, 256, (480, 640, 3)).astype(np.uint8), (5, 5), 1.5)
    got = imageio.undistort(img, TUM_K, TUM_DIST)
    diff = np.abs(got.astype(np.int64) - cv2.undistort(img, TUM_K,
                                                       np.array(TUM_DIST)))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3


# ---------------------------------------------------------------------------
# readers against the JAX package's

def _flip_yz(m):
    m = m.copy()
    m[:3, 1] *= -1
    m[:3, 2] *= -1
    return m


def _cam(**kw):
    d = {"H": H, "W": W, "fx": FX, "fy": FY, "cx": CX, "cy": CY,
         "png_depth_scale": DEPTH_SCALE, "crop_edge": 0}
    d.update(kw)
    return d


def _write_color(path, color):
    cv2.imwrite(path, cv2.cvtColor((color * 255).astype(np.uint8),
                                   cv2.COLOR_RGB2BGR))


def _write_depth(path, depth, scale=DEPTH_SCALE):
    cv2.imwrite(path, (depth * scale).astype(np.uint16))


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    """Each dataset layout once, written by cv2 as tests/test_datasets.py
    writes them: {name: (root, cam overrides)}."""
    scene = SyntheticScene.default()
    c2ws = orbit_trajectory(scene, 4)
    frames = [render_frame(scene, c2ws[i], H, W, FX, FY, CX, CY) + (c2ws[i],)
              for i in range(4)]
    base = tmp_path_factory.mktemp("datasets")
    out = {}

    root = base / "replica"
    (root / "results").mkdir(parents=True)
    lines = []
    for i, (color, depth, c2w) in enumerate(frames):
        _write_color(str(root / "results" / f"frame{i:06d}.jpg"), color)
        _write_depth(str(root / "results" / f"depth{i:06d}.png"), depth)
        lines.append(" ".join(map(str, _flip_yz(c2w).reshape(-1))))
    (root / "traj.txt").write_text("\n".join(lines) + "\n")
    out["replica"] = str(root)

    root = base / "scannet"
    for sub in ("color", "depth", "pose"):
        (root / "frames" / sub).mkdir(parents=True)
    for i, (color, depth, c2w) in enumerate(frames):
        _write_color(str(root / "frames" / "color" / f"{i}.jpg"), color)
        _write_depth(str(root / "frames" / "depth" / f"{i}.png"), depth)
        np.savetxt(str(root / "frames" / "pose" / f"{i}.txt"), _flip_yz(c2w))
    out["scannet"] = str(root)

    for name, with_log in (("azure", True), ("azure_nolog", False)):
        root = base / name
        (root / "color").mkdir(parents=True)
        (root / "depth").mkdir()
        lines = []
        for i, (color, depth, c2w) in enumerate(frames):
            _write_color(str(root / "color" / f"{i:05d}.jpg"), color)
            _write_depth(str(root / "depth" / f"{i:05d}.png"), depth)
            lines.append(f"{i} {i} {i + 1}")
            lines += [" ".join(map(str, row)) for row in _flip_yz(c2w)]
        if with_log:
            (root / "scene").mkdir()
            (root / "scene" / "trajectory.log").write_text(
                "\n".join(lines) + "\n")
        out[name] = str(root)

    from scipy.spatial.transform import Rotation

    root = base / "tum"
    (root / "rgb").mkdir(parents=True)
    (root / "depth").mkdir()
    rgb, dep, gt = ["# rgb"], ["# depth"], ["# gt"]
    for i, (color, depth, c2w) in enumerate(frames):
        t = 100.0 + i
        _write_color(str(root / "rgb" / f"{t:.6f}.png"), color)
        _write_depth(str(root / "depth" / f"{t:.6f}.png"), depth, 5000.0)
        rgb.append(f"{t:.6f} rgb/{t:.6f}.png")
        dep.append(f"{t + 0.02:.6f} depth/{t:.6f}.png")
        m = _flip_yz(c2w)
        q = Rotation.from_matrix(m[:3, :3]).as_quat()
        gt.append(f"{t + 0.01:.6f} {m[0, 3]} {m[1, 3]} {m[2, 3]} "
                  f"{q[0]} {q[1]} {q[2]} {q[3]}")
    for f, lines in (("rgb.txt", rgb), ("depth.txt", dep),
                     ("groundtruth.txt", gt)):
        (root / f).write_text("\n".join(lines) + "\n")
    out["tum"] = str(root)
    return out


# (case, fixture, dataset, cam overrides)
READERS = [
    ("replica", "replica", "replica", {}),
    ("replica_crop_edge", "replica", "replica", {"crop_edge": 4}),
    ("replica_crop_size", "replica", "replica",
     {"crop_size": [24, 32], "crop_edge": 2}),
    ("scannet", "scannet", "scannet", {}),
    ("azure", "azure", "azure", {}),
    ("azure_nolog", "azure_nolog", "azure", {}),
    ("tum", "tum", "tumrgbd",
     {"png_depth_scale": 5000.0, "distortion": TUM_DIST,
      "fx": 517.3 / 10, "fy": 516.5 / 10, "cx": 31.86, "cy": 25.53}),
]


def _cfgs(root, dataset, cam):
    over = {"dataset": dataset, "cam": _cam(**cam),
            "data": {"input_folder": root, "output": "/nonexistent"}}
    return load_config(overrides=over), jax_load_config(overrides=over)


@pytest.mark.parametrize("case, fixture, dataset, cam", READERS,
                         ids=[r[0] for r in READERS])
def test_reader_equals_jax(fixtures, case, fixture, dataset, cam):
    cfg, jcfg = _cfgs(fixtures[fixture], dataset, cam)
    ds, jds = get_dataset(cfg), jax_get_dataset(jcfg)
    assert len(ds) == len(jds) == 4
    assert ds.transfer_color_uint8 and jds.transfer_color_uint8
    for i in range(len(ds)):
        idx, color, depth, pose = ds[i]
        jidx, jcolor, jdepth, jpose = jds[i]
        assert idx == jidx and color.dtype == jcolor.dtype == np.float32
        assert color.shape == jcolor.shape and depth.shape == jdepth.shape
        np.testing.assert_array_equal(depth, jdepth)
        np.testing.assert_array_equal(pose, jpose)
        if case == "tum":
            # undistort: at most 1 level on at most 0.1% of pixels
            diff = np.abs(color - jcolor)
            assert diff.max() <= 1.0 / 255 + 1e-7
            assert (diff > 0).mean() <= 1e-3
        elif case == "replica_crop_size":
            # cv2 may route the float resize through Intel IPP
            assert np.abs(color - jcolor).max() <= 1e-6
        else:
            np.testing.assert_array_equal(color, jcolor)
    if case == "replica_crop_size":   # OpenCV's own resize: bit-equal
        prev = _ipp(False)
        try:
            for i in range(len(ds)):
                np.testing.assert_array_equal(ds[i][1], jds[i][1])
        finally:
            _ipp(prev)


_POISONED = r"""
import hashlib, json, sys
sys.modules["cv2"] = None
from nice_slam_torch.utils.datasets import get_dataset
out = {}
for case, cfg in json.loads(sys.argv[1]).items():
    ds = get_dataset(cfg)
    h = hashlib.sha256()
    for i in range(len(ds)):
        for a in ds[i][1:]:
            h.update(a.tobytes())
    out[case] = h.hexdigest()
try:
    get_dataset(json.loads(sys.argv[2]))[0]
except IOError as e:
    out["exr"] = str(e)
print(json.dumps(out))
"""


def test_readers_without_cv2(fixtures, tmp_path):
    """A fresh interpreter with cv2 poisoned reads every fixture to the
    same arrays as this process; EXR depth names its file and format."""
    cfgs, want = {}, {}
    for case, fixture, dataset, cam in READERS:
        cfg, _ = _cfgs(fixtures[fixture], dataset, cam)
        cfgs[case] = cfg
        ds = get_dataset(cfg)
        h = hashlib.sha256()
        for i in range(len(ds)):
            for a in ds[i][1:]:
                h.update(a.tobytes())
        want[case] = h.hexdigest()
    cof = tmp_path / "cofusion"
    (cof / "colour").mkdir(parents=True)
    (cof / "depth_noise").mkdir()
    cv2.imwrite(str(cof / "colour" / "0.png"), _image(H, W, 1))
    (cof / "depth_noise" / "0.exr").write_bytes(b"v/1\x01")
    exr, _ = _cfgs(str(cof), "cofusion", {})
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", _POISONED, json.dumps(cfgs),
                          json.dumps(exr)], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert "0.exr" in got.pop("exr") and "OpenEXR" in res.stdout
    assert got == want


# ---------------------------------------------------------------------------
# the engine's uint8 upload

def test_uint8_upload_bit_equal_to_f32(fixtures, monkeypatch):
    from nice_slam_torch import engine as engine_mod
    from nice_slam_torch.engine import SlamEngine
    from nice_slam_torch.ops.tree import tree_leaves

    cfg = load_config(overrides={
        "dataset": "replica", "cam": _cam(),
        "grid_len": {"coarse": 1.0, "middle": 0.32, "fine": 0.16,
                     "color": 0.16},
        "mapping": {"bound": [[-0.5, 4.5], [-0.5, 3.5], [-0.5, 4.5]],
                    "marching_cubes_bound": [[0.0, 4.0], [0.0, 3.0],
                                             [0.0, 4.0]],
                    "every_frame": 2, "iters_first": 12, "iters": 4,
                    "pixels": 60, "mapping_window_size": 3,
                    "keyframe_every": 2, "ckpt_freq": 10000,
                    "mesh_freq": 10000, "color_refine": False},
        "tracking": {"iters": 3, "pixels": 40, "ignore_edge_W": 4,
                     "ignore_edge_H": 4},
        "rendering": {"N_samples": 8, "N_surface": 4},
        "data": {"input_folder": fixtures["replica"],
                 "output": "/nonexistent"}})
    quantized = []
    quantize = engine_mod.quantize_color_u8

    def counting(color):
        quantized.append(color.shape)
        return quantize(color)

    monkeypatch.setattr(engine_mod, "quantize_color_u8", counting)
    states = []
    for u8 in (True, False):
        eng = SlamEngine(cfg, device="cpu")
        eng.dataset.transfer_color_uint8 = u8
        eng.run(n_frames=3)
        st = eng.map_state
        states.append([eng.est_c2w_dev[:3], eng.store.colors,
                       eng.store.depths, eng.store.est_c2w]
                      + tree_leaves(st.params) + tree_leaves(st.grids))
        if u8:
            assert quantized == [(H, W, 3)] * 3   # frames 0, 1, 2
    assert len(quantized) == 3                  # the f32 run: none
    assert len(states[0]) == len(states[1]) > 6
    for a, b in zip(*states):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the room0 child through run_torch.py

def test_replica_room0_child_via_run_torch(tmp_path):
    cs = runpy.run_path(os.path.join(REPO, "chip_smoke.py"),
                        run_name="not_main")
    fixture = tmp_path / "room0"
    cfg = jax_load_config(os.path.join(REPO, "configs", "Replica",
                                       "room0.yaml"))
    cs["write_replica_fixture"](str(fixture), 7, cfg["cam"])
    out = tmp_path / "out"
    child = tmp_path / "room0_tiny.yaml"
    child.write_text(f"""
inherit_from: configs/Replica/room0.yaml
cam: {{crop_size: [170, 300]}}
tracking: {{iters: 4, pixels: 100, ignore_edge_W: 10, ignore_edge_H: 10}}
mapping:
  every_frame: 3
  iters_first: 30
  iters: 9
  pixels: 150
  mapping_window_size: 3
  keyframe_every: 3
  ckpt_freq: 100000
  mesh_freq: 100000
  color_refine: False
rendering: {{N_samples: 12, N_surface: 6}}
data: {{input_folder: {fixture}, output: {out}}}
""")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "run_torch.py"), str(child),
         "--frames", "7", "--no-mesh", "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    with open(out / "ate.json") as f:
        assert np.isfinite(json.load(f)["rmse"])
    assert os.listdir(out / "ckpts")
