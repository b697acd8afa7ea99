"""The port's own image reading, writing and resampling for the dataset
readers (utils/datasets.py): what the JAX package's readers take from
OpenCV, without OpenCV.

JPEG decoding and encoding and PNG unfiltering are host C++
(`nice_slam_torch/native/imgcodec.cpp`, built with g++ at the first call);
PNG's inflate is Python's zlib.  The JPEG decode equals libjpeg-turbo's
default decode, which is what `cv2.imread` gives.  The resampling follows
OpenCV's conventions:

- `resize_linear`: `cv2.resize(..., INTER_LINEAR)` on float32 (half-pixel
  centres, edges clamped, horizontal pass then vertical; an exact 2x
  downscale as OpenCV's fast INTER_AREA);
- `resize_nearest`: `cv2.resize(..., INTER_NEAREST)` (source index
  `floor(dst * src / dst)`);
- `undistort`: `cv2.undistort` (the map of `initUndistortRectifyMap` in
  5-bit fixed point, then `remap`'s bilinear 8-bit interpolation with a
  zero border).

Files are told apart by their first bytes, not their names, as
`cv2.imread` does.
"""

from __future__ import annotations

import ctypes
import struct
import zlib

import numpy as np

JPEG_MAGIC = b"\xff\xd8\xff"
PNG_MAGIC = b"\x89PNG\r\n\x1a\n"

_ERRLEN = 256
_U8P = ctypes.POINTER(ctypes.c_uint8)


def _lib():
    from nice_slam_torch.native import get_codec_lib

    return get_codec_lib()


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


# ---------------------------------------------------------------------------
# JPEG

def decode_jpeg(data: bytes) -> np.ndarray:
    """Baseline JPEG bytes -> (H, W, 3) uint8 RGB (gray repeated)."""
    lib = _lib()
    src = np.frombuffer(data, np.uint8)
    err = ctypes.create_string_buffer(_ERRLEN)
    h, w, nc = ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int32()
    if lib.jpeg_info(src.ctypes.data_as(_U8P), src.size, ctypes.byref(h),
                     ctypes.byref(w), ctypes.byref(nc), err, _ERRLEN):
        raise ValueError(err.value.decode())
    out = np.empty((h.value, w.value, 3), np.uint8)
    if lib.jpeg_decode(src.ctypes.data_as(_U8P), src.size,
                       out.ctypes.data_as(_U8P), out.size, err, _ERRLEN):
        raise ValueError(err.value.decode())
    return out


def encode_jpeg(rgb: np.ndarray, quality: int = 95) -> bytes:
    """(H, W, 3) uint8 RGB -> baseline 4:2:0 JPEG bytes (the Annex K
    tables scaled to `quality` by the IJG rule)."""
    rgb = np.ascontiguousarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"encode_jpeg takes (H, W, 3) uint8, got "
                         f"{rgb.dtype} {rgb.shape}")
    h, w = rgb.shape[:2]
    cap = h * w * 3 + 4096
    out = np.empty(cap, np.uint8)
    n = ctypes.c_int64()
    err = ctypes.create_string_buffer(_ERRLEN)
    if _lib().jpeg_encode(rgb.ctypes.data_as(_U8P), h, w, int(quality),
                          out.ctypes.data_as(_U8P), cap, ctypes.byref(n),
                          err, _ERRLEN):
        raise ValueError(err.value.decode())
    return out[:n.value].tobytes()


# ---------------------------------------------------------------------------
# PNG

_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # gray, RGB, gray+alpha, RGBA


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> the stored samples: (H, W) for gray, (H, W, C) with C
    2 / 3 / 4 for gray+alpha / RGB / RGBA; uint8 or uint16 by bit depth."""
    if not data.startswith(PNG_MAGIC):
        raise ValueError("not a PNG file")
    pos, idat, ihdr = len(PNG_MAGIC), [], None
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n or pos + 12 + n > len(data):
            raise ValueError("truncated PNG chunk")
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r}: bad CRC")
        pos += 12 + n
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if ihdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = ihdr
    if ctype not in _PNG_CHANNELS:
        raise ValueError(f"PNG colour type {ctype} not supported (gray, "
                         "gray+alpha, RGB, RGBA)")
    if depth not in (8, 16):
        raise ValueError(f"PNG bit depth {depth} not supported (8, 16)")
    if interlace:
        raise ValueError("interlaced PNG not supported")
    ch = _PNG_CHANNELS[ctype]
    bpp = ch * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    out = np.empty(h * w * bpp, np.uint8)
    err = ctypes.create_string_buffer(_ERRLEN)
    if _lib().png_unfilter(raw.ctypes.data_as(_U8P), raw.size, h, w * bpp,
                           bpp, out.ctypes.data_as(_U8P), err, _ERRLEN):
        raise ValueError(err.value.decode())
    img = (out.view(">u2").astype(np.uint16) if depth == 16 else out)
    return img.reshape((h, w) if ch == 1 else (h, w, ch))


def encode_png(img: np.ndarray, level: int = 6) -> bytes:
    """(H, W) gray or (H, W, C) with C 2 / 3 / 4 for gray+alpha / RGB /
    RGBA, uint8 or uint16 -> PNG bytes (filter None, zlib at `level`)."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"encode_png takes uint8 or uint16, got {img.dtype}")
    ctype = {2: 0, 3: {2: 4, 3: 2, 4: 6}.get(img.shape[-1])}.get(img.ndim)
    if ctype is None:
        raise ValueError(f"encode_png takes (H, W) or (H, W, 2 | 3 | 4), "
                         f"got {img.shape}")
    h, w = img.shape[:2]
    depth = 16 if img.dtype == np.uint16 else 8
    rows = np.ascontiguousarray(img, img.dtype.newbyteorder(">")).view(
        np.uint8).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (PNG_MAGIC
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                         0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + chunk(b"IEND", b""))


# ---------------------------------------------------------------------------
# Files

def imread_color(path: str) -> np.ndarray:
    """A JPEG or PNG file as (H, W, 3) uint8 RGB, as `cv2.imread(path)`
    (then BGR -> RGB) gives it: gray repeated, alpha dropped, 16-bit
    samples cut to their high byte."""
    data = _read(path)
    try:
        if data.startswith(JPEG_MAGIC):
            return decode_jpeg(data)
        if data.startswith(PNG_MAGIC):
            img = decode_png(data)
            if img.dtype == np.uint16:
                img = (img >> 8).astype(np.uint8)
            if img.ndim == 2:
                img = img[..., None]
            img = img[..., :3] if img.shape[2] >= 3 else img[..., :1]
            return np.ascontiguousarray(np.broadcast_to(
                img, img.shape[:2] + (3,)))
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None
    raise ValueError(f"{path}: not a JPEG or PNG file")


def imread_depth(path: str) -> np.ndarray:
    """A single-channel PNG depth file as stored (uint16, or uint8 for an
    8-bit file), as `cv2.imread(path, IMREAD_UNCHANGED)` gives it."""
    data = _read(path)
    if not data.startswith(PNG_MAGIC):
        raise ValueError(f"{path}: depth must be a PNG file")
    try:
        img = decode_png(data)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None
    if img.ndim != 2:
        raise ValueError(f"{path}: depth PNG has {img.shape[2]} channels, "
                         "not 1")
    return img


def write_png(path: str, img: np.ndarray, level: int = 6) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img, level))


def write_jpeg(path: str, rgb: np.ndarray, quality: int = 95) -> None:
    with open(path, "wb") as f:
        f.write(encode_jpeg(rgb, quality))


# ---------------------------------------------------------------------------
# Resampling

def _linear_taps(src: int, dst: int):
    """cv2.resize's INTER_LINEAR taps along one axis: (lower index, upper
    index, lower weight, upper weight), float32 weights."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = f - s.astype(np.float32)
    clamp = (s < 0) | (s >= src - 1)
    f[clamp] = 0.0
    s = np.clip(s, 0, src - 1)
    return s, np.minimum(s + 1, src - 1), np.float32(1.0) - f, f


def _halve(img: np.ndarray) -> np.ndarray:
    """cv2.resize's exact 2x downscale: OpenCV runs INTER_LINEAR there as
    its fast INTER_AREA, the mean of each 2x2 block summed in the order of
    resizeAreaFast_ (((a + b) + c) + d), or of its SIMD rows ((a + b) +
    (c + d)) for 1 channel (all but the row's last w % 4 outputs) and 4."""
    a, b = img[0::2, 0::2], img[0::2, 1::2]
    c, d = img[1::2, 0::2], img[1::2, 1::2]
    quarter = np.float32(0.25)
    out = (((a + b) + c) + d) * quarter
    cn = 1 if img.ndim == 2 else img.shape[2]
    if cn in (1, 4):
        pairs = ((a + b) + (c + d)) * quarter
        n = out.shape[1] // 4 * 4 if cn == 1 else out.shape[1]
        out[:, :n] = pairs[:, :n]
    return out


def resize_linear(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """float32 (H, W) or (H, W, C) -> (height, width[, C]), bilinear."""
    if img.dtype != np.float32:
        raise ValueError(f"resize_linear takes float32, got {img.dtype}")
    if img.shape[:2] == (2 * height, 2 * width):
        return _halve(img)
    x0, x1, ax0, ax1 = _linear_taps(img.shape[1], width)
    y0, y1, ay0, ay1 = _linear_taps(img.shape[0], height)
    tail = (1,) * (img.ndim - 2)
    ax0, ax1 = ax0.reshape((1, -1) + tail), ax1.reshape((1, -1) + tail)
    rows = img[:, x0] * ax0 + img[:, x1] * ax1
    ay0, ay1 = ay0.reshape((-1, 1) + tail), ay1.reshape((-1, 1) + tail)
    return rows[y0] * ay0 + rows[y1] * ay1


def resize_nearest(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """(H, W[, C]) -> (height, width[, C]), nearest neighbour."""
    def idx(src, dst):
        scale = 1.0 / (dst / src)
        return np.minimum(np.floor(np.arange(dst) * scale).astype(np.int64),
                          src - 1)

    return img[idx(img.shape[0], height)][:, idx(img.shape[1], width)]


_TAB_BITS = 5          # OpenCV's INTER_BITS
_TAB = 1 << _TAB_BITS  # INTER_TAB_SIZE
_COEF_BITS = 15        # INTER_REMAP_COEF_BITS


def undistort(img: np.ndarray, K: np.ndarray, dist) -> np.ndarray:
    """uint8 (H, W[, C]) -> the image undistorted for camera matrix K and
    coefficients (k1, k2, p1, p2[, k3]), as cv2.undistort."""
    if img.dtype != np.uint8:
        raise ValueError(f"undistort takes uint8, got {img.dtype}")
    d = np.zeros(5)
    dist = np.asarray(dist, np.float64).reshape(-1)
    if dist.size not in (4, 5):
        raise ValueError(f"{dist.size} distortion coefficients (4 or 5)")
    d[:dist.size] = dist
    k1, k2, p1, p2, k3 = d
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    H, W = img.shape[:2]
    # initUndistortRectifyMap with R = I and the new camera matrix = K
    x = ((np.arange(W) - cx) / fx)[None, :]
    y = ((np.arange(H) - cy) / fy)[:, None]
    x2, y2 = x * x, y * y
    r2 = x2 + y2
    _2xy = 2 * x * y
    kr = 1 + ((k3 * r2 + k2) * r2 + k1) * r2
    u = fx * (x * kr + p1 * _2xy + p2 * (r2 + 2 * x2)) + cx
    v = fy * (y * kr + p1 * (r2 + 2 * y2) + p2 * _2xy) + cy
    iu = np.rint(u * _TAB).astype(np.int64)
    iv = np.rint(v * _TAB).astype(np.int64)
    sx, tx = iu >> _TAB_BITS, iu & (_TAB - 1)
    sy, ty = iv >> _TAB_BITS, iv & (_TAB - 1)
    # remap: bilinear weights in 1/32 steps scaled to 2^15, taps outside
    # the image read 0
    src = img.reshape(H, W, -1).astype(np.int64)
    acc = np.zeros(src.shape, np.int64)
    for dy, wy in ((0, _TAB - ty), (1, ty)):
        for dx, wx in ((0, _TAB - tx), (1, tx)):
            px, py = sx + dx, sy + dy
            inside = (px >= 0) & (px < W) & (py >= 0) & (py < H)
            tap = src[np.clip(py, 0, H - 1), np.clip(px, 0, W - 1)]
            wgt = (wy * wx * (1 << (_COEF_BITS - 2 * _TAB_BITS))) * inside
            acc += tap * wgt[..., None]
    out = np.clip((acc + (1 << (_COEF_BITS - 1))) >> _COEF_BITS, 0, 255)
    return out.astype(np.uint8).reshape(img.shape)
