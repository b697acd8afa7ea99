"""Fused NICE decode: the middle + fine + colour MLPs of the fine and colour
stages, forward and backward, as hand-written CUDA kernels: K1, the
forward (nice_slam_torch/csrc/fused_decode.cu: one block per 128-point
tile and decoder), and K2, the backward (csrc/fused_decode_bwd.cu: one
decoder per block, weight gradients only for the decoders that train).  Both run their
products of width 32 on the tensor cores in 3xTF32 through the trunk they
share (csrc/fused_decode_mma.cuh), and both read the same weight image,
which the forward builds from the weights (`build_image`) and keeps for
the backward.

This is the port of the JAX package's Pallas kernels
(nice_slam_tpu/ops/pallas/fused_decode.py: `_fwd_kernel` via `_fwd`, and
`_bwd_kernel` via `_bwd_rule`).  The plain PyTorch version of the same math
(`reference_nice_decode`, `_mlp_forward`, `_mlp_backward`, transcribed in
the same `pack_nice_weights` order) is the kernels' oracle: the CPU path
runs it, and chip_smoke.py holds the kernels against it on the card.

`fused_nice_decode` on CUDA tensors launches the kernels or raises; on CPU
tensors it runs the plain version.  The launch counters on
`FusedNiceDecode` count kernel launches only, in all and by kind.

Semantics (as in the JAX package):
- the fine decoder sees [c_fine, stop_grad(c_mid)]: its c_mid cotangent
  is dropped (and not computed);
- the colour head's occupancy output is discarded (the stage's occupancy
  is middle + fine): its cotangent is zero;
- weight gradients are computed only for the live decoders: with
  train_weights, decoder d is live when any of its weights requires a
  gradient.  The others get None (the JAX package computes them and the
  caller drops them; the values of the live ones are the same).
"""

from __future__ import annotations

import ctypes
import threading
from typing import List, Sequence, Tuple

import numpy as np
import torch

HID = 32
EMB = 93
DECS = ("middle", "fine", "color")
C_DIMS = {"middle": HID, "fine": 2 * HID, "color": HID}
OUT_DIMS = {"middle": 1, "fine": 1, "color": 4}
LAYER_IN = [EMB, HID, HID, HID + EMB, HID]
N_BLOCKS = 5
SKIP = 2
N_PER_DEC = 1 + 4 * N_BLOCKS + 2  # 23 arrays per decoder


def pack_nice_weights(params) -> Tuple[torch.Tensor, ...]:
    """Flatten middle/fine/colour decoder params into the kernel operand
    order: per decoder [B, W0..W4, b0..b4, V0..V4, a0..a4, Wo, bo]."""
    ws = []
    for name in DECS:
        d = params[name]
        ws.append(d["embed"]["B"])
        ws.extend(d["pts"][i]["w"] for i in range(N_BLOCKS))
        ws.extend(d["pts"][i]["b"].reshape(1, -1) for i in range(N_BLOCKS))
        ws.extend(d["fc_c"][i]["w"] for i in range(N_BLOCKS))
        ws.extend(d["fc_c"][i]["b"].reshape(1, -1) for i in range(N_BLOCKS))
        ws.append(d["out"]["w"])
        ws.append(d["out"]["b"].reshape(1, -1))
    return tuple(ws)


def weight_shapes() -> List[Tuple[int, int]]:
    """Shapes of the 69 arrays of pack_nice_weights, in order."""
    shapes = []
    for name in DECS:
        c, o = C_DIMS[name], OUT_DIMS[name]
        shapes.append((3, EMB))
        shapes.extend((n_in, HID) for n_in in LAYER_IN)
        shapes.extend((1, HID) for _ in range(N_BLOCKS))
        shapes.extend((c, HID) for _ in range(N_BLOCKS))
        shapes.extend((1, HID) for _ in range(N_BLOCKS))
        shapes.append((HID, o))
        shapes.append((1, o))
    return shapes


def _round4(n: int) -> int:
    return (n + 3) // 4 * 4


def weight_offsets() -> Tuple[List[int], int]:
    """Offsets (in floats) of the 69 arrays in the kernels' packed weight
    buffer, where every array starts on a 4-float boundary, and the total
    (the layout of csrc/fused_decode.cu)."""
    offs, o = [], 0
    for r, c in weight_shapes():
        offs.append(o)
        o += _round4(r * c)
    return offs, o


def _unpack(ws, dec_idx):
    base = dec_idx * N_PER_DEC
    return (ws[base], ws[base + 1: base + 6], ws[base + 6: base + 11],
            ws[base + 11: base + 16], ws[base + 16: base + 21],
            ws[base + 21], ws[base + 22])


# ---------------------------------------------------------------------------
# Plain version (CPU path and the kernels' oracle)

def _mlp_forward(p, c, B, W, b, V, a, Wo, bo, save=False):
    """MLP forward (reference decoder.py:177-203) on a batch of points.
    With save=True also returns the intermediates of the backward."""
    e = torch.sin(p @ B)
    x = e
    zs, xs = [], []
    for i in range(N_BLOCKS):
        xs.append(x)
        z = x @ W[i] + b[i]
        h = torch.relu(z) + c @ V[i] + a[i]
        zs.append(z)
        x = torch.cat([e, h], dim=-1) if i == SKIP else h
    out = x @ Wo + bo
    if save:
        return out, (e, xs, zs, x)
    return out


def _mlp_backward(dout, p, c, B, W, b, V, a, Wo, bo, weights=True,
                  dc_cols=None):
    """Hand-derived VJP of _mlp_forward.  Returns (dp, dc, weight grads in
    pack order [dB, dW0..4, db0..4, dV0..4, da0..4, dWo, dbo], or None
    with weights=False).  dc_cols: the cotangent of only the first dc_cols
    feature columns (default all)."""
    pb = p @ B
    _, (e, xs, zs, x_last) = _mlp_forward(p, c, B, W, b, V, a, Wo, bo,
                                          save=True)
    dx = dout @ Wo.T
    de = torch.zeros_like(e)
    dc = torch.zeros_like(c[:, :dc_cols])
    dW, db, dV, da = ([None] * N_BLOCKS for _ in range(4))
    for i in reversed(range(N_BLOCKS)):
        if i == SKIP:
            # x_{i+1} was cat([e, h_i])
            de = de + dx[:, :EMB]
            dh = dx[:, EMB:]
        else:
            dh = dx
        dc = dc + dh @ V[i][:dc_cols].T
        dz = dh * (zs[i] > 0)
        if weights:
            dV[i] = c.T @ dh
            da[i] = torch.sum(dh, dim=0, keepdim=True)
            dW[i] = xs[i].T @ dz
            db[i] = torch.sum(dz, dim=0, keepdim=True)
        dx = dz @ W[i].T
    de = de + dx  # x_0 = e
    dpre = de * torch.cos(pb)
    dp = dpre @ B.T
    if not weights:
        return dp, dc, None
    dB = p.T @ dpre
    dWo = x_last.T @ dout
    dbo = torch.sum(dout, dim=0, keepdim=True)
    return dp, dc, [dB] + dW + db + dV + da + [dWo, dbo]


def reference_nice_decode(with_color, p, c_mid, c_fine, c_color, *weights):
    """The kernels' math in plain PyTorch (the autograd oracle): raw
    (N, 4) = [rgb, occ_mid + occ_fine]."""
    ws = list(weights)
    occ_mid = _mlp_forward(p, c_mid, *_unpack(ws, 0))[:, 0]
    cfull = torch.cat([c_fine, c_mid.detach()], dim=-1)
    occ_fine = _mlp_forward(p, cfull, *_unpack(ws, 1))[:, 0]
    occ = occ_mid + occ_fine
    if with_color:
        rgb = _mlp_forward(p, c_color, *_unpack(ws, 2))[:, :3]
    else:
        rgb = torch.zeros(p.shape[0], 3, dtype=p.dtype, device=p.device)
    return torch.cat([rgb, occ[:, None]], dim=-1)


def plain_nice_decode_bwd(with_color: bool, live: int, p, c_mid, c_fine,
                          c_color, g, weights: Sequence):
    """Plain version of the backward kernel: (dp, dc_mid, dc_fine,
    dc_color, weight grads).  live: bit d set = decoder d (0 middle,
    1 fine, 2 colour) takes weight gradients.  The weight grads are the 69
    arrays of pack order, None for the decoders that are not live (and
    zeros for a live colour decoder in the fine stage, which it does not
    run)."""
    ws = list(weights)
    docc = g[:, 3:4]
    dp, dcm, wg_m = _mlp_backward(docc, p, c_mid, *_unpack(ws, 0),
                                  bool(live & 1))
    cfull = torch.cat([c_fine, c_mid], dim=-1)
    # the stop-gradient c_mid half of the fine input: not computed
    dp_f, dcf, wg_f = _mlp_backward(docc, p, cfull, *_unpack(ws, 1),
                                    bool(live & 2), dc_cols=HID)
    dp = dp + dp_f
    if with_color:
        dout_c = torch.cat([g[:, :3], torch.zeros_like(g[:, :1])], dim=-1)
        dp_c, dcc, wg_c = _mlp_backward(dout_c, p, c_color,
                                        *_unpack(ws, 2), bool(live & 4))
        dp = dp + dp_c
    else:
        dcc = torch.zeros_like(c_mid)
        wg_c = ([torch.zeros_like(w) for w in ws[2 * N_PER_DEC:]]
                if live & 4 else None)
    wgrads = []
    for wg in (wg_m, wg_f, wg_c):
        wgrads += [None] * N_PER_DEC if wg is None else wg
    return dp, dcm, dcf, dcc, wgrads


# ---------------------------------------------------------------------------
# CUDA kernels

_libs = {}


def _kernels():
    """The built forward library with its C signatures declared."""
    if "fwd" not in _libs:
        from nice_slam_torch.ops.cuda_build import load

        lib = load("fused_decode")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.nice_decode_weight_floats.restype = ci
        lib.nice_decode_weight_floats.argtypes = []
        lib.nice_decode_decoder_offset.restype = ci
        lib.nice_decode_decoder_offset.argtypes = [ci]
        lib.nice_decode_image_floats.restype = ci
        lib.nice_decode_image_floats.argtypes = []
        lib.nice_decode_image_offset.restype = ci
        lib.nice_decode_image_offset.argtypes = [ci]
        lib.nice_decode_error_string.restype = ctypes.c_char_p
        lib.nice_decode_error_string.argtypes = [ci]
        pi = ctypes.POINTER(ctypes.c_int)
        lib.nice_fwd_variant_info.restype = ci
        lib.nice_fwd_variant_info.argtypes = [pi, pi, pi]
        lib.nice_decode_fwd.restype = ci
        lib.nice_decode_fwd.argtypes = [vp] * 7 + [ci, ci, vp]
        offs, total = weight_offsets()
        if (lib.nice_decode_weight_floats() != total
                or [lib.nice_decode_decoder_offset(d) for d in range(3)]
                != [offs[d * N_PER_DEC] for d in range(3)]):
            raise RuntimeError("fused_decode_layout.cuh weight layout differs "
                               "from ops/fused_decode.py weight_offsets()")
        img_offs, img_total = image_layout()
        if (lib.nice_decode_image_floats() != img_total
                or [lib.nice_decode_image_offset(d) for d in range(3)]
                != img_offs):
            raise RuntimeError("fused_decode_mma.cuh image layout differs "
                               "from ops/fused_decode.py image_layout()")
        _libs["fwd"] = lib
    return _libs["fwd"]


def _bwd_kernels():
    """The built backward library with its C signatures declared."""
    if "bwd" not in _libs:
        from nice_slam_torch.ops.cuda_build import load

        lib = load("fused_decode_bwd")
        vp, ci, pi = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
        for name in ("nice_bwd_image_floats", "nice_bwd_tile_points"):
            getattr(lib, name).restype = ci
            getattr(lib, name).argtypes = []
        lib.nice_bwd_image_offset.restype = ci
        lib.nice_bwd_image_offset.argtypes = [ci]
        lib.nice_decode_error_string.restype = ctypes.c_char_p
        lib.nice_decode_error_string.argtypes = [ci]
        lib.nice_bwd_variant_info.restype = ci
        lib.nice_bwd_variant_info.argtypes = [ci, ci, pi, pi, pi]
        lib.nice_decode_bwd.restype = ci
        lib.nice_decode_bwd.argtypes = [vp] * 12 + [ci, ci, ci, vp]
        img_offs, img_total = image_layout()
        if (lib.nice_bwd_image_floats() != img_total
                or [lib.nice_bwd_image_offset(d) for d in range(3)]
                != img_offs
                or lib.nice_bwd_tile_points() != BWD_TILE):
            raise RuntimeError("fused_decode_bwd.cu image layout differs "
                               "from ops/fused_decode.py image_layout()")
        _libs["bwd"] = lib
    return _libs["bwd"]


def _check_err(lib, err: int, what: str):
    if err != 0:
        msg = lib.nice_decode_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")


def pack_flat(weights: Sequence[torch.Tensor]) -> torch.Tensor:
    """The 69 weights as the padded fp32 buffer of the packed layout (the
    layout of the backward's weight gradients)."""
    offs, total = weight_offsets()
    flat = torch.zeros(total, dtype=torch.float32, device=weights[0].device)
    for o, w in zip(offs, weights):
        flat[o:o + w.numel()] = w.reshape(-1)
    return flat


def unpack_flat(flat: torch.Tensor) -> List[torch.Tensor]:
    """Views of the 69 arrays inside a padded buffer (the weight grads)."""
    offs, _ = weight_offsets()
    return [flat[o:o + r * c].view(r, c)
            for o, (r, c) in zip(offs, weight_shapes())]


# ---------------------------------------------------------------------------
# The kernels' shared-memory image of each decoder (csrc/fused_decode_mma.cuh,
# struct Img): every 32-wide matrix row-major with a row stride of 40 floats
# and its columns XOR ((row & 4) << 1); the embedding rows of W0 and W3
# padded from 93 to 96 with zeros.

BWD_TILE = 64      # points per block of the backward kernel
_EP, _WS = 96, 40


def _img_fields(c: int) -> dict:
    f = {"B": 0, "W0": 3 * _EP}
    f["W1"] = f["W0"] + _EP * _WS
    f["W2"] = f["W1"] + HID * _WS
    f["W3"] = f["W2"] + HID * _WS
    f["W4"] = f["W3"] + (_EP + HID) * _WS
    f["b"] = f["W4"] + HID * _WS
    f["a"] = f["b"] + N_BLOCKS * HID
    f["Wo"] = f["a"] + N_BLOCKS * HID
    f["bo"] = f["Wo"] + HID * 4
    f["V"] = f["bo"] + 4
    f["size"] = f["V"] + N_BLOCKS * c * _WS
    return f


def image_layout() -> Tuple[List[int], int]:
    """Offsets of the three decoders' images and the total, in floats."""
    offs, o = [], 0
    for name in DECS:
        offs.append(o)
        o += _img_fields(C_DIMS[name])["size"]
    return offs, o


def image_index():
    """int64 numpy index: image[k] = flat[index[k]] gives the kernels'
    weight image of the packed buffer (pack_flat).  Padding reads the
    padding float of the middle decoder's B (3 * 93 = 279 < 280), which
    pack_flat leaves zero."""
    offs, _ = weight_offsets()
    zero = offs[0] + 3 * EMB
    img_offs, total = image_layout()
    idx = np.full(total, zero, dtype=np.int64)
    cols = np.arange(HID)
    for d, name in enumerate(DECS):
        c_dim, o_dim = C_DIMS[name], OUT_DIMS[name]
        f = _img_fields(c_dim)
        base = img_offs[d]
        src = [offs[d * N_PER_DEC + k] for k in range(N_PER_DEC)]

        def put(dst, src_off, rows):
            # rows[r]: the source row of image row r, or -1 for zeros
            for r, sr in enumerate(rows):
                if sr >= 0:
                    idx[base + dst + r * _WS + (cols ^ ((r & 4) << 1))] = (
                        src_off + sr * HID + cols)

        for j in range(3):
            idx[base + j * _EP + np.arange(EMB)] = src[0] + j * EMB + \
                np.arange(EMB)
        emb_rows = list(range(EMB)) + [-1] * (_EP - EMB)
        put(f["W0"], src[1], emb_rows)
        put(f["W1"], src[2], range(HID))
        put(f["W2"], src[3], range(HID))
        put(f["W3"], src[4], emb_rows + list(range(EMB, EMB + HID)))
        put(f["W4"], src[5], range(HID))
        for i in range(N_BLOCKS):
            idx[base + f["b"] + i * HID + cols] = src[6 + i] + cols
            put(f["V"] + i * c_dim * _WS, src[11 + i], range(c_dim))
            idx[base + f["a"] + i * HID + cols] = src[16 + i] + cols
        for k in range(HID):
            idx[base + f["Wo"] + 4 * k + np.arange(o_dim)] = (
                src[21] + k * o_dim + np.arange(o_dim))
        idx[base + f["bo"] + np.arange(o_dim)] = src[22] + np.arange(o_dim)
    return idx


def _weights_image_index():
    """image_index over the 69 weights flattened and concatenated, with one
    zero appended (the padding's slot), instead of the packed buffer."""
    offs, total = weight_offsets()
    shapes = weight_shapes()
    n_cat = sum(r * c for r, c in shapes)
    flat_to_cat = np.full(total, n_cat, dtype=np.int64)
    o_cat = 0
    for o, (r, c) in zip(offs, shapes):
        flat_to_cat[o:o + r * c] = np.arange(o_cat, o_cat + r * c)
        o_cat += r * c
    return flat_to_cat[image_index()]


_img_index = {}


def build_image(weights: Sequence[torch.Tensor]) -> torch.Tensor:
    """The kernels' weight image of the 69 weights (any memory layout): one
    concatenation of the flattened weights and a cached zero, then one
    gather by a cached index."""
    dev = weights[0].device
    key = str(dev)
    if key not in _img_index:
        _img_index[key] = (
            torch.from_numpy(_weights_image_index()).to(dev),
            torch.zeros(1, dtype=torch.float32, device=dev))
    idx, zero = _img_index[key]
    return torch.cat([w.reshape(-1) for w in weights] + [zero])[idx]


def _check_cuda_inputs(p, c_mid, c_fine, c_color, weights):
    dev = p.device
    n = p.shape[0]
    named = [("p", p, (n, 3)), ("c_mid", c_mid, (n, HID)),
             ("c_fine", c_fine, (n, HID)), ("c_color", c_color, (n, HID))]
    named += [(f"weights[{k}]", w, s)
              for k, (w, s) in enumerate(zip(weights, weight_shapes()))]
    if len(weights) != 3 * N_PER_DEC:
        raise ValueError(f"expected {3 * N_PER_DEC} weights, got "
                         f"{len(weights)}")
    for k, (name, t, shape) in enumerate(named):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, p on {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        # the weights are gathered into the image in any layout
        if k < 4 and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t, _ in named[1:4]:
        if t.data_ptr() % 16 != 0:
            raise ValueError(f"{name} must be 16-byte aligned")


def _fwd_prepare(with_color, p, c_mid, c_fine, c_color, img):
    """K1's C arguments with its output allocated: (args, out, scratch)."""
    n = p.shape[0]
    f32 = dict(dtype=torch.float32, device=p.device)
    out = torch.empty(n, 4, **f32)
    occ_part = torch.empty(2, n, **f32)
    stream = torch.cuda.current_stream(p.device).cuda_stream
    args = (p.data_ptr(), c_mid.data_ptr(), c_fine.data_ptr(),
            c_color.data_ptr(), img.data_ptr(), occ_part.data_ptr(),
            out.data_ptr(), n, int(with_color), stream)
    # scratch: the buffer that args point to besides out; keep it while
    # args are used again (a timing loop)
    return args, out, occ_part


def _launch_fwd(with_color, p, c_mid, c_fine, c_color, img):
    """K1: raw (N, 4) from the weight image, launched on p's device (the
    C entry launches on the current device)."""
    lib = _kernels()
    with torch.cuda.device(p.device):
        args, out, _ = _fwd_prepare(with_color, p, c_mid, c_fine, c_color,
                                    img)
        _check_err(lib, lib.nice_decode_fwd(*args),
                   "fused decode forward kernel")
    return out


def fwd_variant_info() -> dict:
    """Registers, spill bytes a thread and resident blocks per SM of the
    forward kernel, from the CUDA runtime."""
    lib = _kernels()
    vals = [ctypes.c_int(0) for _ in range(3)]
    err = lib.nice_fwd_variant_info(*[ctypes.byref(v) for v in vals])
    _check_err(lib, err, "forward kernel attributes")
    return {"registers": vals[0].value, "local_bytes": vals[1].value,
            "blocks_per_sm": vals[2].value}


def _decoder_sizes() -> List[int]:
    offs, total = weight_offsets()
    starts = [offs[d * N_PER_DEC] for d in range(3)] + [total]
    return [starts[d + 1] - starts[d] for d in range(3)]


def _bwd_prepare(with_color, live, p, c_mid, c_fine, c_color, g, img):
    """K2's C arguments with its outputs allocated: (args, (dp_part,
    dc_mid, dc_fine, dc_color (None in the fine stage), packed weight
    gradients (valid in the live decoders' sections) or None), scratch)."""
    n = p.shape[0]
    dev = p.device
    n_dec = 3 if with_color else 2
    live &= (1 << n_dec) - 1
    f32 = dict(dtype=torch.float32, device=dev)
    dp_part = torch.empty(n_dec, n, 3, **f32)
    dcm = torch.empty(n, HID, **f32)
    dcf = torch.empty(n, HID, **f32)
    dcc = torch.empty(n, HID, **f32) if with_color else None
    if live:
        tiles = -(-n // BWD_TILE)
        sizes = _decoder_sizes()
        cols = sum(sizes[d] for d in range(n_dec) if live >> d & 1)
        partial = torch.empty(tiles * cols, **f32)
        # the kernel writes the live sections; with no points, nothing runs
        wgrad = (torch.empty if n else torch.zeros)(weight_offsets()[1],
                                                    **f32)
        pptr, wptr = partial.data_ptr(), wgrad.data_ptr()
    else:
        partial = wgrad = None
        pptr = wptr = None
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (p.data_ptr(), c_mid.data_ptr(), c_fine.data_ptr(),
            c_color.data_ptr(), g.data_ptr(), img.data_ptr(),
            dp_part.data_ptr(), dcm.data_ptr(), dcf.data_ptr(),
            dcc.data_ptr() if with_color else None, pptr, wptr, n,
            int(with_color), live, stream)
    # the third item holds the scratch buffer that args point to: keep it
    # while args are used again (a timing loop)
    return args, (dp_part, dcm, dcf, dcc, wgrad), partial


def _launch_bwd(with_color, live, p, c_mid, c_fine, c_color, g, img):
    """K2, launched on p's device.  Returns (dp, dc_mid, dc_fine, dc_color
    (None in the fine stage), packed weight gradients (valid in the live
    decoders' sections) or None)."""
    lib = _bwd_kernels()
    with torch.cuda.device(p.device):
        args, (dp_part, dcm, dcf, dcc, wgrad), _ = _bwd_prepare(
            with_color, live, p, c_mid, c_fine, c_color, g, img)
        _check_err(lib, lib.nice_decode_bwd(*args),
                   "fused decode backward kernel")
        return dp_part.sum(0), dcm, dcf, dcc, wgrad


def bwd_variant_info(live: bool, dec: int) -> dict:
    """Registers, spill bytes a thread and resident blocks per SM of the
    backward kernel for decoder `dec` with (live) or without weight
    gradients, from the CUDA runtime."""
    lib = _bwd_kernels()
    vals = [ctypes.c_int(0) for _ in range(3)]
    err = lib.nice_bwd_variant_info(int(live), dec,
                                    *[ctypes.byref(v) for v in vals])
    _check_err(lib, err, "backward kernel attributes")
    return {"registers": vals[0].value, "local_bytes": vals[1].value,
            "blocks_per_sm": vals[2].value}


def _live_mask(ctx) -> int:
    """Decoder d is live when weight gradients are asked for and any of its
    23 weights needs one."""
    if not ctx.train_weights:
        return 0
    need = ctx.needs_input_grad[6:]
    return sum(1 << d for d in range(3)
               if any(need[d * N_PER_DEC:(d + 1) * N_PER_DEC]))


class FusedNiceDecode(torch.autograd.Function):
    """raw (N, 4) = [rgb, occ_mid + occ_fine] with the hand VJP.

    `fwd_launches` / `bwd_launches` count launches of the forward and
    backward kernels (the forward's occupancy sum and the backward's
    weight-gradient reduction belong to their launch); `fwd_kinds` splits
    the forward's by stage and points, `bwd_kinds` the backward's by stage,
    weight gradients and points.  They change under a lock: the pipelined
    engine launches from its tracker's and its mapper's threads, and the
    backward runs on the autograd engine's device thread."""

    fwd_launches = 0
    bwd_launches = 0
    fwd_kinds: dict = {}
    bwd_kinds: dict = {}
    count_lock = threading.Lock()

    @staticmethod
    def _count(direction: str, kind: str) -> None:
        """One more launch of K1 ('fwd') or K2 ('bwd') of `kind`."""
        cls = FusedNiceDecode
        with cls.count_lock:
            setattr(cls, f"{direction}_launches",
                    getattr(cls, f"{direction}_launches") + 1)
            kinds = getattr(cls, f"{direction}_kinds")
            kinds[kind] = kinds.get(kind, 0) + 1

    @staticmethod
    def forward(ctx, with_color: bool, train_weights: bool, p, c_mid, c_fine,
                c_color, *weights):
        ctx.with_color = with_color
        ctx.train_weights = train_weights
        if p.is_cuda:
            _check_cuda_inputs(p, c_mid, c_fine, c_color, weights)
            img = build_image(weights)
            out = _launch_fwd(with_color, p, c_mid, c_fine, c_color, img)
            FusedNiceDecode._count(
                "fwd", f"{'color' if with_color else 'fine'} n={p.shape[0]}")
            ctx.save_for_backward(p, c_mid, c_fine, c_color, img)
            return out
        for t in (c_mid, c_fine, c_color) + tuple(weights):
            if t.is_cuda:
                raise ValueError("fused_nice_decode: mixed CPU/CUDA inputs")
        ctx.save_for_backward(p, c_mid, c_fine, c_color, *weights)
        return reference_nice_decode(with_color, p, c_mid, c_fine, c_color,
                                     *weights)

    @staticmethod
    def backward(ctx, g):
        with_color = ctx.with_color
        live = _live_mask(ctx)
        saved = ctx.saved_tensors
        p, c_mid, c_fine, c_color = saved[:4]
        g = g.contiguous()
        if p.is_cuda:
            if (g.dtype != torch.float32 or g.device != p.device
                    or tuple(g.shape) != (p.shape[0], 4)
                    or g.data_ptr() % 16 != 0):
                raise ValueError("fused_nice_decode: bad output cotangent "
                                 f"{g.dtype} {tuple(g.shape)} on {g.device}")
            dp, dcm, dcf, dcc, wflat = _launch_bwd(
                with_color, live, p, c_mid, c_fine, c_color, g, saved[4])
            ran = live & (7 if with_color else 3)
            FusedNiceDecode._count(
                "bwd", f"{'color' if with_color else 'fine'} "
                f"{'wgrad' if ran else 'no-wgrad'} n={p.shape[0]}")
            views = unpack_flat(wflat) if ran else None
            wgrads = []
            for d in range(3):
                sl = slice(d * N_PER_DEC, (d + 1) * N_PER_DEC)
                if not live >> d & 1:
                    wgrads += [None] * N_PER_DEC
                elif ran >> d & 1:
                    wgrads += views[sl]
                else:   # a live colour decoder in the fine stage
                    wgrads += [p.new_zeros(r, c)
                               for r, c in weight_shapes()[sl]]
        else:
            dp, dcm, dcf, dcc, wgrads = plain_nice_decode_bwd(
                with_color, live, p, c_mid, c_fine, c_color, g, saved[4:])
        return (None, None, dp, dcm, dcf, dcc if with_color else None,
                *wgrads)


def fused_nice_decode(with_color: bool, train_weights: bool, p, c_mid,
                      c_fine, c_color, *weights) -> torch.Tensor:
    """Fused colour/fine-stage decode: raw (N, 4) = [rgb, occ_mid+occ_fine].

    weights: pack_nice_weights(params) order.  with_color=False computes
    the 'fine' stage (rgb zeros; c_color is not read).  train_weights=False
    returns no decoder weight gradients; with True, only the decoders whose
    weights require a gradient get one."""
    return FusedNiceDecode.apply(with_color, train_weights, p, c_mid, c_fine,
                                 c_color, *weights)


def reset_launch_counts() -> None:
    with FusedNiceDecode.count_lock:
        FusedNiceDecode.fwd_launches = 0
        FusedNiceDecode.bwd_launches = 0
        FusedNiceDecode.fwd_kinds = {}
        FusedNiceDecode.bwd_kinds = {}


def launch_counts() -> dict:
    with FusedNiceDecode.count_lock:
        return {"fused_decode_fwd": FusedNiceDecode.fwd_launches,
                "fused_decode_bwd": FusedNiceDecode.bwd_launches}


def fwd_launch_kinds() -> dict:
    """Forward launches by 'stage n=points'."""
    with FusedNiceDecode.count_lock:
        return dict(FusedNiceDecode.fwd_kinds)


def bwd_launch_kinds() -> dict:
    """Backward launches by 'stage wgrad|no-wgrad n=points'."""
    with FusedNiceDecode.count_lock:
        return dict(FusedNiceDecode.bwd_kinds)
