"""Fused NICE decode: the middle + fine + colour MLPs of the fine and colour
stages, forward and backward, as one hand-written CUDA kernel per
direction (nice_slam_torch/csrc/fused_decode.cu).

This is the port of the JAX package's Pallas kernels
(nice_slam_tpu/ops/pallas/fused_decode.py: `_fwd_kernel` via `_fwd`, and
`_bwd_kernel` via `_bwd_rule`).  The plain PyTorch version of the same math
(`reference_nice_decode`, `_mlp_forward`, `_mlp_backward`, transcribed in
the same `pack_nice_weights` order) is the kernels' oracle: the CPU path
runs it, and chip_smoke.py holds the kernels against it on the card.

`fused_nice_decode` on CUDA tensors launches the kernels or raises; on CPU
tensors it runs the plain version.  The two launch counters on
`FusedNiceDecode` count kernel launches only.

Semantics (as in the JAX package):
- the fine decoder sees [c_fine, stop_grad(c_mid)]: its c_mid cotangent
  is dropped;
- the colour head's occupancy output is discarded (the stage's occupancy
  is middle + fine): its cotangent is zero;
- train_weights=False returns no weight gradients (frozen decoders), and
  the kernel skips that work.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

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


def _mlp_backward(dout, p, c, B, W, b, V, a, Wo, bo, weights=True):
    """Hand-derived VJP of _mlp_forward.  Returns (dp, dc, weight grads in
    pack order [dB, dW0..4, db0..4, dV0..4, da0..4, dWo, dbo], or None
    with weights=False)."""
    pb = p @ B
    _, (e, xs, zs, x_last) = _mlp_forward(p, c, B, W, b, V, a, Wo, bo,
                                          save=True)
    dx = dout @ Wo.T
    de = torch.zeros_like(e)
    dc = torch.zeros_like(c)
    dW, db, dV, da = ([None] * N_BLOCKS for _ in range(4))
    for i in reversed(range(N_BLOCKS)):
        if i == SKIP:
            # x_{i+1} was cat([e, h_i])
            de = de + dx[:, :EMB]
            dh = dx[:, EMB:]
        else:
            dh = dx
        dc = dc + dh @ V[i].T
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


def plain_nice_decode_bwd(with_color: bool, train_weights: bool, p, c_mid,
                          c_fine, c_color, g, weights: Sequence):
    """Plain version of the backward kernel: (dp, dc_mid, dc_fine,
    dc_color, weight grads (69) or None)."""
    ws = list(weights)
    tw = train_weights
    docc = g[:, 3:4]
    dp_m, dcm, wg_m = _mlp_backward(docc, p, c_mid, *_unpack(ws, 0), tw)
    cfull = torch.cat([c_fine, c_mid], dim=-1)
    dp_f, dcfull, wg_f = _mlp_backward(docc, p, cfull, *_unpack(ws, 1), tw)
    dcf = dcfull[:, :HID]  # the stop-gradient c_mid half is dropped
    dp = dp_m + dp_f
    if with_color:
        dout_c = torch.cat([g[:, :3], torch.zeros_like(g[:, :1])], dim=-1)
        dp_c, dcc, wg_c = _mlp_backward(dout_c, p, c_color,
                                        *_unpack(ws, 2), tw)
        dp = dp + dp_c
    else:
        dcc = torch.zeros_like(c_mid)
        wg_c = [torch.zeros_like(w) for w in ws[2 * N_PER_DEC:]]
    wgrads = (wg_m + wg_f + wg_c) if tw else None
    return dp, dcm, dcf, dcc, wgrads


# ---------------------------------------------------------------------------
# CUDA kernels

_lib = None


def _kernels():
    """The built kernel library with its C signatures declared."""
    global _lib
    if _lib is None:
        from nice_slam_torch.ops.cuda_build import load

        lib = load("fused_decode")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.nice_decode_weight_floats.restype = ci
        lib.nice_decode_weight_floats.argtypes = []
        lib.nice_decode_tile_points.restype = ci
        lib.nice_decode_tile_points.argtypes = []
        lib.nice_decode_decoder_offset.restype = ci
        lib.nice_decode_decoder_offset.argtypes = [ci]
        lib.nice_decode_error_string.restype = ctypes.c_char_p
        lib.nice_decode_error_string.argtypes = [ci]
        lib.nice_decode_fwd.restype = ci
        lib.nice_decode_fwd.argtypes = [vp] * 6 + [ci, ci, vp]
        lib.nice_decode_bwd.restype = ci
        lib.nice_decode_bwd.argtypes = [vp] * 12 + [ci, ci, ci, vp]
        offs, total = weight_offsets()
        if (lib.nice_decode_weight_floats() != total
                or [lib.nice_decode_decoder_offset(d) for d in range(3)]
                != [offs[d * N_PER_DEC] for d in range(3)]):
            raise RuntimeError("fused_decode.cu weight layout differs from "
                               "ops/fused_decode.py weight_offsets()")
        _lib = lib
    return _lib


def _check_err(lib, err: int, what: str):
    if err != 0:
        msg = lib.nice_decode_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")


def pack_flat(weights: Sequence[torch.Tensor]) -> torch.Tensor:
    """The 69 weights as the kernels' padded fp32 buffer."""
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
        # the weights are copied into the packed buffer in any layout
        if k < 4 and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t, _ in named[1:4]:
        if t.data_ptr() % 16 != 0:
            raise ValueError(f"{name} must be 16-byte aligned")


def _launch_fwd(with_color, p, c_mid, c_fine, c_color, flat):
    lib = _kernels()
    n = p.shape[0]
    out = torch.empty(n, 4, dtype=torch.float32, device=p.device)
    stream = torch.cuda.current_stream(p.device).cuda_stream
    err = lib.nice_decode_fwd(p.data_ptr(), c_mid.data_ptr(),
                              c_fine.data_ptr(), c_color.data_ptr(),
                              flat.data_ptr(), out.data_ptr(), n,
                              int(with_color), stream)
    _check_err(lib, err, "fused decode forward kernel")
    return out


def _launch_bwd(with_color, train_weights, p, c_mid, c_fine, c_color, g,
                flat):
    lib = _kernels()
    n = p.shape[0]
    dev = p.device
    dp = torch.empty(n, 3, dtype=torch.float32, device=dev)
    dcm = torch.empty(n, HID, dtype=torch.float32, device=dev)
    dcf = torch.empty(n, HID, dtype=torch.float32, device=dev)
    dcc = torch.empty(n, HID, dtype=torch.float32, device=dev)
    total = flat.numel()
    if train_weights:
        rows = -(-n // lib.nice_decode_tile_points())
        partial = torch.empty(rows, total, dtype=torch.float32, device=dev)
        wgrad = torch.zeros(total, dtype=torch.float32, device=dev)
        pptr, wptr = partial.data_ptr(), wgrad.data_ptr()
    else:
        wgrad = None
        pptr = wptr = None
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.nice_decode_bwd(p.data_ptr(), c_mid.data_ptr(),
                              c_fine.data_ptr(), c_color.data_ptr(),
                              g.data_ptr(), flat.data_ptr(), dp.data_ptr(),
                              dcm.data_ptr(), dcf.data_ptr(), dcc.data_ptr(),
                              pptr, wptr, n, int(with_color),
                              int(train_weights), stream)
    _check_err(lib, err, "fused decode backward kernel")
    return dp, dcm, dcf, dcc, wgrad


class FusedNiceDecode(torch.autograd.Function):
    """raw (N, 4) = [rgb, occ_mid + occ_fine] with the hand VJP.

    `fwd_launches` / `bwd_launches` count launches of the forward and
    backward kernels (the backward's weight-gradient reduction belongs to
    the backward launch)."""

    fwd_launches = 0
    bwd_launches = 0

    @staticmethod
    def forward(ctx, with_color: bool, train_weights: bool, p, c_mid, c_fine,
                c_color, *weights):
        ctx.with_color = with_color
        ctx.train_weights = train_weights
        if p.is_cuda:
            _check_cuda_inputs(p, c_mid, c_fine, c_color, weights)
            flat = pack_flat(weights)
            out = _launch_fwd(with_color, p, c_mid, c_fine, c_color, flat)
            FusedNiceDecode.fwd_launches += 1
            ctx.save_for_backward(p, c_mid, c_fine, c_color, flat)
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
        train = ctx.train_weights and any(ctx.needs_input_grad[6:])
        saved = ctx.saved_tensors
        p, c_mid, c_fine, c_color = saved[:4]
        g = g.contiguous()
        if p.is_cuda:
            if (g.dtype != torch.float32 or g.device != p.device
                    or tuple(g.shape) != (p.shape[0], 4)
                    or g.data_ptr() % 16 != 0):
                raise ValueError("fused_nice_decode: bad output cotangent "
                                 f"{g.dtype} {tuple(g.shape)} on {g.device}")
            flat = saved[4]
            dp, dcm, dcf, dcc, wflat = _launch_bwd(
                with_color, train, p, c_mid, c_fine, c_color, g, flat)
            FusedNiceDecode.bwd_launches += 1
            wgrads = unpack_flat(wflat) if train else None
        else:
            dp, dcm, dcf, dcc, wgrads = plain_nice_decode_bwd(
                with_color, train, p, c_mid, c_fine, c_color, g, saved[4:])
        if wgrads is None:
            wgrads = [None] * (3 * N_PER_DEC)
        return (None, None, dp, dcm, dcf, dcc if with_color else None,
                *wgrads)


def fused_nice_decode(with_color: bool, train_weights: bool, p, c_mid,
                      c_fine, c_color, *weights) -> torch.Tensor:
    """Fused colour/fine-stage decode: raw (N, 4) = [rgb, occ_mid+occ_fine].

    weights: pack_nice_weights(params) order.  with_color=False computes
    the 'fine' stage (rgb zeros; c_color is not read).  train_weights=False
    returns no decoder weight gradients."""
    return FusedNiceDecode.apply(with_color, train_weights, p, c_mid, c_fine,
                                 c_color, *weights)


def reset_launch_counts() -> None:
    FusedNiceDecode.fwd_launches = 0
    FusedNiceDecode.bwd_launches = 0


def launch_counts() -> dict:
    return {"fused_decode_fwd": FusedNiceDecode.fwd_launches,
            "fused_decode_bwd": FusedNiceDecode.bwd_launches}
