"""Hierarchical grid decoders (NICE mode) with the JAX package's parameter
layout: nested dicts of weight tensors, (in_dim, out_dim) weights so a
dense layer is ``x @ w + b``.

- `apply_mlp` (reference decoder.py:91-203): per-point grid feature by
  trilinear interp, Fourier point embedding, 5 dense blocks with additive
  feature injection ``h += fc_c[i](c)`` and a skip concat of the embedding
  after block 2.
- `apply_mlp_no_xyz` (decoder.py:206-274): feature-only input, skip concat
  of the feature after block 2 (the coarse level).
- `model_apply` stage dispatch (decoder.py:312-342): coarse/middle ->
  occupancy only; fine -> middle + fine occupancy; colour -> the colour
  head's rgb with the occupancy of middle + fine.  At the default widths
  (`fused_route`) the fine and colour stages run through the fused decode
  (ops/fused_decode.py), which on the card is the hand-written CUDA kernel
  pair; other widths and embeddings run the same stages as plain
  per-decoder MLPs, as the JAX package does outside its kernel.
- iMAP* (src/conv_onet/config.py:28-32): one MLP `imap`, no grid feature,
  hidden 256, 4 blocks, no skips, rgb + density out, in plain fp32
  `torch.matmul` (no kernel: the TPU package decodes it outside Pallas).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from nice_slam_torch.models.embedding import (
    apply_embedding,
    embedding_dim,
    init_fourier_embedding,
)
from nice_slam_torch.ops.fused_decode import (
    fused_nice_decode,
    pack_nice_weights,
)
from nice_slam_torch.ops.grid import normalize_coords, trilinear_interp


@dataclass(frozen=True)
class DecoderSpec:
    name: str = ""
    c_dim: int = 32
    hidden: int = 32
    n_blocks: int = 5
    skips: Tuple[int, ...] = (2,)
    color: bool = False
    embed: str = "fourier"
    no_xyz: bool = False


@dataclass(frozen=True)
class ModelSpec:
    nice: bool = True
    coarse: bool = True
    c_dim: int = 32
    hidden: int = 32
    pos_embedding_method: str = "fourier"
    coarse_bound_enlarge: int = 2

    def decoder_specs(self):
        if not self.nice:
            return {"imap": DecoderSpec(name="imap", c_dim=0, hidden=256,
                                        n_blocks=4, skips=(), color=True,
                                        embed=self.pos_embedding_method)}
        specs = {
            "middle": DecoderSpec(name="middle", c_dim=self.c_dim,
                                  hidden=self.hidden,
                                  embed=self.pos_embedding_method),
            "fine": DecoderSpec(name="fine", c_dim=self.c_dim * 2,
                                hidden=self.hidden,
                                embed=self.pos_embedding_method),
            "color": DecoderSpec(name="color", c_dim=self.c_dim,
                                 hidden=self.hidden, color=True,
                                 embed=self.pos_embedding_method),
        }
        if self.coarse:
            specs["coarse"] = DecoderSpec(name="coarse", c_dim=self.c_dim,
                                          hidden=self.hidden, no_xyz=True)
        return specs


# ---------------------------------------------------------------------------
# Initialization (the torch inits the reference uses)

def _xavier_uniform(gen, in_dim, out_dim, gain, device):
    a = gain * np.sqrt(6.0 / (in_dim + out_dim))
    u = torch.rand(in_dim, out_dim, generator=gen, device=device)
    return u * (2 * a) - a


def _dense_init(gen, in_dim, out_dim, device, activation="relu"):
    """DenseLayer init: xavier_uniform by activation gain, zero bias
    (reference decoder.py:70-79)."""
    gain = np.sqrt(2.0) if activation == "relu" else 1.0
    return {"w": _xavier_uniform(gen, in_dim, out_dim, gain, device),
            "b": torch.zeros(out_dim, device=device)}


def _torch_linear_init(gen, in_dim, out_dim, device):
    """torch.nn.Linear default init (the reference's fc_c layers)."""
    bound = 1.0 / np.sqrt(in_dim)
    w = torch.rand(in_dim, out_dim, generator=gen, device=device)
    b = torch.rand(out_dim, generator=gen, device=device)
    return {"w": w * (2 * bound) - bound, "b": b * (2 * bound) - bound}


def _calibrate_head(out_params, spec: DecoderSpec):
    """Small head weights and a slightly negative occupancy bias, so that
    sigmoid(10*occ) starts in its responsive range (the JAX package's
    pretrain-free init)."""
    occ_idx = 3 if spec.color else 0
    b = out_params["b"].clone()
    b[occ_idx] = -0.2
    return {"w": out_params["w"] * 0.1, "b": b}


def init_decoder(gen: Optional[torch.Generator], spec: DecoderSpec,
                 device="cuda"):
    h = spec.hidden
    params = {}
    if spec.no_xyz:
        params["pts"] = [
            _dense_init(gen, h + spec.c_dim if (i - 1) in spec.skips else h,
                        h, device)
            for i in range(spec.n_blocks)]
        params["out"] = _calibrate_head(_dense_init(
            gen, h, 4 if spec.color else 1, device, "linear"), spec)
        return params
    emb = embedding_dim(spec.embed, spec.name)
    if spec.embed == "fourier":
        params["embed"] = init_fourier_embedding(gen, device=device)
    elif spec.embed == "fc_relu":
        params["embed"] = _dense_init(gen, 3, emb, device)
    else:
        params["embed"] = {}
    pts = []
    for i in range(spec.n_blocks):
        in_dim = emb if i == 0 else (h + emb if (i - 1) in spec.skips else h)
        pts.append(_dense_init(gen, in_dim, h, device))
    params["pts"] = pts
    if spec.c_dim != 0:
        params["fc_c"] = [_torch_linear_init(gen, spec.c_dim, h, device)
                          for _ in range(spec.n_blocks)]
    params["out"] = _calibrate_head(_dense_init(
        gen, h, 4 if spec.color else 1, device, "linear"), spec)
    return params


def init_model(gen: Optional[torch.Generator], spec: ModelSpec,
               device="cuda"):
    dspecs = spec.decoder_specs()
    return {name: init_decoder(gen, dspecs[name], device)
            for name in sorted(dspecs)}


# ---------------------------------------------------------------------------
# Forward

def _dense(x, layer):
    return x @ layer["w"] + layer["b"]


def apply_mlp(params, spec: DecoderSpec, p: torch.Tensor,
              c: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Coordinate MLP with per-layer injection of the grid feature c
    (N, spec.c_dim), or without a feature (c_dim 0, the iMAP* decoder).

    p: (N, 3) world coords.  Returns (N, 4) if colour else (N,)."""
    e = apply_embedding(params["embed"], p, spec.embed, spec.name)
    h = e
    for i in range(spec.n_blocks):
        h = torch.relu(_dense(h, params["pts"][i]))
        if spec.c_dim != 0:
            h = h + _dense(c, params["fc_c"][i])
        if i in spec.skips:
            h = torch.cat([e, h], dim=-1)
    out = _dense(h, params["out"])
    return out if spec.color else out[..., 0]


def apply_mlp_no_xyz(params, spec: DecoderSpec,
                     c: torch.Tensor) -> torch.Tensor:
    """Feature-only MLP (the coarse level) of the feature c (N, c_dim)."""
    h = c
    for i in range(spec.n_blocks):
        h = torch.relu(_dense(h, params["pts"][i]))
        if i in spec.skips:
            h = torch.cat([c, h], dim=-1)
    out = _dense(h, params["out"])
    return out if spec.color else out[..., 0]


def fused_route(spec: ModelSpec) -> bool:
    """Whether the fine and colour stages run the fused decode: at the
    widths its kernels take (c_dim 32, hidden 32, the Fourier embedding),
    as the JAX package's `_use_fused` decides (nice_slam_tpu/models/
    decoders.py:332-361).  Every other width or embedding runs the unfused
    composition on every device.  A function of the spec alone."""
    return spec.nice and (spec.c_dim, spec.hidden,
                          spec.pos_embedding_method) == (32, 32, "fourier")


def _fused_apply(params, p, c_mid, c_fine, c_color, with_color: bool,
                 train_decoders: bool) -> torch.Tensor:
    """Fine/colour-stage decode: the two or three MLPs and the occupancy sum
    in the fused decode (on the card its kernels)."""
    # the fine stage does not read c_color: pass c_mid in its place
    return fused_nice_decode(with_color, train_decoders, p.contiguous(),
                             c_mid, c_fine,
                             c_color if with_color else c_mid,
                             *pack_nice_weights(params))


def _unfused_apply(params, dspecs, p, c_mid, c_fine, c_color,
                   with_color: bool) -> torch.Tensor:
    """The same stages as plain per-decoder MLPs (JAX model_apply_feats,
    nice_slam_tpu/models/decoders.py:303-328): the fine decoder reads
    [c_fine, stop_grad(c_mid)], occupancy = middle + fine, the colour head
    gives the rgb."""
    c_full = torch.cat([c_fine, c_mid.detach()], dim=-1)
    occ = (apply_mlp(params["fine"], dspecs["fine"], p, c_full)
           + apply_mlp(params["middle"], dspecs["middle"], p, c_mid))
    if not with_color:
        rgb = torch.zeros(p.shape[:-1] + (3,), dtype=p.dtype, device=p.device)
    else:
        rgb = apply_mlp(params["color"], dspecs["color"], p, c_color)[..., :3]
    return torch.cat([rgb, occ[..., None]], dim=-1)


def model_apply_feats(params, spec: ModelSpec, p: torch.Tensor, feats,
                      stage: str = "color",
                      train_decoders: bool = True) -> torch.Tensor:
    """Stage-dispatched NICE forward from the per-point grid features
    `feats` ({level: (N, c_dim)} for the levels the stage reads): (N, 3)
    points -> raw (N, 4) [rgb, occ].  The caller owns the gather, as in
    JAX model_apply_feats (nice_slam_tpu/models/decoders.py:273-328); the
    grid-sharded decode passes features summed over a process group
    (parallel/grid_sharded.py).  The fine and colour stages route by
    `fused_route(spec)`, as `model_apply` does: at the default widths
    through the fused decode (K1/K2 on the card), else the unfused
    composition.  (The JAX package's sharded decode always composes
    unfused: the same function of the same inputs.)"""
    dspecs = spec.decoder_specs()
    zeros3 = torch.zeros(p.shape[:-1] + (3,), dtype=p.dtype, device=p.device)
    if stage == "coarse":
        occ = apply_mlp_no_xyz(params["coarse"], dspecs["coarse"],
                               feats["coarse"])
        return torch.cat([zeros3, occ[..., None]], dim=-1)
    c_mid = feats["middle"]
    if stage == "middle":
        occ = apply_mlp(params["middle"], dspecs["middle"], p, c_mid)
        return torch.cat([zeros3, occ[..., None]], dim=-1)
    if stage not in ("fine", "color"):
        raise ValueError(f"unknown stage {stage}")
    with_color = stage == "color"
    c_color = feats["color"] if with_color else None
    if fused_route(spec):
        return _fused_apply(params, p, c_mid, feats["fine"], c_color,
                            with_color, train_decoders)
    return _unfused_apply(params, dspecs, p, c_mid, feats["fine"], c_color,
                          with_color)


_STAGE_LEVELS = {"coarse": ("coarse",), "middle": ("middle",),
                 "fine": ("middle", "fine"),
                 "color": ("middle", "fine", "color")}


def stage_levels(stage: str):
    """The grid levels whose features a NICE stage reads."""
    if stage not in _STAGE_LEVELS:
        raise ValueError(f"unknown stage {stage}")
    return _STAGE_LEVELS[stage]


def model_apply(params, spec: ModelSpec, grids, bound, p: torch.Tensor,
                stage: str = "color",
                train_decoders: bool = True) -> torch.Tensor:
    """Stage-dispatched forward: (N, 3) points -> raw (N, 4) [rgb, occ]:
    the stage's grid features by `trilinear_interp`, then
    `model_apply_feats` (iMAP*: its one MLP).

    train_decoders=False tells the fused decode that no decoder weight
    gradient is wanted (frozen decoders)."""
    if not spec.nice:
        return apply_mlp(params["imap"], spec.decoder_specs()["imap"], p)
    if stage == "coarse":
        feats = {"coarse": trilinear_interp(grids["coarse"], normalize_coords(
            p, bound * spec.coarse_bound_enlarge))}
    else:
        p_nor = normalize_coords(p, bound)
        feats = {n: trilinear_interp(grids[n], p_nor)
                 for n in stage_levels(stage)}
    return model_apply_feats(params, spec, p, feats, stage, train_decoders)
