"""The SLAM map state: feature grids + decoder params.

Grids are [Nx, Ny, Nz, C] fp32 tensors (channels last, the JAX package's
layout); the decoder params are the nested dicts of models/decoders.py.
iMAP* keeps no grids.  An occupancy-guided NICE run also keeps the
occupancy proxy `occ_proxy` among the grids: never trained, refreshed by
each mapping event (mapping.refresh_occ_proxy).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch

from nice_slam_torch.models.decoders import ModelSpec, init_model
from nice_slam_torch.ops.grid import grid_shape_for_bound


def pad_bound(bound, bound_divisible: float):
    """Enlarge the AABB max so each side is divisible by `bound_divisible`
    (reference src/NICE_SLAM.py:147-150: int()+1 padding)."""
    b = np.array(bound, dtype=np.float64).copy()
    b[:, 1] = (((b[:, 1] - b[:, 0]) / bound_divisible).astype(int) + 1) \
        * bound_divisible + b[:, 0]
    return b


GRID_INIT_STD = {"coarse": 0.01, "middle": 0.01, "fine": 0.0001,
                 "color": 0.01}


def init_grids(gen: Optional[torch.Generator], bound, grid_len, c_dim: int,
               coarse: bool, coarse_bound_enlarge: int = 2, device="cuda"):
    """Allocate the hierarchical grids, N(0, std) init with the reference's
    per-level stds (src/NICE_SLAM.py:223-247)."""
    grids = {}
    names = (["coarse"] if coarse else []) + ["middle", "fine", "color"]
    for name in names:
        enlarge = coarse_bound_enlarge if name == "coarse" else 1
        nx, ny, nz = grid_shape_for_bound(bound, grid_len[name], enlarge)
        grids[name] = torch.randn(nx, ny, nz, c_dim, generator=gen,
                                  device=device) * GRID_INIT_STD[name]
    return grids


@dataclass
class MapState:
    params: Any                    # decoder params tree
    grids: Dict[str, torch.Tensor]
    bound: torch.Tensor            # (3, 2) fp32


def make_map_state(gen: Optional[torch.Generator], spec: ModelSpec, bound,
                   grid_len, bound_divisible: float, occ_guided: bool = False,
                   device="cuda"):
    bound = pad_bound(bound, bound_divisible)
    grids = (init_grids(gen, bound, grid_len, spec.c_dim, spec.coarse,
                        spec.coarse_bound_enlarge, device) if spec.nice
             else {})
    if occ_guided and spec.nice:
        # the occupancy proxy of occupancy-guided sampling (render.py) at
        # the middle grid's resolution, all ones (uniform sampling until
        # the first mapping event refreshes it; nice_slam_tpu/state.py:61-72)
        nx, ny, nz = grid_shape_for_bound(bound, grid_len["middle"], 1)
        grids["occ_proxy"] = torch.ones(nx, ny, nz, 1, device=device)
    params = init_model(gen, spec, device)
    return MapState(params=params, grids=grids,
                    bound=torch.as_tensor(bound, dtype=torch.float32,
                                          device=device))
