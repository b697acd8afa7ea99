"""Carry decoder parameters and feature grids between the JAX package and
the port.

Both packages keep the same tree layout (nested dicts and lists of
arrays; grids `[Nx, Ny, Nz, C]`), so the conversion is leafwise: the
JAX side hands over numpy arrays (e.g. `jax.tree.map(np.asarray, tree)`)
and receives numpy arrays back.  The tests use this to give both packages
the same weights and the same map.
"""

from __future__ import annotations

import numpy as np
import torch

from nice_slam_torch.ops.tree import tree_map


def params_from_jax(tree, device="cuda"):
    """Nested dicts/lists of numpy arrays -> the same tree of fp32 torch
    tensors on `device`."""
    return tree_map(lambda a: torch.from_numpy(
        np.array(a, dtype=np.float32, order="C")).to(device), tree)


def params_to_numpy(tree):
    """Tree of torch tensors -> the same tree of numpy arrays."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)
