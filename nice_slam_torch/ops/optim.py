"""Adam over parameter trees with per-leaf learning rates.

The reference drives torch.optim.Adam param groups whose LRs are re-set
per stage (src/Mapper.py:365-419) and a fresh Adam per camera
(src/Tracker.py:212-219).  Here, as in the JAX package, the learning rate
is itself a tree (a scalar or a per-element tensor per leaf), so stage
schedules and per-slot BA rates are just different lr trees.  One step
counter is shared by the whole tree.  Hyperparameters are
torch.optim.Adam's defaults (b1=0.9, b2=0.999, eps=1e-8, bias
correction).

The bias corrections are multiplied in as float32 reciprocals: 1 / (1 -
b**step) in double, rounded once to float32, the factor CUDA's division of
a float32 tensor by a host scalar multiplies by (PyTorch 2.11;
`tests/test_torch_kernels.py` holds the two equal on the card), so a run
on the card is bit-equal to one that divides.  `adam_update`
takes them as Python numbers of its step; `adam_step_` (the tracking and
mapping loops, which CUDA graphs replay) reads them from a device table
(`bias_tables`) at a device step counter, and updates the parameters and
moments in place, with the same expressions.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from nice_slam_torch.ops.tree import tree_map


class AdamState(NamedTuple):
    m: Any
    v: Any
    step: int


def adam_init(params) -> AdamState:
    return AdamState(m=tree_map(torch.zeros_like, params),
                     v=tree_map(torch.zeros_like, params), step=0)


def inv_bias(b: float, step: int) -> np.float32:
    """1 / (1 - b**step), in double, rounded to float32: the factor that
    CUDA's division of a float32 tensor by the host scalar 1 - b**step
    multiplies by."""
    return np.float32(1.0 / (1.0 - b ** step))


def bias_tables(n: int, device, b1: float = 0.9, b2: float = 0.999):
    """(2, n + 1) float32 on `device`: row r holds inv_bias(b_r, k) at
    column k = 1..n (column 0, before the first step, holds 1)."""
    tab = np.ones((2, n + 1), np.float32)
    for k in range(1, n + 1):
        tab[0, k] = inv_bias(b1, k)
        tab[1, k] = inv_bias(b2, k)
    return torch.from_numpy(tab).to(device)


@torch.no_grad()
def adam_update(params, grads, state: AdamState, lr, b1: float = 0.9,
                b2: float = 0.999, eps: float = 1e-8, frozen=None):
    """One Adam step.  `lr` is a tree matching `params` or a scalar.
    `frozen` is an optional tree of Python bools: frozen leaves keep their
    params and moments untouched (their grads may be None).  Returns
    (new_params, new_state)."""
    step = state.step + 1
    inv1 = float(inv_bias(b1, step))
    inv2 = float(inv_bias(b2, step))
    if not isinstance(lr, (dict, list, tuple)):
        lr = tree_map(lambda _: lr, params)
    if frozen is None:
        frozen = tree_map(lambda _: False, params)

    def upd_m(m, g, f):
        return m if f else b1 * m + (1 - b1) * g

    def upd_v(v, g, f):
        return v if f else b2 * v + (1 - b2) * g * g

    new_m = tree_map(upd_m, state.m, grads, frozen)
    new_v = tree_map(upd_v, state.v, grads, frozen)

    def upd(p, m, v, l, f):
        if f:
            return p
        return p - l * (m * inv1) / (torch.sqrt(v * inv2) + eps)

    new_params = tree_map(upd, params, new_m, new_v, lr, frozen)
    return new_params, AdamState(m=new_m, v=new_v, step=step)


@torch.no_grad()
def adam_step_(params, grads, m, v, step: torch.Tensor, tables: torch.Tensor,
               lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
               frozen=None) -> None:
    """`adam_update` in place: `params`, the moments `m` and `v` (trees
    of the same structure) and the int64 step counter `step` (0-dim) are
    updated where they are, the bias corrections read from `tables`
    (`bias_tables`) at the new step.  No host value changes between
    calls, so a CUDA graph of the call replays every step."""
    step.add_(1)
    inv = tables.index_select(1, step.view(1))
    inv1, inv2 = inv[0, 0], inv[1, 0]
    if not isinstance(lr, (dict, list, tuple)):
        lr = tree_map(lambda _: lr, params)
    if frozen is None:
        frozen = tree_map(lambda _: False, params)

    def upd(p, m_, v_, g, l, f):
        if f:
            return
        torch.add(b1 * m_, (1 - b1) * g, out=m_)
        torch.add(b2 * v_, (1 - b2) * g * g, out=v_)
        torch.sub(p, l * (m_ * inv1) / (torch.sqrt(v_ * inv2) + eps), out=p)

    tree_map(upd, params, m, v, grads, lr, frozen)
