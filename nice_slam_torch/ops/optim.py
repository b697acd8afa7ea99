"""Adam over parameter trees with per-leaf learning rates.

The reference drives torch.optim.Adam param groups whose LRs are re-set
per stage (src/Mapper.py:365-419) and a fresh Adam per camera
(src/Tracker.py:212-219).  Here, as in the JAX package, the learning rate
is itself a tree (a scalar or a per-element tensor per leaf), so stage
schedules and per-slot BA rates are just different lr trees.  One step
counter is shared by the whole tree.  Hyperparameters are
torch.optim.Adam's defaults (b1=0.9, b2=0.999, eps=1e-8, bias
correction).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from nice_slam_torch.ops.tree import tree_map


class AdamState(NamedTuple):
    m: Any
    v: Any
    step: int


def adam_init(params) -> AdamState:
    return AdamState(m=tree_map(torch.zeros_like, params),
                     v=tree_map(torch.zeros_like, params), step=0)


@torch.no_grad()
def adam_update(params, grads, state: AdamState, lr, b1: float = 0.9,
                b2: float = 0.999, eps: float = 1e-8, frozen=None):
    """One Adam step.  `lr` is a tree matching `params` or a scalar.
    `frozen` is an optional tree of Python bools: frozen leaves keep their
    params and moments untouched (their grads may be None).  Returns
    (new_params, new_state)."""
    step = state.step + 1
    bc1 = 1.0 - b1 ** step
    bc2 = 1.0 - b2 ** step
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
        return p - l * (m / bc1) / (torch.sqrt(v / bc2) + eps)

    new_params = tree_map(upd, params, new_m, new_v, lr, frozen)
    return new_params, AdamState(m=new_m, v=new_v, step=step)
