"""Small constant tensors, made once per (values, dtype, device).

`torch.tensor(<list>, device=<card>)` copies from pageable host memory and
then waits for the device, and inside a CUDA-graph capture it is illegal.
The optimiser loops' constants (grid sizes and cell caps, the homogeneous
row) come from here instead: made at their first use, which is outside any
capture (graphs.py runs every signature's first iteration eagerly), and
only read after that."""

from __future__ import annotations

import torch

_cache: dict = {}


def const(values, dtype: torch.dtype, device) -> torch.Tensor:
    """The tensor of `values` (a flat sequence) as `dtype` on `device`.
    Callers must not write to it."""
    key = (tuple(values), dtype, torch.device(device))
    t = _cache.get(key)
    if t is None:
        t = _cache.setdefault(key, torch.tensor(key[0], dtype=dtype,
                                                device=key[2]))
    return t
