"""Pretrained decoder loading: the repository's own npz of the flattened
decoder parameter tree (`params/<decoder>/<field>/<index>/<leaf>` keys,
written by tools/pretrain_decoders.py), read with numpy."""

from __future__ import annotations

import numpy as np
import torch


def load_npz_decoders(path: str, params_template: dict) -> dict:
    """Fill `params_template` from the npz at `path`.  Keys missing from the
    file, or of another shape, keep their template values."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}

    def fill(template, prefix):
        if isinstance(template, dict):
            return {k: fill(v, f"{prefix}/{k}") for k, v in template.items()}
        if isinstance(template, (list, tuple)):
            return type(template)(fill(v, f"{prefix}/{i}")
                                  for i, v in enumerate(template))
        arr = flat.get(prefix)
        if arr is not None and arr.shape == tuple(template.shape):
            return torch.as_tensor(np.ascontiguousarray(arr, np.float32)).to(
                template.device)
        return template

    return fill(params_template, "params")
