"""Checkpoint save/load with resume, in the JAX package's file format.

A checkpoint is a flat .npz archive (np.savez_compressed) of the whole
engine state, with the same keys and dtypes as the JAX package writes,
so a checkpoint from either package resumes in the other:

    params/<path>, grids/<name>     fp32 decoder weights and feature grids
    bound, est_c2w, gt_c2w          fp32
    keyframes/{colors, depths, est_c2w, gt_c2w, frame_idx, count}
                                    uint8 / fp32 / fp32 / fp32 / int32 /
                                    0-d int32
    idx                             frames done
    extra/<name>                    kf_frame_ids, selkf_event_idx,
                                    selkf_frames (int64)

<path> joins dict keys (sorted) and list indices with '/'.  An
occupancy-guided run's file also holds grids/occ_proxy ((Nx, Ny, Nz, 1)
fp32, as the JAX package writes it).  On load the file's grids must be
the template's: a proxy the engine would not keep, or one it lacks,
raises (a resume that dropped or invented the proxy would give another
result).
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _flatten(tree: Any, prefix: str, out: Dict[str, np.ndarray]):
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], f"{prefix}/{k}", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}/{i}", out)
    else:
        out[prefix] = _to_numpy(tree)


def _unflatten(flat: Dict[str, np.ndarray], template: Any, prefix: str):
    if isinstance(template, dict):
        return {k: _unflatten(flat, template[k], f"{prefix}/{k}")
                for k in sorted(template)}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(flat, v, f"{prefix}/{i}")
                              for i, v in enumerate(template))
    return flat[prefix]


def store_arrays(store) -> Dict[str, np.ndarray]:
    """A keyframe store as the JAX package's arrays: frame_idx int32 and
    count a 0-d int32 (the port keeps int64 and a Python int)."""
    return {"colors": _to_numpy(store.colors),
            "depths": _to_numpy(store.depths),
            "est_c2w": _to_numpy(store.est_c2w),
            "gt_c2w": _to_numpy(store.gt_c2w),
            "frame_idx": _to_numpy(store.frame_idx).astype(np.int32),
            "count": np.asarray(int(store.count), np.int32)}


def save_checkpoint(path: str, params, grids, bound, est_c2w, gt_c2w,
                    keyframe_store, idx: int,
                    extra: Dict[str, Any] = None) -> None:
    flat: Dict[str, np.ndarray] = {}
    _flatten(params, "params", flat)
    _flatten(grids, "grids", flat)
    flat["bound"] = _to_numpy(bound)
    flat["est_c2w"] = _to_numpy(est_c2w)
    flat["gt_c2w"] = _to_numpy(gt_c2w)
    if keyframe_store is not None:
        _flatten(store_arrays(keyframe_store), "keyframes", flat)
    flat["idx"] = np.asarray(idx)
    for k, v in (extra or {}).items():
        flat[f"extra/{k}"] = np.asarray(v)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, **flat)


def load_checkpoint(path: str, params_template, grids_template):
    """A dict of numpy arrays: bound, est_c2w, gt_c2w, idx (int), params
    and grids (trees shaped like the templates), keyframes (by field) and
    extra."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    names = {k[len("grids/"):] for k in flat if k.startswith("grids/")}
    if names != set(grids_template):
        raise ValueError(
            f"{path}: the checkpoint's grids {sorted(names)} are not the "
            f"engine's {sorted(grids_template)} (an occupancy-guided run's "
            "grids/occ_proxy resumes only with rendering.occupancy_guided "
            "on, and needs it)")
    return {
        "bound": flat["bound"],
        "est_c2w": flat["est_c2w"],
        "gt_c2w": flat["gt_c2w"],
        "idx": int(flat["idx"]),
        "params": _unflatten(flat, params_template, "params"),
        "grids": _unflatten(flat, grids_template, "grids"),
        "keyframes": {k[len("keyframes/"):]: v for k, v in flat.items()
                      if k.startswith("keyframes/")},
        "extra": {k[len("extra/"):]: v for k, v in flat.items()
                  if k.startswith("extra/")},
    }


def latest_checkpoint(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return None
    cands = sorted(f for f in os.listdir(ckpt_dir) if f.endswith(".npz"))
    return os.path.join(ckpt_dir, cands[-1]) if cands else None
