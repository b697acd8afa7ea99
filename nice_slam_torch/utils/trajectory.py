"""Trajectory alignment + ATE metrics (host-side numpy).

Equivalent of the reference's src/tools/eval_ate.py evaluation core:
Horn's closed-form SVD alignment (eval_ate.py:44-78) and translational
RMSE/mean/median stats (eval_ate.py:113-223).  Poses with nan/inf GT
(ScanNet) are masked out (eval_ate.py:239-256).
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def horn_align(model: np.ndarray, data: np.ndarray):
    """Align model (N,3) onto data (N,3): find rot, trans minimizing
    ||rot@model + trans - data||.  Returns (rot (3,3), trans (3,),
    per-point translational errors (N,))."""
    model = model.T  # (3, N)
    data = data.T
    mu_m = model.mean(axis=1, keepdims=True)
    mu_d = data.mean(axis=1, keepdims=True)
    mc = model - mu_m
    dc = data - mu_d
    W = mc @ dc.T
    U, _, Vh = np.linalg.svd(W.T)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vh) < 0:
        S[2, 2] = -1
    rot = U @ S @ Vh
    trans = mu_d - rot @ mu_m
    aligned = rot @ model + trans
    err = np.sqrt(np.sum((aligned - data) ** 2, axis=0))
    return rot, trans[:, 0], err


def ate_stats(gt_c2w: np.ndarray, est_c2w: np.ndarray) -> Dict[str, float]:
    """ATE over trajectories (N,4,4).  Units follow the inputs (meters)."""
    gt_t = gt_c2w[:, :3, 3]
    est_t = est_c2w[:, :3, 3]
    valid = np.isfinite(gt_t).all(axis=1) & np.isfinite(est_t).all(axis=1)
    gt_t, est_t = gt_t[valid], est_t[valid]
    _, _, err = horn_align(est_t, gt_t)
    return {
        "rmse": float(np.sqrt(np.mean(err ** 2))),
        "mean": float(np.mean(err)),
        "median": float(np.median(err)),
        "std": float(np.std(err)),
        "min": float(np.min(err)),
        "max": float(np.max(err)),
        "n_pairs": int(valid.sum()),
    }
