"""Pretrain the hierarchical-grid decoders on procedural scenes (the
port of the JAX package's tools/pretrain_decoders.py).

The reference ships ConvONet-pretrained decoders (pretrained/coarse.pt,
middle_fine.pt, loaded at src/NICE_SLAM.py:159-190) and keeps the middle
and fine decoders frozen during SLAM.  This tool reproduces that regime:
the decoders are trained across randomized primitive scenes (spheres and
boxes in a random room), each scene with fresh feature grids, to map grid
features and the point's embedding to calibrated occupancy logits.

Loss per scene: BCE between sigmoid(10 occ) and the analytic
inside/outside field at the middle, fine (middle + fine) and coarse
levels, plus L2 colour regression, through the per-decoder MLPs
(`apply_mlp`, `apply_mlp_no_xyz`, plain fp32, as the JAX tool: no fused
decode).  Adam with the decoder and grid learning rates split.  The npz
keys are the JAX tool's, so either package's `load_npz_decoders` reads
the file.

    python -m nice_slam_torch.tools.pretrain_decoders --out DIR/dec.npz
    python -m nice_slam_torch.tools.pretrain_decoders --device cpu \\
        --scenes 2 --steps 4 --batch 256 --out DIR/dec.npz

It writes only the file --out names (default
output/pretrain/decoders_torch.npz).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from nice_slam_torch.models.decoders import (
    ModelSpec,
    apply_mlp,
    apply_mlp_no_xyz,
    init_model,
)
from nice_slam_torch.ops.grid import normalize_coords, trilinear_interp
from nice_slam_torch.ops.optim import adam_init, adam_update
from nice_slam_torch.ops.tree import tree_leaves, tree_map
from nice_slam_torch.state import init_grids
from nice_slam_torch.utils.checkpoint import _flatten

# the canonical pretraining volume: an 8 m cube centred at the origin,
# covering the coordinate ranges of the target scene families
BOUND = np.array([[-4.0, 4.0], [-4.0, 4.0], [-4.0, 4.0]])
GRID_LEN = {"coarse": 2.0, "middle": 0.32, "fine": 0.16, "color": 0.16}
N_SPH, N_BOX = 6, 3


def sample_scene(gen, dev):
    """A random primitive scene: sphere centres and radii, box corners and
    sizes and one albedo per primitive (and the wall, the last row),
    inside a random sub-room of the volume."""
    def u(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)

    room_lo, room_hi = u((3,), -4.0, -1.0), u((3,), 1.0, 4.0)
    ctr, rad = u((N_SPH, 3), -3.0, 3.0), u((N_SPH,), 0.2, 0.9)
    blo, bsz = u((N_BOX, 3), -3.5, 2.0), u((N_BOX, 3), 0.3, 1.5)
    alb = u((N_SPH + N_BOX + 1, 3), 0.0, 1.0)
    return {"room_lo": room_lo, "room_hi": room_hi, "ctr": ctr, "rad": rad,
            "blo": blo, "bhi": blo + bsz, "alb": alb}


def field(scene, p):
    """(occupied (N,), albedo (N, 3)) of the analytic scene at p (N, 3)."""
    d_sph = (torch.linalg.norm(p[:, None, :] - scene["ctr"][None], dim=-1)
             - scene["rad"][None])
    in_sph = d_sph < 0.0
    in_box = torch.all((p[:, None, :] > scene["blo"][None])
                       & (p[:, None, :] < scene["bhi"][None]), dim=-1)
    outside = torch.any((p < scene["room_lo"]) | (p > scene["room_hi"]),
                        dim=-1)
    occ = in_sph.any(-1) | in_box.any(-1) | outside
    # albedo of the first primitive the point is in, else the wall's
    ids = torch.cat([in_sph, in_box, outside[:, None]], dim=-1)
    first = torch.argmax(ids.to(torch.int32), dim=-1)
    alb = scene["alb"][torch.where(ids.any(-1), first,
                                   torch.full_like(first, ids.shape[-1] - 1))]
    return occ.to(torch.float32), alb


def bce_logits(logit, target):
    """Numerically stable BCE of sigmoid(logit) against target."""
    return torch.mean(torch.clamp(logit, min=0) - logit * target
                      + torch.log1p(torch.exp(-torch.abs(logit))))


def scene_loss(tree, scene, p, spec, bound):
    dspecs = spec.decoder_specs()
    prm, grids = tree["params"], tree["grids"]
    occ_t, alb_t = field(scene, p)
    p_nor = normalize_coords(p, bound)
    c_mid = trilinear_interp(grids["middle"], p_nor)
    c_fine = torch.cat([trilinear_interp(grids["fine"], p_nor),
                        c_mid.detach()], dim=-1)
    c_col = trilinear_interp(grids["color"], p_nor)
    c_coarse = trilinear_interp(grids["coarse"], normalize_coords(
        p, bound * spec.coarse_bound_enlarge))
    mid = apply_mlp(prm["middle"], dspecs["middle"], p, c_mid)
    fine = apply_mlp(prm["fine"], dspecs["fine"], p, c_fine)
    col = apply_mlp(prm["color"], dspecs["color"], p, c_col)
    coarse = apply_mlp_no_xyz(prm["coarse"], dspecs["coarse"], c_coarse)
    return (bce_logits(10.0 * mid, occ_t)
            + bce_logits(10.0 * (mid + fine), occ_t)
            + bce_logits(10.0 * coarse, occ_t)
            + torch.mean((col[:, :3] - alb_t) ** 2))


def scene_round(params, scene, gen, args, spec, bound, dev):
    """Fresh grids, then args.steps joint grid + decoder Adam steps on the
    scene.  Returns (decoders, last loss on the device)."""
    grids = init_grids(gen, BOUND, GRID_LEN, spec.c_dim, True,
                       spec.coarse_bound_enlarge, device=dev)
    tree = {"params": params, "grids": grids}
    opt = adam_init(tree)
    lr = {"params": tree_map(lambda _: args.decoder_lr, params),
          "grids": tree_map(lambda _: args.grid_lr, grids)}
    lo, hi = bound[:, 0], bound[:, 1]
    loss = None
    for _ in range(args.steps):
        tr = tree_map(lambda x: x.detach().requires_grad_(True), tree)
        p = lo + (hi - lo) * torch.rand(args.batch, 3, generator=gen,
                                        device=dev)
        loss = scene_loss(tr, scene, p, spec, bound)
        gl = iter(torch.autograd.grad(loss, tree_leaves(tr)))
        g = tree_map(lambda _: next(gl), tr)
        tree, opt = adam_update(tree, g, opt, lr)
        loss = loss.detach()
    return tree["params"], loss


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="pretrain the NICE decoders on procedural scenes")
    ap.add_argument("--scenes", type=int, default=300)
    ap.add_argument("--steps", type=int, default=80,
                    help="grid+decoder steps per scene")
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--decoder_lr", type=float, default=1e-3)
    ap.add_argument("--grid_lr", type=float, default=0.03)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join(
        "output", "pretrain", "decoders_torch.npz"))
    ap.add_argument("--report_every", type=int, default=20)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the same "
                         "plain fp32 MLPs)")
    args = ap.parse_args(argv)

    dev = torch.device(args.device)
    spec = ModelSpec()  # nice, coarse, c_dim 32, hidden 32
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_model(gen, spec, device=dev)
    bound = torch.as_tensor(BOUND, dtype=torch.float32, device=dev)
    t0 = time.perf_counter()
    for i in range(args.scenes):
        scene = sample_scene(gen, dev)
        params, loss = scene_round(params, scene, gen, args, spec,
                                   bound, dev)
        if i % args.report_every == 0:
            print(f"scene {i}/{args.scenes}: final loss {float(loss):.4f}",
                  flush=True)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    flat = {}
    _flatten(params, "params", flat)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    np.savez_compressed(args.out, **flat)
    print(f"saved {args.out} ({len(flat)} arrays); "
          f"{args.scenes * args.steps} steps in {wall:.3f} s = "
          f"{1e3 * wall / max(args.scenes * args.steps, 1):.3f} ms/step")
    return args.out


if __name__ == "__main__":
    main()
