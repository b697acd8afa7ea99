"""Pretrained decoders: the repository's own npz of the flattened decoder
tree (`params/<decoder>/<field>/<index>/<leaf>` keys, written by
tools/pretrain_decoders.py and nice_slam_torch/tools/pretrain_decoders.py),
the reference's ConvONet checkpoints, and pretraining from scratch (the
JAX package's models/pretrain.py).

The reference ships coarse.pt and middle_fine.pt and loads them with key
surgery (src/NICE_SLAM.py:159-190): keys holding 'decoder' but not
'encoder' lose their prefixes and go to the coarse / middle / fine
decoders.  `load_pretrained_decoders` does the same surgery and turns the
tensors into the port's parameter trees, Linear weights transposed to
(in, out).  Those files are not distributable with the repository;
`pretrain_decoders_synthetic` trains the middle and fine decoders against
procedural occupancy instead.
"""

from __future__ import annotations

import os
import warnings
from typing import Dict, Optional

import numpy as np
import torch

from nice_slam_torch.models.decoders import DecoderSpec, ModelSpec, model_apply
from nice_slam_torch.ops.optim import adam_init, adam_update
from nice_slam_torch.ops.tree import tree_leaves, tree_map


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


def _torch_state_to_params(state: Dict[str, torch.Tensor],
                           spec: DecoderSpec, device) -> dict:
    """A reference decoder state_dict (MLP / MLP_no_xyz naming,
    decoder.py:91-274) as the port's parameter tree on `device`."""
    def arr(key):
        return state[key].detach().to(device=device, dtype=torch.float32)

    def lin(key):
        return arr(f"{key}.weight").T.contiguous()

    n = spec.n_blocks
    params: dict = {
        "pts": [{"w": lin(f"pts_linears.{i}"),
                 "b": arr(f"pts_linears.{i}.bias")} for i in range(n)],
        "out": {"w": lin("output_linear"), "b": arr("output_linear.bias")},
    }
    if not spec.no_xyz:
        params["embed"] = ({"B": arr("embedder._B").contiguous()}
                           if any(k.startswith("embedder.") for k in state)
                           else {})
        if spec.c_dim != 0:
            params["fc_c"] = [{"w": lin(f"fc_c.{i}"),
                               "b": arr(f"fc_c.{i}.bias")} for i in range(n)]
    return params


def load_pretrained_decoders(params: dict, spec: ModelSpec,
                             coarse_path: Optional[str],
                             middle_fine_path: Optional[str]) -> dict:
    """Overwrite the coarse / middle / fine decoders from reference-format
    checkpoints, on the device of `params`.  A missing file leaves its
    decoders at their init, with a warning."""
    dspecs = spec.decoder_specs()
    device = tree_leaves(params)[0].device
    params = dict(params)

    def load(path):
        return torch.load(path, map_location=device,
                          weights_only=True)["model"]

    if spec.coarse and coarse_path and os.path.exists(coarse_path):
        coarse_state = {key[8:]: val for key, val in load(coarse_path).items()
                        if "decoder" in key and "encoder" not in key}
        params["coarse"] = _torch_state_to_params(
            coarse_state, dspecs["coarse"], device)
    elif spec.coarse:
        warnings.warn(f"coarse pretrain missing ({coarse_path}); "
                      "random init")

    if middle_fine_path and os.path.exists(middle_fine_path):
        mid_state, fine_state = {}, {}
        for key, val in load(middle_fine_path).items():
            if "decoder" in key and "encoder" not in key:
                # the reference's surgery: 'coarse'-tagged keys are the
                # MIDDLE decoder, 'fine' keys the fine one
                # (NICE_SLAM.py:181-188)
                if "coarse" in key:
                    mid_state[key[8 + 7:]] = val
                elif "fine" in key:
                    fine_state[key[8 + 5:]] = val
        params["middle"] = _torch_state_to_params(mid_state, dspecs["middle"],
                                                  device)
        params["fine"] = _torch_state_to_params(fine_state, dspecs["fine"],
                                                device)
    else:
        warnings.warn(f"middle_fine pretrain missing ({middle_fine_path}); "
                      "random init — consider mapping.fix_fine=False")
    return params


# ---------------------------------------------------------------------------
# Pretraining from scratch

PRETRAIN_GRID_LEN = {"coarse": 2.0, "middle": 0.32, "fine": 0.16,
                     "color": 0.16}


def occ_target(p, centers, radii):
    """Signed logit-like occupancy of a union of spheres: -10 times the
    distance to the nearest sphere's surface."""
    d = torch.linalg.norm(p[:, None, :] - centers[None], dim=-1) - radii
    return -10.0 * torch.amin(d, dim=-1)


def pretrain_frozen(tree) -> dict:
    """The frozen tree of pretraining: only the middle and fine decoders and
    grids train (the fine stage reads nothing else, so the others' Adam
    step is zero in the JAX package too)."""
    live = ("middle", "fine")
    return {"params": {n: tree_map(lambda _, n=n: n not in live, sub)
                       for n, sub in tree["params"].items()},
            "grids": {n: n not in live for n in tree["grids"]}}


def pretrain_step(tree, opt, frozen, spec: ModelSpec, bound, p, centers,
                  radii, lr: float):
    """One pretraining step on the points p (N, 3) of the scene of spheres
    (centers (S, 3), radii (S,)): the fine stage's occupancy, through
    tanh, regressed onto tanh of the target, then one Adam step.  On the
    card at the default widths this is K1 and K2 with the middle and fine
    decoders live.  Returns (tree, opt, loss)."""
    tr = tree_map(lambda x, f: x if f else x.detach().requires_grad_(True),
                  tree, frozen)
    live = [x for x, f in zip(tree_leaves(tr), tree_leaves(frozen))
            if not f]
    raw = model_apply(tr["params"], spec, tr["grids"], bound, p, "fine")
    tgt = torch.tanh(occ_target(p, centers, radii))
    loss = torch.mean((torch.tanh(raw[:, 3]) - tgt) ** 2)
    gl = iter(torch.autograd.grad(loss, live))
    g = tree_map(lambda x, f: None if f else next(gl), tr, frozen)
    tree, opt = adam_update(tree, g, opt, lr, frozen=frozen)
    return tree, opt, loss.detach()


def pretrain_decoders_synthetic(gen: Optional[torch.Generator], params: dict,
                                spec: ModelSpec, bound, steps: int = 2000,
                                batch: int = 4096, lr: float = 1e-3,
                                grids=None, verbose: bool = False):
    """Train the middle and fine decoders (and the grids) to regress
    procedural occupancy fields (six random spheres per step), giving the
    frozen decoders a prior without the ConvONet checkpoints (the JAX
    package's pretrain.py:133-187).  Draws come from `gen`, on its
    device.  Returns (params, the (steps,) losses on the device)."""
    from nice_slam_torch.state import init_grids

    dev = tree_leaves(params)[0].device
    bound_t = torch.as_tensor(np.asarray(bound), dtype=torch.float32,
                              device=dev)
    if grids is None:
        grids = init_grids(gen, np.asarray(bound), PRETRAIN_GRID_LEN,
                           spec.c_dim, spec.coarse, spec.coarse_bound_enlarge,
                           device=dev)
    tree = {"params": params, "grids": grids}
    opt = adam_init(tree)
    frozen = pretrain_frozen(tree)
    lo, hi = bound_t[:, 0], bound_t[:, 1]
    losses = []
    for i in range(steps):
        centers = lo + (hi - lo) * torch.rand(6, 3, generator=gen, device=dev)
        radii = 0.1 + 0.4 * torch.rand(6, generator=gen, device=dev)
        p = lo + (hi - lo) * torch.rand(batch, 3, generator=gen, device=dev)
        tree, opt, loss = pretrain_step(tree, opt, frozen, spec, bound_t, p,
                                        centers, radii, lr)
        losses.append(loss)
        if verbose and i % 200 == 0:
            print(f"pretrain step {i}: loss {float(loss):.5f}")
    return tree["params"], torch.stack(losses)
