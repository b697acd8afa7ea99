"""The reference following iMAP*'s tracked frames and the first steps of
each pass of its mapping events, from the program's own state, with the
same draws, in plain PyTorch (reference/plain_imap.py); check.py's
comparison reads what these return as it reads reference/follow.py's.

Tracking is NICE's loop (follow.follow_tracking and
follow.follow_tracking_steps) rendered with iMAP*'s model.  A steady
mapping event is three passes of max(iters // 3, 1) iterations, each a
mapper call of its own (the port's event): its window drawn anew at its
start by global selection, and a fresh Adam.  Iterations are numbered on
across the passes (pass p's iteration k is p x max(iters // 3, 1) + k,
as the program's losses run).  In every pass the program's state is read
before iterations 0, 1 and 2, and the reference takes the first two steps
from it: the loss at the program's state with the program's draws (the
window's pixels, then the regulation's jitter), and the Adam step of each
leaf group, the second step's moments the reference's own from its
first.  Every group's moments start at zero at each pass's iteration 0:
the decoder at imap_decoders_lr times StepLR(200, 0.8) at Adam's step in
the pass (lr_factor does not scale it, as in the port), and under BA the
window cameras at BA_cam_lr.  StepLR's factor is 1 below Adam's step
200, so at the steps followed it is exercised only in a pass of more
than 200 iterations.
"""

from __future__ import annotations

import functools

import torch

from benchmark.reference import follow, plain, plain_imap

# the leaf groups whose steps are compared one by one: the Fourier
# matrix B, the hidden layers, the head
GROUPS = ("decoder/imap/embed", "decoder/imap/pts", "decoder/imap/out")

follow_tracking = functools.partial(follow.follow_tracking, ref=plain_imap)
follow_tracking_steps = functools.partial(follow.follow_tracking_steps,
                                          ref=plain_imap)


# the passes of a steady mapping event
N_PASSES = 3


def pass_iters(cfg) -> int:
    """Iterations of each of a steady event's three passes."""
    return max(cfg["mapping"]["iters"] // 3, 1)


def pass_steps(cfg) -> list:
    """The first two steps of a pass whose next state the pass still
    shows (Adam's step in the pass)."""
    n = pass_iters(cfg)
    return [k for k in range(min(2, n)) if k + 1 <= n - 1]


def followed_iterations(cfg) -> list:
    """Those steps of every pass, numbered on across the passes."""
    n = pass_iters(cfg)
    return [p * n + k for p in range(N_PASSES) for k in pass_steps(cfg)]


def snapshot_iterations(cfg) -> list:
    """The iterations whose state (before their step) the check reads."""
    return sorted({i for k in followed_iterations(cfg) for i in (k, k + 1)})


def imap_lr(lr: float, step: int) -> float:
    """The decoder's learning rate at Adam step `step` (from 0):
    StepLR(200, 0.8) (Mapper.py:388-389)."""
    return lr * 0.8 ** (step // 200)


def mapping_loss(cfg, tree, bound, win, gen):
    """Mapper.py:430-501 in iMAP* mode at the state `tree` ({"params",
    "cams"}): pixels/window pixels of every window frame drawn from `gen`;
    the L1 depth loss over valid pixels, plus w_color_loss x the L1 colour
    loss, plus 0.0005 x the L1 of the regulation's densities, whose
    jitter is drawn next."""
    mp, r = cfg["mapping"], cfg["rendering"]
    cam = follow._cam(cfg)
    H, W = cam["H"], cam["W"]
    colors, depths = win["colors"], win["depths"]
    wn = colors.shape[0]
    n_pix = mp["pixels"] // wn
    i, j = plain.draw_pixels(gen, None, 0, H, 0, W, shape=(wn, n_pix))
    dirs = torch.stack([(i - cam["cx"]) / cam["fx"],
                        -(j - cam["cy"]) / cam["fy"],
                        -torch.ones_like(i)], -1).to(colors.dtype)
    c2w = plain.cam_to_c2w(tree["cams"])
    rd = torch.sum(dirs[..., None, :] * c2w[:, None, :3, :3], -1)
    ro = c2w[:, None, :3, 3].expand(rd.shape)
    f = torch.arange(wn, device=colors.device)[:, None]
    gd = depths[f, j.long(), i.long()].reshape(-1)
    gc = colors[f, j.long(), i.long()].reshape(-1, 3)
    ok = win["valid"][:, None].expand(wn, n_pix).reshape(-1)
    ro, rd = ro.reshape(-1, 3), rd.reshape(-1, 3)
    dep, _, col = plain_imap.render(tree["params"], bound, ro, rd, gd,
                                    follow._render_args(cfg))
    loss = torch.sum(torch.abs(gd - dep) * ((gd > 0) & ok))
    loss = loss + mp["w_color_loss"] * torch.sum(
        torch.abs(gc - col) * ok[:, None])
    n_s = r["N_samples"]
    sigma = plain_imap.regulation_sigma(tree["params"], bound, ro, rd, gd,
                                        n_s, gen)
    sig_ok = ok[:, None].expand(-1, n_s).reshape(-1)
    return loss + 0.0005 * torch.sum(torch.abs(sigma) * sig_ok)


def follow_mapping(cfg, bound, idx, cur, kf_c2w, kf_frames, count,
                   capacity, frames, gen, states, pass_gens=()) -> dict:
    """The first steps of every pass of frame idx's mapping event, each
    from the program's own state before it (`states[it]` = {"tree":
    {"params", "grids", "cams"}, "gen": the generator's state}).  Each
    pass's window comes from that pass's start (`pass_gens[p]`, the
    generator there; `gen`, the event's start, where none are given):
    global keyframe selection.

    Returns {"losses": {it: loss}, "steps": {(it, group): {"delta": the
    step, "weight": |first moment|, "unit": half the nominal step
    there}}, "ba": BA on}."""
    mp = cfg["mapping"]
    n = pass_iters(cfg)
    losses, steps = {}, {}
    b1, b2, eps = 0.9, 0.999, 1e-8
    for p in range(N_PASSES):
        win = follow.mapping_window(
            cfg, bound, idx, cur, kf_c2w, kf_frames, count, capacity,
            frames, pass_gens[p] if len(pass_gens) > p else gen)
        groups = GROUPS + (("cams",) if win["ba"] else ())
        moments = {}
        for k in pass_steps(cfg):
            it = p * n + k
            st = states[it]
            g_ = torch.Generator(device=gen.device)
            g_.set_state(st["gen"])
            tree = {"params": follow._with_grad(st["tree"]["params"]),
                    "cams": st["tree"]["cams"]}
            if win["ba"]:
                tree["cams"] = tree["cams"].detach().clone().requires_grad_(
                    True)
            loss = mapping_loss(cfg, tree, bound, win, g_)
            live = {grp: follow.group_leaves(tree, grp) for grp in groups}
            grads = iter(torch.autograd.grad(
                loss, [x for grp in groups for x in live[grp]]))
            losses[it] = float(loss.detach())
            step = k + 1
            inv1 = 1.0 / (1.0 - b1 ** step)
            inv2 = 1.0 / (1.0 - b2 ** step)
            for grp in groups:
                g = torch.cat([next(grads).reshape(-1) for _ in live[grp]])
                if grp == "cams":
                    lr = (mp["BA_cam_lr"] * win["cam_lr"])[:, None].expand(
                        -1, 7).reshape(-1)
                else:
                    lr = torch.full_like(
                        g, imap_lr(mp["imap_decoders_lr"], k))
                if k == 0:
                    m, v = torch.zeros_like(g), torch.zeros_like(g)
                else:
                    m, v = moments[grp]
                m = b1 * m + (1 - b1) * g
                v = b2 * v + (1 - b2) * g * g
                moments[grp] = (m, v)
                delta = -lr * (m * inv1) / (torch.sqrt(v * inv2) + eps)
                steps[(it, grp)] = {"delta": delta.detach(),
                                    "weight": torch.abs(m).detach(),
                                    "unit": follow.half_nominal(lr, step, b1,
                                                                b2)}
    return {"losses": losses, "steps": steps, "ba": win["ba"]}
