"""The reference following one tracked frame, and the first steps of
every stage of one mapping event, from the program's own state at their
start (the map it read, the poses before it and its generator's
position), with the same draws, in plain PyTorch (reference/plain.py).

A tracked frame is followed twice.  `follow_tracking` runs the
reference's own Adam loop from the start pose to the end: over a long
loop rounding picks the direction of near-zero-gradient entries' steps,
and every later step starts from there, so its poses drift from the
program's by rounding alone (its numbers are readings).
`follow_tracking_steps` follows the loop step by step from the
program's own cameras, as `follow_mapping` does an event: at each
iteration the loss and its gradient at the program's pre-step camera
with the program's draws, and the Adam step whose moments the
reference's own gradients at the program's cameras build."""

from __future__ import annotations

import torch

from benchmark.reference import plain


def _cam(cfg) -> dict:
    """The intrinsics the engine sees: crop_edge trimmed off
    (src/NICE_SLAM.py:113-135)."""
    c = cfg["cam"]
    e = c.get("crop_edge", 0) or 0
    return {"H": c["H"] - 2 * e, "W": c["W"] - 2 * e, "fx": c["fx"],
            "fy": c["fy"], "cx": c["cx"] - e, "cy": c["cy"] - e}


def _render_args(cfg) -> dict:
    r = cfg["rendering"]
    return {"cam": _cam(cfg), "samples": (r["N_samples"], r["N_surface"]),
            "importance": r["N_importance"]}


def _track_draw(cfg, gen):
    """Frame pixels as the tracker draws them, edges ignored."""
    t, cam = cfg["tracking"], _cam(cfg)
    eh, ew = t["ignore_edge_H"], t["ignore_edge_W"]
    return plain.draw_pixels(gen, t["pixels"], eh, cam["H"] - eh, ew,
                             cam["W"] - ew)


def half_nominal(lr, step, b1=0.9, b2=0.999):
    """Half the step Adam takes at `step` (from 1) on an entry whose
    gradient appears there for the first time, from zero moments."""
    inv1 = 1.0 / (1.0 - b1 ** step)
    inv2 = 1.0 / (1.0 - b2 ** step)
    return 0.5 * (lr * (1 - b1) * inv1 / ((1 - b2) * inv2) ** 0.5)


def follow_tracking(cfg, params, grids, bound, idx, pre, pre_pre, color,
                    depth, gen, lr_scale: float = 1.0, frozen_entry=None,
                    kept_shift: float = 0.0, ref=plain) -> dict:
    """Tracker.py:180-247 for frame idx: the constant-speed start, the
    init_select test against the previous pose, then `iters` Adam steps on
    the 7-vector, keeping the post-step camera of the lowest pre-step
    loss.  Returns the losses [first, last, best], every iteration's loss,
    pre-step camera (`cams`, (iters, 7)) and post-step camera (`posts`),
    the last post-step camera and the kept pose (4, 4).

    `lr_scale`, `frozen_entry` (a camera entry whose gradient is zeroed)
    and `kept_shift` (metres added to the kept pose's x) plant faults in
    the reference put in the program's place, for the readings of the
    faults that the check must catch.  `ref` is the plain model whose
    `tracking_loss` and `depth_median` the loop renders with:
    reference/plain.py (NICE) or reference/plain_imap.py (iMAP*)."""
    t = cfg["tracking"]
    ra = _render_args(cfg)
    init = pre
    if t["const_speed_assumption"] and idx >= 2:
        init = (pre @ torch.linalg.inv(pre_pre)) @ pre
        if t["init_select"]:
            with torch.no_grad():
                pix = _track_draw(cfg, gen)
                med_cs = ref.depth_median(
                    plain.cam_to_c2w(plain.c2w_to_cam(init)), params, grids,
                    bound, depth, pix, ra)
                med_pre = ref.depth_median(
                    plain.cam_to_c2w(plain.c2w_to_cam(pre)), params, grids,
                    bound, depth, pix, ra)
            if not bool(med_cs <= t["init_select_margin"]
                        * torch.clamp(med_pre, min=0.01)):
                init = pre
    cam_t = plain.c2w_to_cam(init).detach().clone()
    lr = t["lr"] * lr_scale
    m, v = torch.zeros_like(cam_t), torch.zeros_like(cam_t)
    best_loss, best = float("inf"), cam_t.clone()
    losses, cams, posts = [], [], []
    for k in range(1, t["iters"] + 1):
        cams.append(cam_t.clone())
        c = cam_t.clone().requires_grad_(True)
        loss = ref.tracking_loss(c, params, grids, bound, color, depth,
                                 _track_draw(cfg, gen), cfg, ra)
        (g,) = torch.autograd.grad(loss, c)
        if frozen_entry is not None:
            g[frozen_entry] = 0.0
        loss = float(loss.detach())
        with torch.no_grad():
            plain.adam(cam_t, g, m, v, k, lr)
        losses.append(loss)
        posts.append(cam_t.clone())
        if loss < best_loss:
            best_loss, best = loss, cam_t.clone()
    pose = plain.homogeneous(plain.cam_to_c2w(best))
    pose[0, 3] += kept_shift
    return {"losses": [losses[0], losses[-1], best_loss],
            "all_losses": losses, "cams": torch.stack(cams),
            "posts": posts, "last": posts[-1], "pose": pose}


def follow_tracking_steps(cfg, params, grids, bound, idx, color, depth,
                          gen, cams, ref=plain) -> dict:
    """Frame idx's tracking loop step by step from the program's own
    pre-step cameras `cams` (iters, 7), with the program's draws
    (init_select's pixels drawn first, as the program draws them).  At
    each iteration k: the loss at cams[k] and its gradient, the
    reference's Adam moments updated with it, and the step Adam takes
    from cams[k].

    Returns {"losses": [loss at cams[k]], "steps": [{"delta": the step,
    "weight": |first moment|, "unit": half the nominal step there}]}.
    `ref`: as in `follow_tracking`."""
    t = cfg["tracking"]
    ra = _render_args(cfg)
    if t["const_speed_assumption"] and idx >= 2 and t["init_select"]:
        _track_draw(cfg, gen)
    lr = t["lr"]
    b1, b2, eps = 0.9, 0.999, 1e-8
    m, v = torch.zeros_like(cams[0]), torch.zeros_like(cams[0])
    losses, steps = [], []
    for k in range(1, t["iters"] + 1):
        c = cams[k - 1].detach().clone().requires_grad_(True)
        loss = ref.tracking_loss(c, params, grids, bound, color, depth,
                                 _track_draw(cfg, gen), cfg, ra)
        (g,) = torch.autograd.grad(loss, c)
        losses.append(float(loss.detach()))
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mh, vh = m / (1.0 - b1 ** k), v / (1.0 - b2 ** k)
        steps.append({"delta": (-lr * mh / (torch.sqrt(vh) + eps)).detach(),
                      "weight": torch.abs(m).detach(),
                      "unit": half_nominal(lr, k)})
    return {"losses": losses, "steps": steps}


def _project(pts, c2w, cam):
    w2c = plain.se3_inverse(c2w)
    ph = torch.cat([pts, torch.ones_like(pts[..., :1])], -1)
    pc = ph @ w2c.transpose(-1, -2)
    x, y, z = -pc[..., 0], pc[..., 1], pc[..., 2]
    zs = z + 1e-5
    return cam["fx"] * x / zs + cam["cx"], cam["fy"] * y / zs + cam["cy"], z


def _select_overlap(gen, cam, depth, cur, kf_c2w, count, capacity, k):
    """Mapper.py:166-287 'overlap': 100 pixels of the current frame, 16
    samples each on [0.8 d, d + 0.5], the share of them every keyframe
    sees 20 px inside its image; a random top-k of the keyframes (the
    newest excluded) that see any."""
    i, j = plain.draw_pixels(gen, 100, 0, cam["H"], 0, cam["W"])
    o, d = plain.rays(i, j, cur, cam)
    dd = depth[j.long(), i.long()][:, None]
    t = torch.linspace(0.0, 1.0, 16, device=dd.device)
    z = (dd * 0.8) * (1.0 - t) + (dd + 0.5) * t
    pts = (o[:, None, :] + d[:, None, :] * z[..., None]).reshape(-1, 3)
    u, v, zc = _project(pts, kf_c2w, cam)
    e = 20
    seen = ((u < cam["W"] - e) & (u > e) & (v < cam["H"] - e) & (v > e)
            & (zc < 0))
    share = torch.mean(seen.to(torch.float32), -1)
    ids = torch.arange(capacity, device=dd.device)
    qualify = (ids < count - 1) & (share > 0.0)
    u_s = torch.rand(capacity, generator=gen, device=gen.device)
    return _top_slots(torch.where(qualify, u_s, torch.full_like(u_s, -1.0)),
                      k, capacity)


def _select_global(gen, count, capacity, k):
    """Mapper.py:259-265 'global': a random top-k of the stored keyframes,
    the newest excluded."""
    u_s = torch.rand(capacity, generator=gen, device=gen.device)
    ids = torch.arange(capacity, device=gen.device)
    return _top_slots(torch.where(ids < max(count - 1, 0), u_s,
                                  torch.full_like(u_s, -1.0)), k, capacity)


def _top_slots(scores, k, capacity):
    """The k best-scored slots and whether each scored above 0; k above
    the capacity padded with invalid slots."""
    kk = min(k, capacity)
    _, slots = torch.topk(scores, kk)
    valid = scores[slots] > 0.0
    if kk < k:
        slots = torch.cat([slots, torch.zeros(k - kk, dtype=slots.dtype,
                                               device=slots.device)])
        valid = torch.cat([valid, torch.zeros(k - kk, dtype=torch.bool,
                                              device=valid.device)])
    return slots, valid


def _bilinear(img, u, v):
    H, W = img.shape
    u = torch.clamp(u, 0.0, W - 1.0)
    v = torch.clamp(v, 0.0, H - 1.0)
    x0 = torch.clamp(torch.floor(u).long(), 0, max(W - 2, 0))
    y0 = torch.clamp(torch.floor(v).long(), 0, max(H - 2, 0))
    x1 = torch.clamp(x0 + 1, max=W - 1)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    fx, fy = u - x0, v - y0
    return (img[y0, x0] * (1 - fx) * (1 - fy) + img[y0, x1] * fx * (1 - fy)
            + img[y1, x0] * (1 - fx) * fy + img[y1, x1] * fx * fy)


def frustum_mask(bound, shape, c2w, depth, cam):
    """Mapper.py:93-164: grid nodes in the current view no deeper than the
    depth there + 0.5 m, and every node within 0.5 m of the camera."""
    axes = [torch.linspace(float(bound[a, 0]), float(bound[a, 1]), n,
                           dtype=bound.dtype, device=bound.device)
            for a, n in enumerate(shape)]
    X, Y, Z = torch.meshgrid(*axes, indexing="ij")
    pts = torch.stack([X, Y, Z], -1).reshape(-1, 3)
    u, v, z = _project(pts, c2w, cam)
    d_at = _bilinear(depth, u, v)
    d_at = torch.where(d_at == 0, torch.max(d_at), d_at)
    mask = ((u < cam["W"]) & (u > 0) & (v < cam["H"]) & (v > 0)
            & (0 <= -z) & (-z <= d_at + 0.5))
    near = torch.sum((pts - c2w[:3, 3]) ** 2, -1) < 0.25
    return (mask | near).reshape(shape)


def stage_plan(cfg) -> list:
    """[(stage, first iteration, iterations)] of a steady mapping event
    (Mapper.py:403-410): middle up to middle_iter_ratio, fine up to
    fine_iter_ratio, colour for the rest."""
    mp = cfg["mapping"]
    n = mp["iters"]
    n_mid = min(int(n * mp["middle_iter_ratio"]) + 1, n)
    n_fine = max(min(int(n * mp["fine_iter_ratio"]) + 1, n) - n_mid, 0)
    plan, start = [], 0
    for stage, k in (("middle", n_mid), ("fine", n_fine),
                     ("color", n - n_mid - n_fine)):
        if k > 0:
            plan.append((stage, start, k))
        start += k
    return plan


def followed_steps(cfg, per_stage: int = 2) -> list:
    """[(stage, iteration, step of the stage)]: the first `per_stage`
    steps of every stage whose next state the event still shows (the
    state before iteration it + 1)."""
    n = cfg["mapping"]["iters"]
    return [(stage, s + k, k) for stage, s, m in stage_plan(cfg)
            for k in range(min(per_stage, m)) if s + k + 1 <= n - 1]


def snapshot_iterations(cfg) -> list:
    """The iterations whose state (before their step) the check reads."""
    its = set()
    for _, it, _ in followed_steps(cfg):
        its |= {it, it + 1}
    return sorted(its)


def live_groups(cfg, stage: str, ba: bool) -> list:
    """The leaf groups that a stage trains ('grid/<name>',
    'decoder/<name>', 'cams'): grids with a learning rate in the stage
    table, the fine / colour / middle decoders unless fixed, the window
    cameras in the colour stage under BA (Mapper.py:335-363)."""
    mp = cfg["mapping"]
    t = mp["stage"][stage]
    out = [f"grid/{n}" for n in ("coarse", "middle", "fine", "color")
           if t[f"{n}_lr"] != 0.0]
    if t["decoders_lr"] != 0.0:
        if not mp["fix_fine"]:
            out.append("decoder/fine")
        if not mp["fix_color"]:
            out.append("decoder/color")
        if mp.get("train_middle_decoder", False):
            out.append("decoder/middle")
    if ba and stage == "color":
        out.append("cams")
    return out


def fresh_groups(cfg, ba: bool) -> dict:
    """{stage: groups it trains that no earlier stage of the event
    trained}: their Adam moments start at zero in that stage, so the
    reference can take their steps from the program's state there."""
    seen, out = set(), {}
    for stage, _, _ in stage_plan(cfg):
        live = live_groups(cfg, stage, ba)
        out[stage] = [g for g in live if g not in seen]
        seen |= set(live)
    return out


def group_leaves(tree, group: str) -> list:
    """The tensors of a leaf group of a {"params", "grids", "cams"} tree:
    'cams', 'grid/<name>', or 'decoder/<path>', the decoder subtree at
    that path ('decoder/color', 'decoder/imap/embed')."""
    if group == "cams":
        return [tree["cams"]]
    kind, path = group.split("/", 1)
    if kind == "grid":
        return [tree["grids"][path]]
    node = tree["params"]
    for part in path.split("/"):
        node = node[part]
    return list(plain.flatten(node).values())


def group_tensor(tree, group: str):
    """A leaf group of a {"params", "grids", "cams"} tree as one flat
    tensor."""
    return torch.cat([x.reshape(-1) for x in group_leaves(tree, group)])


def mapping_window(cfg, bound, idx, cur, kf_c2w, kf_frames, count,
                   capacity, frames, gen) -> dict:
    """Frame idx's mapping window (Mapper.py:166-363): keyframe
    selection (keyframe_selection_method 'overlap', or 'global'), the
    window (selected keyframes, the newest keyframe, the current frame)
    with its colours and depths, BA's learning-rate mask (the oldest valid
    keyframe and empty slots frozen) and whether BA is on."""
    mp = cfg["mapping"]
    cam = _cam(cfg)
    color, depth = frames(idx)
    k = mp["mapping_window_size"] - 2
    if mp["keyframe_selection_method"] == "global":
        slots, valid = _select_global(gen, count, capacity, k)
    else:
        slots, valid = _select_overlap(gen, cam, depth, cur, kf_c2w, count,
                                       capacity, k)
    slots_full = torch.cat([slots, torch.tensor([max(count - 1, 0)],
                                                device=slots.device)])
    valid_full = torch.cat([valid, torch.tensor([count > 0, True],
                                                device=valid.device)])
    dev = depth.device
    H, W = cam["H"], cam["W"]
    zero_c = torch.zeros(H, W, 3, dtype=depth.dtype, device=dev)
    zero_d = torch.zeros(H, W, dtype=depth.dtype, device=dev)
    cols, deps = [], []
    for s in slots_full.tolist():
        if s < count:
            c, d = frames(kf_frames[s])
        else:
            c, d = zero_c, zero_d
        cols.append(c)
        deps.append(d)
    ba = bool(mp["BA"]) and count > 4
    big = torch.iinfo(slots_full.dtype).max
    oldest = int(torch.argmin(torch.where(
        valid_full[:-1], slots_full, torch.full_like(slots_full, big))))
    cam_lr = valid_full.to(depth.dtype)
    cam_lr[oldest] = 0.0
    return {"colors": torch.stack(cols + [color]),
            "depths": torch.stack(deps + [depth]),
            "valid": valid_full, "cur": cur, "ba": ba,
            "cam_lr": cam_lr if ba else torch.zeros_like(cam_lr)}


def _with_grad(node):
    """A copy of a decoder's tree whose leaves take gradients."""
    if isinstance(node, dict):
        return {k: _with_grad(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_with_grad(v) for v in node]
    return node.detach().clone().requires_grad_(True)


def _grid_shape(tree, name):
    return tuple(tree["grids"][name].shape[:3])


def mapping_loss(cfg, tree, bound, win, stage, gen):
    """Mapper.py:430-501 at the state `tree` ({"params", "grids",
    "cams"}): pixels/window pixels of every window frame drawn from
    `gen`, the L1 depth loss over valid pixels inside the bound, plus
    w_color_loss x the L1 colour loss in the colour stage."""
    mp, r = cfg["mapping"], cfg["rendering"]
    cam = _cam(cfg)
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
    ok = ok & (plain.aabb_exit(ro.detach(), rd.detach(), bound) >= gd)
    dep, _, col = plain.render(tree["params"], tree["grids"], bound, ro, rd,
                               gd, stage, r["N_samples"], r["N_surface"])
    loss = torch.sum(torch.abs(gd - dep) * ((gd > 0) & ok))
    if stage == "color":
        loss = loss + mp["w_color_loss"] * torch.sum(
            torch.abs(gc - col) * ok[:, None])
    return loss


def follow_mapping(cfg, bound, idx, cur, kf_c2w, kf_frames, count,
                   capacity, frames, gen, states, pass_gens=()) -> dict:
    """The first steps of every stage of frame idx's mapping event
    (Mapper.py:289-501), each from the program's own state before it:
    `states[it]` = {"tree": {"params", "grids", "cams"}, "gen": the
    generator's state} before iteration it (the `snapshot_iterations`).
    The window comes from the event's start (`gen` there; the event is
    one mapper call, and `pass_gens`, its start again, goes unread).  At each
    followed iteration: the loss at the program's state with the
    program's draws, and the Adam step of every group whose moments
    start in this stage (`fresh_groups`), the moments of a stage's
    second step the reference's own from its first.

    Returns {"losses": {it: loss}, "steps": {(it, group): {"delta": the
    step, "weight": |first moment|, "unit": half the nominal step
    there}}, "ba": BA on}."""
    mp = cfg["mapping"]
    win = mapping_window(cfg, bound, idx, cur, kf_c2w, kf_frames, count,
                         capacity, frames, gen)
    cam = _cam(cfg)
    color, depth = frames(idx)
    fresh = fresh_groups(cfg, win["ba"])
    masks = {}
    losses, steps = {}, {}
    moments = {}
    b1, b2, eps = 0.9, 0.999, 1e-8
    for stage, it, k in followed_steps(cfg):
        st = states[it]
        tree = st["tree"]
        g_ = torch.Generator(device=gen.device)
        g_.set_state(st["gen"])
        groups = fresh[stage]
        live = {}
        t = {"params": tree["params"], "grids": dict(tree["grids"]),
             "cams": tree["cams"]}
        for grp in groups:
            if grp == "cams":
                t["cams"] = tree["cams"].detach().clone().requires_grad_(True)
                live[grp] = [t["cams"]]
            elif grp.startswith("grid/"):
                n = grp[5:]
                t["grids"][n] = tree["grids"][n].detach().clone() \
                    .requires_grad_(True)
                live[grp] = [t["grids"][n]]
        dec = [grp[8:] for grp in groups if grp.startswith("decoder/")]
        if dec:
            t["params"] = {n: _with_grad(sub) if n in dec else sub
                           for n, sub in tree["params"].items()}
            for n in dec:
                live[f"decoder/{n}"] = list(plain.flatten(
                    t["params"][n]).values())
        loss = mapping_loss(cfg, t, bound, win, stage, g_)
        leaves = [x for grp in groups for x in live[grp]]
        grads = torch.autograd.grad(loss, leaves) if leaves else []
        losses[it] = float(loss.detach())
        gi = iter(grads)
        table = mp["stage"][stage]
        step = it + 1
        inv1 = 1.0 / (1.0 - b1 ** step)
        inv2 = 1.0 / (1.0 - b2 ** step)
        for grp in groups:
            g = torch.cat([next(gi).reshape(-1) for _ in live[grp]])
            if grp == "cams":
                lr = (mp["BA_cam_lr"] * win["cam_lr"])[:, None].expand(
                    -1, 7).reshape(-1)
            elif grp.startswith("grid/"):
                n = grp[5:]
                if n not in masks:
                    masks[n] = frustum_mask(
                        bound, _grid_shape(tree, n), cur, depth,
                        cam)[..., None].expand(
                            _grid_shape(tree, n) + (tree["grids"][n].shape[3],)
                        ).reshape(-1).to(g.dtype)
                g = g * masks[n]
                lr = torch.full_like(g, table[f"{n}_lr"] * mp["lr_factor"])
            else:
                lr = torch.full_like(g, table["decoders_lr"]
                                     * mp["lr_factor"])
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
                                "unit": half_nominal(lr, step, b1, b2)}
    return {"losses": losses, "steps": steps, "ba": win["ba"]}
