"""`correct` comes out false when the timed path is broken underneath:
a run of the small cell on the CPU, the look for a card skipped, with
one fault planted in the program for each kind the cell can have."""

import pytest
import torch

from benchmark.tests.conftest import small_run


def test_sound_run_is_correct(sound_run):
    res, lines = sound_run
    assert res["correct"], lines


@pytest.mark.parametrize("cell", ["room0.pipelined", "scene0000.strict"])
def test_other_cells_are_correct(cell):
    """The pipelined engine and the cropped ScanNet frames, the window
    moved early."""
    res, lines = small_run(cell, seed=2**33 + 3)
    assert res["correct"], lines


def _alter_pose(mp):
    import nice_slam_torch.engine as engine

    orig = engine.track_step

    def track_step(*a, **k):
        out = orig(*a, **k)
        est_c2w, idx = a[3], a[4]
        with torch.no_grad():
            est_c2w[idx, :3, 3] += 1e-3
        return out

    mp.setattr(engine, "track_step", track_step)


def _half_batch(mp):
    """Every mapping iteration renders the first half of its rays twice
    (half of the batch left out, the sum taken as twice the rest)."""
    import nice_slam_torch.mapping as mapping

    orig = mapping._window_rays

    def window_rays(*a, **k):
        out = orig(*a, **k)
        h = out[0].shape[0] // 2
        return tuple(torch.cat([x[:h], x[:h]]) for x in out)

    mp.setattr(mapping, "_window_rays", window_rays)


def _tracking_unchanged(mp):
    import nice_slam_torch.tracking as tracking
    mp.setattr(tracking, "adam_step_", lambda *a, **k: None)


def _tracking_step(change):
    """Tracking's Adam step with `change(args) -> args` applied to its
    (camera, gradient, m, v, step, tables, lr) first."""
    def plant(mp):
        import nice_slam_torch.tracking as tracking

        orig = tracking.adam_step_
        mp.setattr(tracking, "adam_step_",
                   lambda *a, **k: orig(*change(list(a)), **k))
    return plant


def _lr_half(a):
    a[6] = a[6] * 0.5
    return a


def _entry_zero(a):
    """The gradient of the camera's x translation zeroed."""
    a[1] = a[1].clone()
    a[1][4] = 0.0
    return a


def _adam_off(mp):
    """Tracking steps by plain gradient descent at its learning rate."""
    import nice_slam_torch.tracking as tracking

    def sgd(cam, g, m, v, step, tables, lr, *a, **k):
        step.add_(1)
        cam.sub_(lr * g)

    mp.setattr(tracking, "adam_step_", sgd)


def _mapping_unchanged(mp):
    import nice_slam_torch.mapping as mapping
    mp.setattr(mapping, "adam_step_", lambda *a, **k: None)


def _stage_lr_zero(stage, groups):
    """The learning rates of `groups` ('params', 'grids', 'cams') zero in
    a stage: those leaves return their state unchanged there."""
    def plant(mp):
        import nice_slam_torch.mapping as mapping

        orig = mapping._lr_tree

        def lr_tree(tree, st, *a, **k):
            lr, frozen = orig(tree, st, *a, **k)
            if st == stage:
                lr = dict(lr)
                for g in groups:
                    lr[g] = mapping.tree_map(
                        lambda x: x * 0.0 if torch.is_tensor(x) else 0.0,
                        lr[g])
            return lr, frozen

        mp.setattr(mapping, "_lr_tree", lr_tree)
    return plant


def _colour_half_batch(mp):
    """The colour stage's loss over the first half of its rays twice."""
    import nice_slam_torch.mapping as mapping

    orig_loss, orig_rays = mapping.mapping_loss, mapping._window_rays

    def mapping_loss(tree, window, bound, camera, stage, *a, **k):
        if stage != "color":
            return orig_loss(tree, window, bound, camera, stage, *a, **k)

        def window_rays(*ra, **rk):
            out = orig_rays(*ra, **rk)
            h = out[0].shape[0] // 2
            return tuple(torch.cat([x[:h], x[:h]]) for x in out)

        mp.setattr(mapping, "_window_rays", window_rays)
        try:
            return orig_loss(tree, window, bound, camera, stage, *a, **k)
        finally:
            mp.setattr(mapping, "_window_rays", orig_rays)

    mp.setattr(mapping, "mapping_loss", mapping_loss)


FAULTS = {"tracking step returns its state unchanged": _tracking_unchanged,
          "mapping step returns its state unchanged": _mapping_unchanged,
          "pose altered where it is produced": _alter_pose,
          "tracking steps without Adam": _adam_off,
          "half of the mapping batch left out": _half_batch,
          "colour stage returns its state unchanged": _stage_lr_zero(
              "color", ("params", "grids", "cams")),
          "fine stage returns its state unchanged": _stage_lr_zero(
              "fine", ("grids",)),
          "half of the colour stage's batch left out": _colour_half_batch}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(fault, monkeypatch):
    """The fault is planted once the engine is built, so the set-up up to
    frame 0's event is the program's own."""
    res, lines = small_run(
        engine_hook=lambda eng: FAULTS[fault](monkeypatch), seed=41)
    assert not res["correct"], lines


def test_bundle_adjustment_fault_is_not_correct(monkeypatch):
    """Bundle adjustment leaving the window's poses unchanged, in the
    cell's own window (after BA has started)."""
    res, lines = small_run(
        engine_hook=lambda eng: _stage_lr_zero("color", ("cams",))(
            monkeypatch), seed=43, early=False)
    assert not res["correct"], lines


# each fault in the ScanNet cell, and the numbers that must catch it
# there (any one of them over its limit)
SCANNET_FAULTS = {
    "tracking step returns its state unchanged": (
        _tracking_unchanged, ("track_step",)),
    "pose altered where it is produced": (_alter_pose, ("track_kept",)),
    "tracking steps without Adam": (_adam_off, ("track_step",)),
    "tracking's learning rate halved": (
        _tracking_step(_lr_half), ("track_step",)),
    "one camera entry's gradient zeroed": (
        _tracking_step(_entry_zero), ("track_step",)),
    "mapping step returns its state unchanged": (
        _mapping_unchanged, ("map_step",)),
    "half of the mapping batch left out": (_half_batch, ("map_loss",)),
    "colour stage returns its state unchanged": (
        _stage_lr_zero("color", ("params", "grids", "cams")),
        ("map_step",))}


@pytest.mark.parametrize("fault", sorted(SCANNET_FAULTS))
def test_fault_is_caught_in_scannet(fault, monkeypatch):
    """scene0000.strict's 1000 px x 50-iteration tracking loop is judged
    step by step: each fault fails a number that rounding's drift cannot
    reach."""
    plant, numbers = SCANNET_FAULTS[fault]
    res, lines = small_run("scene0000.strict",
                           engine_hook=lambda eng: plant(monkeypatch),
                           seed=47)
    assert not res["correct"], lines
    check = res["check"]
    assert any(check[n]["value"] > check[n]["limit"] for n in numbers), \
        lines


def test_a_flip_counts_by_its_first_moment():
    """A step flipped on an entry whose reference first moment is near
    zero stays under scene0000.strict's track_step limit; the same flip
    on an entry with a large moment goes over it."""
    from benchmark import registry
    from benchmark.reference import check, follow

    limit = registry.workload("scene0000.strict")["limits"]["track_step"]
    unit = follow.half_nominal(5e-4, 20)
    ref = torch.tensor([4e-4, -3e-4, 2e-4, 4e-4, -4e-4, 3e-4, 1e-6])
    weight = torch.tensor([2.0, 1.5, 1.0, 2.0, 2.0, 1.5, 1e-6])
    step = {"delta": ref, "weight": weight, "unit": unit}
    small, big = ref.clone(), ref.clone()
    small[6] = -4e-4
    big[0] = -ref[0]
    assert check.step_shares(ref, step) == (0.0, 0.0)
    mass, flip = check.step_shares(small, step)
    assert mass < limit and flip == 1 / 7
    mass, flip = check.step_shares(big, step)
    assert mass > limit and flip == 1 / 7
