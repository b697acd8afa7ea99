"""The frozen decode arithmetic equals chip_smoke.py's, for every launch
kind of both configurations, and the least work of a step bounds the
fused kernels' own count from below."""

import pytest

import chip_smoke
from benchmark import registry
from benchmark.costs import decode as cd

CONFIGS = ("replica_room0", "scannet_scene0000")


def kinds(cfg):
    """(n, with_color, direction, live) of every K1 and K2 launch of the
    configuration: tracking at its points, mapping's fine and colour
    stages at theirs."""
    r = cfg["rendering"]
    per_ray = r["N_samples"] + r["N_surface"]
    n_t = cfg["tracking"]["pixels"] * per_ray
    wn = cfg["mapping"]["mapping_window_size"]
    n_m = cfg["mapping"]["pixels"] // wn * wn * per_ray
    return [(n_t, True, "fwd", 0), (n_t, True, "bwd", 0),
            (n_m, True, "fwd", 0), (n_m, False, "fwd", 0),
            (n_m, True, "bwd", 4), (n_m, True, "bwd", 0),
            (n_m, False, "bwd", 0), (n_m, True, "bwd", 7)]


@pytest.mark.parametrize("name", CONFIGS)
def test_decode_work_equals_chip_smoke(name):
    cfg = registry.config(name)["cfg"]
    for n, wc, direction, live in kinds(cfg):
        mine = cd.decode_work(n, wc, direction, live)
        theirs = chip_smoke.decode_work(n, wc, direction, live)
        assert mine == theirs
        for tc in (False, True):
            assert cd.bound_ms(*mine, tensor_cores=tc) == \
                chip_smoke.bound_ms(*theirs, tensor_cores=tc)
    for dec in cd.DECS:
        assert cd._n_weights(dec) == chip_smoke._n_weights(dec)


@pytest.mark.parametrize("name", CONFIGS)
def test_launch_kinds_cost_their_shapes(name):
    cfg = registry.config(name)["cfg"]
    n = cfg["mapping"]["pixels"] // cfg["mapping"]["mapping_window_size"] \
        * cfg["mapping"]["mapping_window_size"] * 48
    assert cd.launch_bound_ms(f"color n={n}", "fwd") == cd.bound_ms(
        *cd.decode_work(n, True, "fwd"), tensor_cores=True)[0]
    assert cd.launch_bound_ms(f"color wgrad n={n}", "bwd") == cd.bound_ms(
        *cd.decode_work(n, True, "bwd", 4), tensor_cores=True)[0]
    assert cd.launch_bound_ms(f"fine no-wgrad n={n}", "bwd") == cd.bound_ms(
        *cd.decode_work(n, False, "bwd", 0), tensor_cores=True)[0]


@pytest.mark.parametrize("direction,live", [("fwd", 0), ("bwd", 0),
                                            ("bwd", 4)])
def test_step_work_is_at_most_the_kernels(direction, live):
    """The whole step counts no recomputation: never more operations than
    the fused kernels do for the same evaluation."""
    n = 48000
    tc, simt, _ = cd.decode_work(n, True, direction, live)
    stc, ssimt = cd.step_flops("color", n, direction,
                               ("color",) if live else (), need_dp=True)
    assert stc <= tc and ssimt <= simt
    if direction == "fwd":
        assert (stc, ssimt) == (tc, simt)
