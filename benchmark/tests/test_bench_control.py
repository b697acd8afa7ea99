"""The precision control on the card: the reference computed in TF32,
put in the program's place, fails the cell's limits.  At the cell's own
size this is `run.py --readings 1` on the chip (PERF.md gives the
readings); here a shortened window of room0.strict."""

import pytest
import torch


@pytest.mark.cuda
def test_tf32_reference_is_not_correct():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: TF32 exists only there")
    import dataclasses
    import time

    from benchmark import registry, run
    from benchmark.reference import check

    wl = registry.workload("room0.strict")
    wl["check"]["track_span"] = 6
    wl["check"]["map_offsets"] = [4]
    args = run.parse(["--workload", "room0.strict", "--seed", "77",
                      "--seconds", "4", "--trace", "0"])
    seen = {}

    def keep(cfg, w, captures, stream, dev, start, readings):
        ref = check.follow_all(cfg, captures, stream, dev)
        ctrl = check.as_outputs(check.follow_all(cfg, captures, stream, dev,
                                                 tf32=True))
        caps = {k: dataclasses.replace(c, out=ctrl[k])
                for k, c in captures.items()}
        seen["control"] = run.compared(
            dict(check.gaps(caps, ref, check.follow_steps(
                cfg, caps, stream, dev)), start=0.0), w["limits"])
        return orig(cfg, w, captures, stream, dev, start, readings)

    orig = run.judge
    run.judge = keep
    try:
        res, _ = run.run_cell(args, wl, torch.device("cuda"),
                              time.perf_counter())
    finally:
        run.judge = orig
    assert res["correct"], res["check"]
    assert not run.is_correct(seen["control"]), seen["control"]
