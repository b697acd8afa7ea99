"""NICE (`nice: true`): the hierarchical feature grids and their 32-wide
decoders, which the port decodes in the fused kernels K1 and K2.

- The check follows a sampled mapping event's first two steps of every
  stage (reference/follow.py) from the program's state before them, the
  grids the stages read included.
- `start`: the decoders the program built against the reference's own
  load of the repository's npz.
- The least time costs every tracking and init_select render and every
  mapping stage and the coarse mapper (costs/decode.py).
"""

from __future__ import annotations

from benchmark.costs import decode as cd
from benchmark.reference import check, follow

# the grids of a mapping event's state that the followed steps read
STATE_GRIDS = ("middle", "fine", "color")

snapshot_iterations = follow.snapshot_iterations
schedule_least_ms = cd.schedule_least_ms


def start_gap(program_params: dict, cfg, device) -> float:
    return check.start_gap(program_params,
                           cfg["pretrained_decoders"]["tpu_npz"])


def judge(cfg, captures, stream, dev, start_params, readings: bool):
    """check.judge with NICE's followers (see there)."""
    return check.judge(cfg, captures, stream, dev,
                       start_gap(start_params, cfg, dev), readings,
                       follower=follow)
