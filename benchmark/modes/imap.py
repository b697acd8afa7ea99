"""iMAP* (`nice: false`): one MLP (the 93-wide Fourier embedding, four
256-wide layers, rgb and density out) and no grids, which the port
decodes in plain fp32 matrix products.

- The check follows tracking as NICE's (rendered with iMAP*'s model),
  and the first two steps of a sampled event's first pass
  (reference/follow_imap.py) from the program's state before them.
- `start`: the decoder the program built against the reference's own
  draw of it from tpu.seed, on the program's device (exact).
- The least time costs every tracking and init_select render and every
  mapping iteration with its regulation (costs/imap.py).
"""

from __future__ import annotations

from benchmark.costs import imap as ci
from benchmark.reference import check, follow_imap, plain, plain_imap

# iMAP* keeps no grids
STATE_GRIDS = ()

snapshot_iterations = follow_imap.snapshot_iterations
schedule_least_ms = ci.schedule_least_ms


def start_gap(program_params: dict, cfg, device) -> float:
    """Widest |program - reference| over the initial decoder's weights."""
    ref = plain.flatten(plain_imap.init_decoder(cfg["tpu"]["seed"], device))
    prog = plain.flatten(program_params)
    if set(ref) != set(prog):
        return float("inf")
    return max(float((prog[k].float() - ref[k].cpu()).abs().max())
               for k in ref)


def judge(cfg, captures, stream, dev, start_params, readings: bool):
    """check.judge with iMAP*'s followers (see there)."""
    if cfg["rendering"]["perturb"] > 0.0:
        raise ValueError("the iMAP* reference follows rendering.perturb 0 "
                         "only")
    return check.judge(cfg, captures, stream, dev,
                       start_gap(start_params, cfg, dev), readings,
                       follower=follow_imap)
