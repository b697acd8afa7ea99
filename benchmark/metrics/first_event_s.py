"""Device span of frame 0's mapping event (iters_first iterations and the
coarse mapper's) in set-up, in seconds."""
NAME = "first_event_s"
UNIT = "s"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "mapping"
MOVES = "setup_s"
CELLS = None


def read(ctx):
    ev = ctx.spans["first_event"]
    return (ev[0][2] - ev[0][1]) / 1e3 if ev else None
