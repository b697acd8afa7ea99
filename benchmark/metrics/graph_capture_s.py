"""Seconds the tracking and mapping graph runners spent capturing, from
engine.graph_stats() when the window closes."""
NAME = "graph_capture_s"
UNIT = "s"
BETTER = "lower"
SOURCE = "program_counter"
LAYER = "graph runner"
MOVES = "setup_s"
CELLS = None


def read(ctx):
    g = ctx.counters["window_end"]["graphs"]
    s = sum(side["capture_s"] for side in g.values())
    return s if s > 0 else None
