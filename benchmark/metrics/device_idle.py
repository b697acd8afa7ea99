"""Share of the profiled sub-window in which no operation ran on the
card: one minus the union of the trace's device intervals over the
sub-window's length."""
NAME = "device_idle"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "device"
MOVES = "frames_per_s"
CELLS = None


def read(ctx):
    t = ctx.trace
    if not t or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
