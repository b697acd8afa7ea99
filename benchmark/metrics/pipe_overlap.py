"""How much tracking and mapping ran at once in the window: (sum of the
track spans + sum of the mapping-event spans - the window) over the
smaller sum, the spans clipped to the window (the definition of
chip_smoke.py's phase 16)."""
NAME = "pipe_overlap"
UNIT = "%"
BETTER = "higher"
SOURCE = "program_span"
LAYER = "pipelined engine"
MOVES = "frames_per_s"
CELLS = ["room0.pipelined"]


def read(ctx):
    w = ctx.window_ms

    def total(spans):
        return sum(max(0.0, min(b, w) - max(a, 0.0)) for _, a, b in spans)

    tr, mp = total(ctx.spans["track"]), total(ctx.spans["map"])
    if min(tr, mp) <= 0:
        return None
    return 100.0 * (tr + mp - w) / min(tr, mp)
