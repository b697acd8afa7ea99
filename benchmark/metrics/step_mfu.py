"""The whole step's share of the card's peak: the least time, from
operations alone at the 3xTF32 rate, of all the decoder work the
window's schedule does (every tracking and init_select render, every
mapping iteration, forward and backward, counted from the
configuration's shapes whatever implements them: the cell's mode's
schedule_least_ms, costs/decode.py for NICE, costs/imap.py for iMAP*)
over the window's seconds."""
NAME = "step_mfu"
UNIT = "%"
BETTER = "higher"
SOURCE = "host_clock"
LAYER = "model step"
MOVES = "frames_per_s"
CELLS = None


def read(ctx):
    ms = ctx.schedule_least_ms()
    return 100.0 * ms / (ctx.window_s * 1e3) if ms else None
