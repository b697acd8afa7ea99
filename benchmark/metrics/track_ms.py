"""Mean device span of SlamEngine.track per frame in the window: CUDA
events on the calling thread's current stream around each call."""
NAME = "track_ms"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "tracking"
MOVES = "frames_per_s"
CELLS = None


def read(ctx):
    ms = [b - a for _, a, b in ctx.spans["track"]]
    return sum(ms) / len(ms) if ms else None
