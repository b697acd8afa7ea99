"""Mean device span of a steady SlamEngine.mapping_event started in the
window: CUDA events on the stream that runs it (the mapper's own in the
pipelined engine)."""
NAME = "map_event_ms"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "mapping"
MOVES = "frame_ms_p90"
CELLS = None


def read(ctx):
    ms = [b - a for _, a, b in ctx.spans["map"]]
    return sum(ms) / len(ms) if ms else None
