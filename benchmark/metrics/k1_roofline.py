"""K1 (the fused decode's forward): the least time of the profiled
sub-window's K1 launches, counted by kind ('color n=48000') by the
port's launch counters and costed from their shapes
(costs/decode.launch_bound_ms, 3xTF32 peaks), over the device time of
the K1 kernels in the trace."""
NAME = "k1_roofline"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "decode kernels"
MOVES = "frames_per_s"
CELLS = None
# K1 and K2 decode NICE's grids: cells of other modes launch neither
MODES = ("nice",)
KERNELS = ("nice_fwd_kernel", "nice_fwd_combine_kernel")


def read(ctx):
    return ctx.roofline("fwd", KERNELS)
