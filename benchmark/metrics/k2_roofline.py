"""K2 (the fused decode's backward), as k1_roofline: least time of the
sub-window's K2 launches by kind over the device time of the K2
kernels."""
NAME = "k2_roofline"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "decode kernels"
MOVES = "frames_per_s"
CELLS = None
# K1 and K2 decode NICE's grids: cells of other modes launch neither
MODES = ("nice",)
KERNELS = ("nice_bwd_kernel", "nice_wgrad_reduce_kernel")


def read(ctx):
    return ctx.roofline("bwd", KERNELS)
