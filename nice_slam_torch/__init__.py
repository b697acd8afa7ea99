"""nice_slam_torch: the PyTorch/CUDA port of nice_slam_tpu.

Strict NICE-SLAM on one NVIDIA Hopper GPU: the same config tree, map
layout and schedule as the JAX package, with the fused middle+fine+colour
decode (forward and backward) as hand-written CUDA kernels
(csrc/fused_decode.cu).  Entry points run on `cuda` unless the caller
passes device="cpu", where every kernel runs its plain PyTorch version.
This package imports torch and never jax or nice_slam_tpu.
"""

__version__ = "0.1.0"
