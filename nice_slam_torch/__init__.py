"""nice_slam_torch: the PyTorch/CUDA port of nice_slam_tpu.

NICE-SLAM and iMAP* on one NVIDIA Hopper GPU, with checkpoints and
meshes: the same config tree, map layout and schedule as the JAX package,
with the fused middle+fine+colour decode (forward and backward) as
hand-written CUDA kernels (csrc/fused_decode.cu, csrc/fused_decode_bwd.cu)
and the mesher's marching tetrahedra as host C++ (native/).  Entry points run on `cuda` unless the caller
passes device="cpu", where every kernel runs its plain PyTorch version.
This package imports torch and never jax or nice_slam_tpu.
"""

__version__ = "0.1.0"
