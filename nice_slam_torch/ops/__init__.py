"""Tensor numerics of the port: SE(3), rays, sampling, compositing,
grid interpolation, Adam and the fused decode kernels."""
