"""Multi-frame and (later) multi-device solvers of the port.

`schur_ba`: the Gauss-Newton pose refinement of tracking and local BA
(the JAX package's nice_slam_tpu/parallel/schur_ba.py), on one device;
its `reduce_fn` argument is where a sharded ray batch's systems would be
summed across devices."""
