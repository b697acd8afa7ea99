"""Multi-frame and multi-device solvers of the port.

`schur_ba`: the Gauss-Newton pose refinement of tracking and local BA
(the JAX package's nice_slam_tpu/parallel/schur_ba.py); its `reduce_fn`
sums a sharded ray batch's systems across ranks.
`multihost`: one process per rank in a torch.distributed process group.
`data_parallel`: ray-data-parallel mapping over that group.
`grid_sharded`: the grids in X-slabs over the `model` ranks of a 2-D
process group, the rays over its `data` ranks.
`pipelined`: the tracker and the mapper on two devices."""
