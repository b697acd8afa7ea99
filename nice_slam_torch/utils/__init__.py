"""Host-side helpers: datasets, the synthetic scene, ATE, checkpoints,
PLY files and the mesher."""
