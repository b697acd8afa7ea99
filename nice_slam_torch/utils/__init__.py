"""Host-side helpers: datasets, the synthetic scene, ATE, checkpoints,
PLY files, the mesher and the transient-failure retry."""
