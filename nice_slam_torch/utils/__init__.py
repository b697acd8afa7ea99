"""Host-side helpers (numpy): datasets, the synthetic scene, ATE."""
