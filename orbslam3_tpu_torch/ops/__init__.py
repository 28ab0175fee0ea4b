"""Device ops on torch tensors: geometry, features, matching, solvers and the
hand-written match_rows kernel."""
