"""Camera geometry: rotations, projection, two-view and PnP solvers."""
