"""Training of the port: losses, the refinement and metric-depth trainers."""
