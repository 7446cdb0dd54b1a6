"""Plain tensor ops: resize, attention, host stitching."""
