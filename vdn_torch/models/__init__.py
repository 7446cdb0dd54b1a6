"""Models and presets."""
