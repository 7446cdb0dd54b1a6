"""Depth evaluation: the metric suite, the per-sequence protocol, DA-2K."""
