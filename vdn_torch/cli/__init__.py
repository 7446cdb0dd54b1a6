"""Command-line entry points (``python -m vdn_torch.cli.<name>``), each on
the card unless ``--device cpu`` is passed."""
