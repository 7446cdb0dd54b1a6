"""Training and evaluation data (vdn/data): datasets, splits, batches."""
