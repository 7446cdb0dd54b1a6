"""Precision policy and weight conversion."""
