"""Synthetic dataset generators of the examples."""
