"""Synthetic sequences: the deterministic renderer (numpy)."""
