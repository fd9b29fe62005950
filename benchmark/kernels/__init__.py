"""Frozen work counts of the port's kernels."""
