"""Sparse-conv operations and their hand-written kernels."""
