"""Kernels and their plain versions, and optimizer state."""
