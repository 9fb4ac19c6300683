"""Environments (the grid world so far)."""
