"""Run state and replay buffer layout."""
