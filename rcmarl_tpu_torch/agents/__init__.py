"""Agent parameter structures."""
