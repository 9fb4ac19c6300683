"""Model families (stacked-agent MLPs)."""
