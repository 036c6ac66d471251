"""Per-task classification heads."""
