"""Weight conversion from the TPU package."""
