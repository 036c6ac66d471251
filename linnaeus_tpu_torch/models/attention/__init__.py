"""The registered attention zoo (MODEL.ATTENTION_MECHANISM)."""
