"""Attention, RoPE and the fused kernels' wrappers."""
