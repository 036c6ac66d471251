"""Shared blocks: ConvNeXt, 2D-RoPE attention, MLPs and meta heads."""
