"""Shared blocks: ConvNeXt, 2D-RoPE and relative-position attention, MBConv,
BatchNorm, MLPs and meta heads."""
