"""mFormerV1, mFormerV0 and their building blocks."""
