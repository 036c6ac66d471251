"""mFormerV1 and its building blocks."""
