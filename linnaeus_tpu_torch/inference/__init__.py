"""Serving: config, preprocessing, the handler and its result schemas."""
