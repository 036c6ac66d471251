"""Architecture presets."""
