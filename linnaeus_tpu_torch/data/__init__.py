"""On-device batch transforms of the train step."""
