"""On-device batch transforms of the train step."""

from .ensure_ops_schedule import ensure_ops_schedule  # noqa: F401
