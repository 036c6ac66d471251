from .throughput import generate_synthetic_data, throughput_test  # noqa: F401
