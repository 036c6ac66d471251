"""The share of the traced steps' window in which no operation ran on the
card: one less the union of the device operations' intervals over the span
from the first one's start to the last one's end, both on the trace's clock."""


def read(ctx):
    t = ctx["trace"]
    window = t.window_s()
    return None if window <= 0.0 else 100.0 * (1.0 - t.busy_s() / window)
