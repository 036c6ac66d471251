"""Device ms a step of the train step's backward: the program's
``train_step/backward`` span (CUDA events on the step's stream, recorded
while the profiler traced), its median call times its calls a step (its
calls over the ``train_step`` calls the recorder holds). The median keeps
out the steps traced on the host too, in which the device waits inside the
spans for a host that the profiler slows. None where the program has no
recorder or the span did not run."""


def read(ctx):
    try:
        from linnaeus_tpu_torch.utils import tracing
    except ImportError:
        return None
    spans = tracing.summary()
    phase, steps = spans.get("train_step/backward"), spans.get("train_step")
    if phase is None or phase["device_ms"] is None or steps is None:
        return None
    return phase["device_ms_median"] * phase["calls"] / steps["calls"]
