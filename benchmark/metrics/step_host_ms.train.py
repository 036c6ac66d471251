"""Host ms of one train step: the median over the program's ``train_step``
spans that its recorder holds (those the profiler traced) of the host
clock's time from the call to its return, the time the step costs the host
to launch where the device keeps pace, or the device's pace where the host
waits on full launch queues. None where the program has no recorder or no
step was recorded."""


def read(ctx):
    try:
        from linnaeus_tpu_torch.utils import tracing
    except ImportError:
        return None
    steps = tracing.summary().get("train_step")
    return None if steps is None else steps["host_ms_median"]
