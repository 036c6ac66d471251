"""Host seconds of loading the port's CUDA kernels in set-up
(``_kernels.library``, the nvcc build included where one ran): the
program's ``setup/kernels`` span, recorded whether tracing is on or not.
None where the program has no recorder or the span did not run."""


def read(ctx):
    try:
        from linnaeus_tpu_torch.utils import tracing
    except ImportError:
        return None
    s = tracing.summary().get("setup/kernels")
    return None if s is None else s["host_ms"] / 1000.0
