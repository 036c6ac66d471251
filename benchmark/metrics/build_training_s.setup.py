"""Host seconds of ``train/build.py::build_training`` in set-up (the
model's seeded init, the optimizer, the loss functions, the steps): the
program's ``setup/build_training`` span, recorded whether tracing is on or
not. None where the program has no recorder or the span did not run."""


def read(ctx):
    try:
        from linnaeus_tpu_torch.utils import tracing
    except ImportError:
        return None
    s = tracing.summary().get("setup/build_training")
    return None if s is None else s["host_ms"] / 1000.0
