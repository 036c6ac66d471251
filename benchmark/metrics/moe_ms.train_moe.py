"""Device ms a step of the expert layers' forward: the program's
``MoEMlp.forward`` spans (CUDA events on the step's stream, recorded while
the profiler traced), summed over each traced ``train_step`` and the
median taken over the steps. None where the program keeps no such records
or the spans did not run."""

from benchmark import roofline_moe


def read(ctx):
    return roofline_moe.span_ms_a_step(("MoEMlp.forward",))
