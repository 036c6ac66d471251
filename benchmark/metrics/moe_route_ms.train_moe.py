"""Device ms a step of the expert layers' routing work in the forward: the
program's ``MoEMlp.forward/route`` (router product, softmax, sort, queue
positions, statistics), ``/dispatch`` (the slot buffer's ``index_put``)
and ``/combine`` spans, everything of the layer but its two products,
summed over each traced ``train_step`` and the median taken over the
steps. None where the program has no such spans."""

from benchmark import roofline_moe


def read(ctx):
    return roofline_moe.span_ms_a_step(("MoEMlp.forward/route", "MoEMlp.forward/dispatch",
                                        "MoEMlp.forward/combine"))
