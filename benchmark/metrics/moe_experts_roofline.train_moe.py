"""The expert layers' products in the train step, forward and backward:
their least time at the cell's geometry (``roofline_moe.experts_ms``) over
the device time of the operations that compute them
(``drivers/train_moe.py::EXPERT_OPS``, two steps profiled on host and
device), in percent."""

from benchmark import roofline, roofline_moe


def read(ctx):
    ms = ctx.get("experts_ms")
    if ms is None:
        return None
    return roofline.share(roofline_moe.experts_ms(ctx["spec"], ctx["batch"]), ms)
