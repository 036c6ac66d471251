"""K2 (the ConvNeXt MLP tail, forward and backward) in the train step:
the least time of its calls at the cell's geometry over the device time of
the kernels that implement them, in percent."""

from benchmark import roofline

# the kernels that implement its calls, by the names the profiler shows
KERNELS = (r"\b(fused_mlp_wgmma_kernel|fused_mlp_kernel|mlp_bwd_prologue_kernel"
           r"|mlp_bwd_rows_wgmma_kernel|mlp_bwd_weights_wgmma_kernel|mlp_bwd_rows_kernel"
           r"|mlp_bwd_weights_kernel|mlp_bwd_reduce_kernel)\b")


def read(ctx):
    bound = roofline.k2_ms(ctx["spec"], ctx["batch"], True) * ctx["traced_steps"]
    return roofline.share(bound, ctx["trace"].device_ms(KERNELS))
