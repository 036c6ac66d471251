"""K1 (attention, forward and backward) in the train step: the least time
of its calls at the cell's geometry over the device time of the kernels that
implement them, in percent."""

from benchmark import roofline

# the kernels that implement its calls, by the names the profiler shows
KERNELS = (r"\b(flash_fwd_wgmma_kernel|flash_fwd_fp32_kernel|flash_bwd_wgmma_kernel"
           r"|flash_bwd_fp32_kernel|flash_bwd_dq_wgmma_kernel|flash_bwd_dq_fp32_kernel"
           r"|flash_bwd_dkv_wgmma_kernel|flash_bwd_dkv_fp32_kernel|delta_kernel"
           r"|dq_finish_kernel)\b")


def read(ctx):
    bound = roofline.k1_ms(ctx["spec"], ctx["batch"], True) * ctx["traced_steps"]
    return roofline.share(bound, ctx["trace"].device_ms(KERNELS))
