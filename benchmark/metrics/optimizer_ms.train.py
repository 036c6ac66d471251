"""Device ms a step of the operations launched inside torch.optim's
``Optimizer.step#AdamW.step`` range (the AdamW update)."""


def read(ctx):
    ms = ctx["host_trace"].within_ms("Optimizer.step#AdamW.step")
    return None if ms is None else ms / ctx["host_steps"]
