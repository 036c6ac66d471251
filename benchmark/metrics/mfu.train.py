"""The train step's products (forward and backward: three times the
forward's) over the window's wall time, as a share of the card's bf16
peak."""

from benchmark import roofline


def read(ctx):
    return roofline.train_mfu(ctx)
