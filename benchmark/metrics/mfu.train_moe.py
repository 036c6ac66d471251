"""The train step's products (forward and backward: three times the
forward's, each expert layer at k experts a token without the capacity's
padding) over the window's wall time, as a share of the card's bf16
peak."""

from benchmark import roofline_moe


def read(ctx):
    return roofline_moe.train_mfu(ctx)
