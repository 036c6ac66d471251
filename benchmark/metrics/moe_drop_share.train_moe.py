"""The share of the expert layers' choices dropped for want of capacity, in
percent: the program's per-expert counters (``MoEMlp.counts/<layer>``,
kept on the card while the profiler traced and read once after), dropped
over routed, every layer and traced step together. None where the program
keeps no such counters. A reading of the routing's quality, not of a cost:
the capacity fixes every shape, so the share moves no time, and the
``train_img_per_s`` its entry names is only the cell's one rate."""

from benchmark import roofline_moe


def read(ctx):
    return roofline_moe.drop_share()
