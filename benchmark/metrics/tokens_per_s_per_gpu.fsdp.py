"""Tokens trained per second per card in a cell on several cards:
``tokens_per_s_per_gpu``'s reading (the slowest rank's), under a bound of
its own, since a gang's step spreads wider from run to run than one
card's; nothing on one card."""

from benchmark import spec


def read(run):
    if run.chips < 2:
        return None
    return spec.metric_reader("tokens_per_s_per_gpu", run.root).read(run)
