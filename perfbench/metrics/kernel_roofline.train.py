"""The port's kernels' share of their roofline over the traced part, %."""

from perfbench.core.readers import roofline_share


def read(rec):
    return roofline_share(rec)
