"""Device time of the library's sort and top-k kernels (the large-k graph
selections) as a percentage of the traced busy time."""

from perfbench.core.readers import busy_share


def read(rec):
    return busy_share(rec, "select_s")
