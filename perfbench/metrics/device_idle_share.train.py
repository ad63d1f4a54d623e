"""The traced part's device idle share, 1 − busy / wall on the
profiler's timeline, %."""

from perfbench.core.readers import idle_share


def read(rec):
    return idle_share(rec)
