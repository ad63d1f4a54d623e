"""Blocks trained per second of the window."""

from perfbench.core.readers import rate


def read(rec):
    return rate(rec)
