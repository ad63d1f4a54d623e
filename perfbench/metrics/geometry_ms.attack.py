"""Median over the window's batches of the CUDA-event time of the
family's ``plan`` call (the geometry), ms."""

from perfbench.core.readers import span_median


def read(rec):
    return span_median(rec, "plan")
