"""Median over the window's batches of the CUDA-event time of the
``pgd_color_attack`` call over the preset's iterations, ms."""

from perfbench.core.readers import span_median


def read(rec):
    ms = span_median(rec, "attack")
    return None if ms is None else ms / rec["iters"]
