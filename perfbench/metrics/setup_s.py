"""Seconds from the process's start to the first timed unit: imports, the
CUDA context, the kernel library, weights, inputs, warm-up."""


def read(rec):
    return rec["setup_s"]
