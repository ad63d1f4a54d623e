"""The window's model FLOPs a second over the H100's float32 peak, %."""

from perfbench.core.readers import mfu


def read(rec):
    return mfu(rec)
