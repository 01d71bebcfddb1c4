"""The window's model FLOPs over its wall, as a percent of the bf16 peak."""

from benchmark.readers import mfu


def read(run):
    return mfu(run)
