"""The window's model FLOPs (three forwards of the trained encoder and one
of the frozen stem, at true lengths) over its wall, as a percent of the
bf16 peak."""

from benchmark.readers import train_mfu


def read(run):
    return train_mfu(run)
