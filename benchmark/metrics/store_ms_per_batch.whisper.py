"""Host milliseconds a batch of the window spent in the ``store`` span."""

from benchmark.readers import ms_per_batch


def read(run):
    return ms_per_batch(run, "store")
