"""Audio seconds stored over the wall time of the window's whole passes, in
a run whose window nothing profiles."""

from benchmark.readers import window_rate


def read(run):
    return window_rate(run, "audio_s")
