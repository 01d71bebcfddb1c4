"""Clips stored over the wall time of the window's whole passes: what a
Whisper corpus costs, since every clip takes one 30 s window."""

from benchmark.readers import window_rate


def read(run):
    return window_rate(run, "n_clips")
