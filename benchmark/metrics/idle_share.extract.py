"""Percent of the traced pass in which no operation ran on the device."""

from benchmark.readers import idle_share


def read(run):
    return idle_share(run)
