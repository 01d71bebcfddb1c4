"""Seconds from the process's start to the first timed work."""


def read(run):
    return run.ctx.setup_s
