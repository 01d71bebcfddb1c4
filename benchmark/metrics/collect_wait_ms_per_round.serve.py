"""Host milliseconds a round of the window waited for its batches' pooled
results (the program's ``serve.collect_wait`` spans per ``serve.round``)."""

from benchmark.program_spans import ms_per


def read(run):
    return ms_per(run, "serve.collect_wait", "serve.round")
