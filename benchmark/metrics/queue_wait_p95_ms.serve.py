"""The 95th percentile, over the window's requests, of the time from a
request's arrival in the server's queue to the start of its round's submit
(the program's ``serve.wait`` spans)."""

from benchmark.program_spans import percentile_ms


def read(run):
    return percentile_ms(run, "serve.wait", 95)
