"""Host milliseconds a round of the window spent decoding its batches on the
serving loop (the program's ``serve.decode`` spans per ``serve.round``)."""

from benchmark.program_spans import ms_per


def read(run):
    return ms_per(run, "serve.decode", "serve.round")
