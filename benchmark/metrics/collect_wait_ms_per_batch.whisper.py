"""Host milliseconds a Whisper batch of the window waited for its pooled
result (the program's ``extract.collect_wait`` spans per ``extract.submit``)."""

from benchmark.program_spans import ms_per


def read(run):
    return ms_per(run, "extract.collect_wait", "extract.submit")
