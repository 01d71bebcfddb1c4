"""Host milliseconds a Whisper batch of the window spent writing checkpoints
(the program's ``extract.checkpoint`` spans per ``extract.submit``)."""

from benchmark.program_spans import ms_per


def read(run):
    return ms_per(run, "extract.checkpoint", "extract.submit")
