"""Host milliseconds an update of the window spent enqueueing the forward
and the loss (the program's ``finetune.forward`` spans per ``finetune.step``)."""

from benchmark.program_spans import ms_per


def read(run):
    return ms_per(run, "finetune.forward", "finetune.step")
