"""Host milliseconds an update of the window spent in ``torch.autograd.grad``
(the program's ``finetune.backward`` spans per ``finetune.step``)."""

from benchmark.program_spans import ms_per


def read(run):
    return ms_per(run, "finetune.backward", "finetune.step")
