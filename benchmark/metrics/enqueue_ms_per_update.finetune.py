"""Host milliseconds an update of the window spent in ``FinetuneTrainer.step``."""

from benchmark.readers import ms_per


def read(run):
    return ms_per(run, "enqueue", run.record.get("updates", 0))
