"""Host milliseconds an update of the window spent in ``MultiAdamW.step``."""

from benchmark.readers import ms_per


def read(run):
    return ms_per(run, "optim", run.record.get("updates", 0))
