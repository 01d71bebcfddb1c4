"""Host milliseconds a batch of the window spent in the extractor's ``submit``."""

from benchmark.readers import ms_per


def read(run):
    return ms_per(run, "submit", run.record.get("span_calls", {}).get("submit", 0))
