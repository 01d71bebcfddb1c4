"""Audio seconds stored in the window's whole passes over the seconds in
which the device ran their work (the union of its kernels and copies in the
window's trace): the card's rate were the host to keep it fed."""


def read(run):
    trace = run.record.get("window_trace")
    if trace is None or trace.busy_s <= 0:
        return None
    return sum(p["audio_s"] for p in run.record["passes"]) / trace.busy_s
