"""True (unpadded) audio seconds of the window's updates over its wall,
which ends with a wait for the device after the last update."""


def read(run):
    window = run.record.get("window")
    return window["audio_s"] / window["wall_s"] if window and window["wall_s"] > 0 else None
