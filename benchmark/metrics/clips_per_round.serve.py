"""Clips the server answered a round in the window: ``stats()``'s served
over its rounds."""


def read(run):
    stats = run.record.get("stats") or {}
    return stats["served"] / stats["rounds"] if stats.get("rounds") else None
