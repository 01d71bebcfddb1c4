"""Rows pickled into checkpoints over rows extracted in the window: the
``rows`` of the program's ``extract.checkpoint`` spans over those of its
``extract.rows`` spans. Each checkpoint holds every row of its pass so far."""

from benchmark.program_spans import attr_per


def read(run):
    return attr_per(run, "extract.checkpoint", "extract.rows", "rows")
