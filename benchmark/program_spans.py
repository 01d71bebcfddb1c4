"""The program's own spans, for the per-layer metrics that read them.

``stutter_tpu_torch.utils.profiling`` keeps one span recorder a process,
off by default. Importing this module turns it on. The harness loads a
metric's reader only in a ``--trace 1`` run, so the untraced runs, whose
end-to-end metrics are compared, keep it off. Where the program has no
recorder, nothing is turned on and every reader built here returns None.

A reader sees the spans of the run's window: those that started at or
after the window's start (``ctx.started + ctx.setup_s``) while no profiler
was recording, which leaves out set-up, warm-up and the profiled stretch
after the window. Its denominator is the program's own count in the
window: ``extract.submit`` spans (batches), ``serve.round`` spans (rounds)
or ``finetune.step`` spans (updates). The readers read a run on a card
only: they are the card's host path, and a run on the CPU (the harness's
own tests) reports none of them, as it reports no trace.
"""

from __future__ import annotations

import numpy as np

try:
    from stutter_tpu_torch.utils import profiling as _profiling
except ImportError:  # no program: the run fails elsewhere
    _profiling = None

# the program's recorder, where it has one
RECORDER = (_profiling if all(hasattr(_profiling, f) for f in ("enable", "records"))
            else None)
if RECORDER is not None:
    RECORDER.enable()


def window(run) -> list | None:
    """The program's spans of the run's window, or None where the program
    has no recorder or the run is not on a card."""
    if RECORDER is None or run.ctx.setup_s is None or run.ctx.device.type != "cuda":
        return None
    start = run.ctx.started + run.ctx.setup_s
    return [s for s in RECORDER.records() if s.start >= start and not s.profiled]


def ms_per(run, name: str, per: str) -> float | None:
    """Milliseconds of the window's ``name`` spans per ``per`` span of it."""
    spans = window(run)
    if spans is None:
        return None
    n = sum(s.name == per for s in spans)
    return 1e3 * sum(s.end - s.start for s in spans if s.name == name) / n if n else None


def attr_per(run, name: str, per: str, attr: str) -> float | None:
    """The window's ``name`` spans' ``attr`` summed, over the ``per``
    spans' ``attr`` summed."""
    spans = window(run)
    if spans is None:
        return None
    total = sum(s.attrs.get(attr, 0) for s in spans if s.name == per)
    return sum(s.attrs.get(attr, 0) for s in spans if s.name == name) / total if total else None


def percentile_ms(run, name: str, q: float) -> float | None:
    """The ``q``-th percentile of the window's ``name`` spans, in ms."""
    spans = window(run)
    if spans is None:
        return None
    seconds = [s.end - s.start for s in spans if s.name == name]
    return 1e3 * float(np.percentile(seconds, q)) if seconds else None
