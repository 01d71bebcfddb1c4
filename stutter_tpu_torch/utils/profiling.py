"""Tracing / profiling hooks (counterpart of ``stutter_tpu/utils/profiling.py``).

- ``trace(dir)``: a ``torch.profiler`` trace of the block (host activity, and
  the card's kernels where there is a card), written to ``dir`` as a Chrome
  trace JSON (chrome://tracing, Perfetto)
- ``annotate(name)``: a named range for pipeline stages
  (``torch.profiler.record_function``): a span in that trace, and an NVTX
  range under ``torch.autograd.profiler.emit_nvtx``
- ``StageTimer``: lightweight wall-clock per-stage accounting that reports the
  headline audio-sec/sec metric, and keeps each stage as a ``Span`` record.
  On the card a stage's wall time covers only the host's enqueue of its work,
  unless the code inside the stage synchronises (a copy to the host,
  ``torch.cuda.synchronize()``).
- ``span(name, **attrs)``: a span of the process's own recorder, a
  ``StageTimer`` that the extraction loop, the server and the trainer open
  at their layer boundaries. It is off until ``enable()``; while off,
  ``span`` returns one shared no-op context (no clock read, no record).
  ``records()`` returns the spans so far, ``reset()`` forgets them,
  ``disable()`` stops recording. ``record(name, start, end)`` adds a span
  whose start was stamped earlier, on any thread (a request's arrival);
  ``timed(name)`` is a span that reads the clock even while the recorder is
  off, for a caller that keeps the time itself.

The recorder's clock is ``time.perf_counter``. While a ``torch.profiler``
session records, each span also opens ``annotate(name)``, so the spans of
the thread that runs the profiler sit in its trace as ranges, nested as
their parent ids say, beside the card's kernels; each record says whether a
profiler was recording when it started. The recorder keeps at most
``SPAN_CAP`` records in memory and counts the ones it drops; it writes
nothing.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from collections import defaultdict
from datetime import datetime

import torch
import torch.autograd.profiler as _torch_profiler

from stutter_tpu_torch.utils.logging import get_logger

logger = get_logger("profiling")

SPAN_CAP = 1_000_000


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a trace: ``with trace('/tmp/torchtrace'): ...``"""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        os.makedirs(log_dir, exist_ok=True)
        stamp = datetime.now().strftime("%Y%m%d_%H%M%S")
        path = os.path.join(log_dir, f"trace_{stamp}_{os.getpid()}.json")
        prof.export_chrome_trace(path)
        logger.info("profiler trace written to %s", path)


def annotate(name: str):
    """Named region visible in profiler timelines."""
    return torch.profiler.record_function(name)


def _profiler_recording() -> bool:
    """Whether a ``torch.profiler`` session of this process is recording."""
    return _torch_profiler._is_profiler_enabled


class Span:
    """One timed interval: ``name``; ``start`` and ``end`` on
    ``time.perf_counter``; ``id``, and ``parent``, the id of the span open
    around it on its thread (None at the top); ``thread``, the native id of
    the thread that opened it; ``attrs``, its identifiers (batch, round,
    ``req_id``, update) and counts (rows, clips, audio seconds); and
    ``profiled``, whether a profiler was recording when it started.

    As a context manager it times its block. ``set(**attrs)`` adds
    attributes known only inside the block."""

    __slots__ = ("name", "start", "end", "id", "parent", "thread", "attrs", "profiled",
                 "_timer", "_range")

    def __init__(self, timer: StageTimer | None, name: str, attrs: dict):
        self._timer, self.name, self.attrs = timer, name, attrs
        self.start = self.end = 0.0
        self.id = self.parent = self.thread = self._range = None
        self.profiled = False

    @property
    def seconds(self) -> float:
        return self.end - self.start

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self) -> Span:
        timer = self._timer
        if timer is not None:  # recorded: take an id and a parent
            stack = timer._stack()
            self.id = next(timer._ids)
            self.parent = stack[-1] if stack else None
            self.thread = threading.get_native_id()
            stack.append(self.id)
            self.profiled = _profiler_recording()
            if self.profiled:
                self._range = annotate(self.name)
                self._range.__enter__()
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.end = time.perf_counter()
        timer = self._timer
        if timer is not None:
            if self._range is not None:
                self._range.__exit__(*exc)
                self._range = None
            timer._stack().pop()
            timer._keep(self)
        return False


class _NoSpan:
    """The recorder's span while it is off: does nothing."""

    __slots__ = ()

    def __enter__(self) -> _NoSpan:
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass


_NO_SPAN = _NoSpan()


class StageTimer:
    """Accumulate wall time per named stage; report totals and rates. Each
    stage is also kept as a ``Span`` record (``spans``), up to ``cap`` of
    them; ``dropped`` counts the rest."""

    def __init__(self, cap: int = SPAN_CAP):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self.spans: list[Span] = []
        self.dropped = 0
        self.cap = cap
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._lock = threading.Lock()

    def _stack(self) -> list[int]:
        """The ids of the spans open on this thread, innermost last."""
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _keep(self, span: Span) -> None:
        with self._lock:  # spans close on several threads
            self.totals[span.name] += span.end - span.start
            self.counts[span.name] += 1
            if len(self.spans) < self.cap:
                self.spans.append(span)
            else:
                self.dropped += 1

    def stage(self, name: str, **attrs) -> Span:
        """A span of ``name`` around the ``with`` block."""
        return Span(self, name, attrs)

    def record(self, name: str, start: float, end: float, **attrs) -> Span:
        """Keep a span that was timed elsewhere (``start`` and ``end`` on
        ``time.perf_counter``); it has no parent."""
        span = Span(None, name, attrs)
        span._timer, span.start, span.end = self, start, end
        span.id, span.thread = next(self._ids), threading.get_native_id()
        span.profiled = _profiler_recording()
        self._keep(span)
        return span

    def reset(self) -> None:
        """Forget every span and total; ids go on counting."""
        with self._lock:
            self.totals.clear()
            self.counts.clear()
            self.spans = []
            self.dropped = 0

    def report(self, audio_seconds: float | None = None) -> dict:
        out = {
            name: {"seconds": round(t, 3), "calls": self.counts[name]}
            for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1])
        }
        if audio_seconds:
            wall = sum(self.totals.values())
            out["_throughput"] = {
                "audio_seconds": round(audio_seconds, 1),
                "wall_seconds": round(wall, 3),
                "audio_sec_per_sec": round(audio_seconds / wall, 2) if wall else None,
            }
        for name, stats in out.items():
            logger.info("stage %s: %s", name, stats)
        return out


# the process's recorder, off until enable()
RECORDER = StageTimer()
_recording = False


def enable() -> None:
    """Start recording the program's spans in ``RECORDER``."""
    global _recording
    _recording = True


def disable() -> None:
    """Stop recording; the spans kept so far stay."""
    global _recording
    _recording = False


def records() -> list[Span]:
    """The spans recorded so far, in the order they ended."""
    return list(RECORDER.spans)


def reset() -> None:
    """Forget the recorded spans and the count of dropped ones."""
    RECORDER.reset()


def span(name: str, **attrs):
    """A span of the process's recorder around the ``with`` block, or the
    shared no-op while it is off."""
    if not _recording:
        return _NO_SPAN
    return Span(RECORDER, name, attrs)


def timed(name: str, **attrs) -> Span:
    """A span that reads the clock (``.seconds``) whether or not the
    recorder is on, and is recorded only while it is."""
    return Span(RECORDER if _recording else None, name, attrs)


def record(name: str, start: float, end: float, **attrs) -> None:
    """Record a span timed elsewhere (``time.perf_counter``), while on."""
    if _recording:
        RECORDER.record(name, start, end, **attrs)
