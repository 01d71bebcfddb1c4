"""Spans around the calls into the program's layers, and the reading of a
``torch.profiler`` trace: kernel time by name, the device's busy time, the
longest idle gaps and what the host was doing in each.

Spans are the benchmark's own: a ``Spans`` object wraps a callable of the
program so that each call adds its host seconds under a name and, inside a
profiled stretch, shows in the trace as a ``record_function`` range of that
name. Nothing here changes what the program computes.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch

SPAN_PREFIX = "bench."


class Spans:
    """Host seconds and call counts by span name."""

    def __init__(self):
        self.seconds: dict[str, float] = defaultdict(float)
        self.calls: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        with torch.profiler.record_function(SPAN_PREFIX + name):
            try:
                yield
            finally:
                self.seconds[name] += time.perf_counter() - t0
                self.calls[name] += 1

    def wrap(self, name: str, fn):
        def wrapped(*args, **kwargs):
            with self.span(name):
                return fn(*args, **kwargs)
        return wrapped

    def wrap_iter(self, name: str, make_iter):
        """``make_iter``'s iterator, each ``next`` under the span ``name``."""
        def wrapped(*args, **kwargs):
            it = iter(make_iter(*args, **kwargs))
            while True:
                with self.span(name):
                    try:
                        item = next(it)
                    except StopIteration:
                        return
                yield item
        return wrapped


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    merged: list[list[float]] = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [(a, b) for a, b in merged]


class TraceSummary:
    """What the readers take from one profiled stretch (times in seconds)."""

    def __init__(self, prof, stretch_s: float, top: int = 10):
        device, spans, stretch = [], [], None
        cuda = torch.autograd.DeviceType.CUDA
        # the raw events: building the profiler's event tree takes minutes
        for e in prof.profiler.kineto_results.events():
            name, start = e.name(), e.start_ns() / 1e9
            end = start + e.duration_ns() / 1e9
            if e.device_type() == cuda:
                if not e.is_user_annotation():  # kernels, copies and sets only
                    device.append((name, start, end))
            elif name == SPAN_PREFIX + "stretch":
                stretch = (start, end)
            elif name.startswith(SPAN_PREFIX):
                spans.append((name[len(SPAN_PREFIX):], start, end))
        self.window_s = stretch_s
        self.kernels: dict[str, list[float]] = defaultdict(list)
        for name, start, end in device:
            self.kernels[name].append(end - start)
        busy = _union([(s, e) for _, s, e in device])
        self.busy_s = sum(e - s for s, e in busy)
        by_total = sorted(((name, sum(d)) for name, d in self.kernels.items()),
                          key=lambda x: -x[1])
        self.device_ops = [[name, total] for name, total in by_total[:top]]
        self.idle_gaps = self._gaps(busy, spans, stretch, top)

    @staticmethod
    def _gaps(busy, spans, stretch, top: int) -> list:
        """The longest stretches with no device work, each named by the
        innermost benchmark span around its middle ("host" where none)."""
        if stretch is None or not busy:
            return []
        edges = [stretch[0]] + [t for iv in busy for t in iv] + [stretch[1]]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        named = []
        for a, b in gaps:
            mid = (a + b) / 2
            around = [(e - s, name) for name, s, e in spans if s <= mid <= e]
            named.append([min(around)[1] if around else "host", b - a])
        return sorted(named, key=lambda x: -x[1])[:top]

    def kernel_time(self, pattern: str) -> tuple[float, int]:
        """(summed seconds, launches) of the kernels whose name holds ``pattern``."""
        times = [t for name, ts in self.kernels.items() if pattern in name for t in ts]
        return sum(times), len(times)


@contextlib.contextmanager
def profiled(out: dict):
    """Profile the block as one stretch; ``out["trace"]`` gets its summary."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        with torch.profiler.record_function(SPAN_PREFIX + "stretch"):
            yield
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        stretch_s = time.perf_counter() - t0
    out["trace"] = TraceSummary(prof, stretch_s)


@contextlib.contextmanager
def device_profiled(out: dict, on: bool = True):
    """Record the device's kernels and copies over the block, and no host
    ops, so that the host runs as it would unprofiled but for CUPTI's
    callbacks; ``out["trace"]`` gets its summary. Does nothing where
    ``on`` is false."""
    if not on:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        stretch_s = time.perf_counter() - t0
    out["trace"] = TraceSummary(prof, stretch_s)
