"""Tracing / profiling hooks (counterpart of ``stutter_tpu/utils/profiling.py``).

- ``trace(dir)``: a ``torch.profiler`` trace of the block (host activity, and
  the card's kernels where there is a card), written to ``dir`` as a Chrome
  trace JSON (chrome://tracing, Perfetto)
- ``annotate(name)``: a named range for pipeline stages
  (``torch.profiler.record_function``): a span in that trace, and an NVTX
  range under ``torch.autograd.profiler.emit_nvtx``
- ``StageTimer``: lightweight wall-clock per-stage accounting that reports the
  headline audio-sec/sec metric. On the card a stage's wall time covers only
  the host's enqueue of its work, unless the code inside the stage
  synchronises (a copy to the host, ``torch.cuda.synchronize()``).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from datetime import datetime

from stutter_tpu_torch.utils.logging import get_logger

logger = get_logger("profiling")


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a trace: ``with trace('/tmp/torchtrace'): ...``"""
    import torch
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
    import torch

    return torch.profiler.record_function(name)


class StageTimer:
    """Accumulate wall time per named stage; report totals and rates."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

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
