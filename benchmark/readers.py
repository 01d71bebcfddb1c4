"""What the metric readers share: rates over the window, spans per batch,
and a kernel's roofline share over the traced stretch."""

from __future__ import annotations

from benchmark import yardstick


def window_rate(run, key: str) -> float | None:
    """``key`` summed over the window's whole passes, per second of their wall."""
    passes = run.record.get("passes") or []
    wall = sum(p["wall_s"] for p in passes)
    return sum(p[key] for p in passes) / wall if wall > 0 else None


def ms_per(run, span: str, count: int) -> float | None:
    """A span's host milliseconds per unit of the window (``count`` of them)."""
    if span not in run.record.get("spans", {}) or not count:
        return None
    return 1e3 * run.record["spans"][span] / count


def ms_per_batch(run, span: str) -> float | None:
    """A span's host milliseconds per batch of the window."""
    return ms_per(run, span, len(run.record.get("batches", [])))


def roofline(run, launch_key: str, patterns: tuple[str, ...], calls_of_batch) -> float | None:
    """Percent of the kernel's summed device time that its least time is:
    the bound of every call in the traced stretch, at each call's shape
    (``calls_of_batch(config, B, n_samples)`` -> [(operations, bytes)]),
    over the profiler's time for the kernels whose names hold one of
    ``patterns`` (a call's launches). None where the stretch ran no such
    kernel, or where the calls counted from the batches, the wrapper's
    launches and the launches of the first pattern in the trace disagree."""
    trace = run.record.get("trace")
    if trace is None:
        return None
    seconds = sum(trace.kernel_time(p)[0] for p in patterns)
    launches = trace.kernel_time(patterns[0])[1]
    if not launches:
        return None
    calls = [c for B, n in run.record["trace_batches"]
             for c in calls_of_batch(run.ctx.config, B, n)]
    if not len(calls) == launches == run.record["trace_launches"][launch_key]:
        return None
    least = sum(yardstick.bound_s(ops, nbytes) for ops, nbytes in calls)
    return 100.0 * least / seconds


def idle_share(run) -> float | None:
    """Percent of the traced stretch in which no operation ran on the device."""
    trace = run.record.get("trace")
    if trace is None or trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)


def train_mfu(run) -> float | None:
    """Percent of the bf16 peak that the window's model FLOPs are, over its wall."""
    window = run.record.get("window")
    if not window or window["wall_s"] <= 0 or run.ctx.device.type != "cuda":
        return None
    return 100.0 * window["flops"] / (window["wall_s"] * yardstick.BF16_PEAK)


def mfu(run) -> float | None:
    """Percent of the bf16 peak that the window's model FLOPs are, over its wall:
    the family's frozen count for every clip stored."""
    passes = run.record.get("passes") or []
    wall = sum(p["wall_s"] for p in passes)
    if wall <= 0 or run.ctx.device.type != "cuda":
        return None
    clips, config, family = run.record["clips"], run.ctx.config, run.ctx.family
    flops = sum(family.clip_flops(config, clips[path]) for p in passes for path in p["paths"])
    return 100.0 * flops / (wall * yardstick.BF16_PEAK)
