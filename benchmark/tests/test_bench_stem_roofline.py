"""The fused stem's roofline reader on synthetic traces: its frozen count
gives the kernel's bounds at the 3 s and 30 s buckets, and it reads a
percent only where the trace's stem launches match the traced batches."""

from __future__ import annotations

import json
from types import SimpleNamespace

import pytest

from benchmark import yardstick
from benchmark.harness import Run, load_module
from benchmark.tests.conftest import REPO

CONFIG = json.loads((REPO / "benchmark" / "configs" / "wavlm-large.json").read_text())
READER = load_module(REPO / "benchmark" / "metrics" / "stem_roofline.py")
BATCHES = [(80, 51_280), (80, 51_280), (40, 51_280)]


class FakeTrace:
    """``kernel_time`` over named launches of given seconds each."""

    def __init__(self, launches: dict[str, tuple[int, float]]):
        self.launches = launches

    def kernel_time(self, pattern):
        hits = [(n, s) for name, (n, s) in self.launches.items() if pattern in name]
        return sum(n * s for n, s in hits), sum(n for n, _ in hits)


def _run(trace, batches=BATCHES):
    return Run(SimpleNamespace(config=CONFIG), {"trace": trace, "trace_batches": batches})


@pytest.mark.parametrize("B,n_samples,bound_ms", [(128, 51_280, 2.035), (12, 481_360, 1.792),
                                                  (80, 51_280, 1.272)])
def test_frozen_count_gives_the_kernel_tables_bounds(B, n_samples, bound_ms):
    flops, nbytes = READER.stem_flops_bytes(CONFIG, B, n_samples)
    assert 1e3 * yardstick.bound_s(flops, nbytes) == pytest.approx(bound_ms, abs=5e-4)
    assert flops / yardstick.BF16_PEAK > nbytes / yardstick.HBM_BYTES_PER_S


def test_count_at_80_clips_of_3s():
    flops, _ = READER.stem_flops_bytes(CONFIG, 80, 51_280)
    assert flops == pytest.approx(1.258e12, rel=1e-3)


def test_reads_the_bound_over_both_kernels_time():
    layer0_s, conv_s = 1e-3, 0.5e-3
    trace = FakeTrace({"void stem_layer0_kernel(float const*)": (3, layer0_s),
                       "void stem_conv_kernel<3>(bf16*)": (12, conv_s),
                       "void stem_conv_kernel<2>(bf16*)": (6, conv_s),
                       "GatedBiasRing": (72, 1.0)})
    least = sum(yardstick.bound_s(*READER.stem_flops_bytes(CONFIG, B, n)) for B, n in BATCHES)
    expected = 100.0 * least / (3 * layer0_s + 18 * conv_s)
    assert READER.read(_run(trace)) == pytest.approx(expected, rel=1e-12)
    assert 0 < expected < 100


@pytest.mark.parametrize("launches", [
    {},  # the plain stem: no fused launch in the trace
    {"GatedBiasRing": (72, 1.0)},
    {"stem_layer0_kernel": (2, 1e-3), "stem_conv_kernel<3>": (12, 1e-3)},
    {"stem_layer0_kernel": (3, 1e-3), "stem_conv_kernel<3>": (12, 1e-3)},
    {"stem_layer0_kernel": (4, 1e-3), "stem_conv_kernel<3>": (24, 1e-3)}])
def test_silent_where_launches_and_batches_disagree(launches):
    assert READER.read(_run(FakeTrace(launches))) is None


def test_silent_without_a_trace_or_batches():
    trace = FakeTrace({"stem_layer0_kernel": (3, 1e-3), "stem_conv_kernel": (18, 1e-3)})
    assert READER.read(_run(None)) is None
    assert READER.read(_run(trace, [])) is None
    assert READER.read(Run(SimpleNamespace(config=CONFIG), {})) is None
