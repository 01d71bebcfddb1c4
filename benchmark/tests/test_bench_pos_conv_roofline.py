"""The positional conv kernel's roofline reader on synthetic traces: its
frozen count gives the kernel's bounds at the main path's shapes, at the
conv's true width, and it reads a percent only where the trace's launches
match the traced batches."""

from __future__ import annotations

import json
from types import SimpleNamespace

import pytest

from benchmark import yardstick
from benchmark.harness import Run, load_module
from benchmark.tests.conftest import REPO

CONFIGS = {name: json.loads((REPO / "benchmark" / "configs" / f"{name}.json").read_text())
           for name in ("wav2vec2-xls-r-2b", "wavlm-large")}
READER = load_module(REPO / "benchmark" / "metrics" / "pos_conv_roofline.py")
BATCHES = [(12, 322_640), (8, 481_360), (8, 481_360)]  # the 20 s and 30 s buckets
NAME_120 = ("void (anonymous namespace)::pos_conv_kernel<120>(__nv_bfloat16 const*, "
            "__nv_bfloat16 const*, float const*, __nv_bfloat16*, int, int, int, int)")


class FakeTrace:
    """``kernel_time`` over named launches of given seconds each."""

    def __init__(self, launches: dict[str, tuple[int, float]]):
        self.launches = launches

    def kernel_time(self, pattern):
        hits = [(n, s) for name, (n, s) in self.launches.items() if pattern in name]
        return sum(n * s for n, s in hits), sum(n for n, _ in hits)


def _run(trace, batches=BATCHES, config="wav2vec2-xls-r-2b"):
    return Run(SimpleNamespace(config=CONFIGS[config]),
               {"trace": trace, "trace_batches": batches})


@pytest.mark.parametrize("config,B,L,bound_ms", [
    ("wav2vec2-xls-r-2b", 8, 1504, 0.7176), ("wav2vec2-xls-r-2b", 12, 1008, 0.7214),
    ("wavlm-large", 80, 160, 0.2171)])
def test_frozen_count_gives_the_kernels_bounds(config, B, L, bound_ms):
    flops, nbytes = READER.pos_conv_flops_bytes(CONFIGS[config], B, L)
    D = CONFIGS[config]["hidden_size"]
    assert flops == 2 * B * L * D * (D // 16) * 128  # the true width: 120 or 64 a group
    assert nbytes == 4 * B * L * D + 2 * D * (D // 16) * 128 + 4 * D
    assert 1e3 * yardstick.bound_s(flops, nbytes) == pytest.approx(bound_ms, abs=5e-5)
    assert flops / yardstick.BF16_PEAK > nbytes / yardstick.HBM_BYTES_PER_S


def test_reads_the_bound_over_the_kernels_time():
    seconds = 1.2e-3
    trace = FakeTrace({NAME_120: (3, seconds), "stem_conv_kernel<3>": (12, 1e-3),
                       "KeyPadding, 120": (144, 1e-4)})
    least = 1e-3 * (0.7214 + 2 * 0.7176)
    got = READER.read(_run(trace))
    assert got == pytest.approx(100.0 * least / (3 * seconds), rel=1e-4)
    assert 0 < got < 100


def test_reads_the_3s_bucket_at_width_64():
    batches = [(80, 51_280), (80, 51_280)]
    trace = FakeTrace({"pos_conv_kernel<64>": (2, 0.4e-3)})
    got = READER.read(_run(trace, batches, "wavlm-large"))
    assert got == pytest.approx(100.0 * 2 * 0.2171e-3 / (2 * 0.4e-3), rel=1e-3)


@pytest.mark.parametrize("launches", [
    {},  # the parent: cuDNN's conv, no kernel of this name
    {"implicit_convolve_sgemm": (3, 1e-2), "GatedBiasRing": (72, 1.0)},
    {NAME_120: (2, 1e-3)},
    {NAME_120: (4, 1e-3)}])
def test_silent_where_launches_and_batches_disagree(launches):
    assert READER.read(_run(FakeTrace(launches))) is None


def test_silent_without_a_trace_or_batches():
    assert READER.read(_run(None)) is None
    assert READER.read(_run(FakeTrace({NAME_120: (3, 1e-3)}), [])) is None
    assert READER.read(Run(SimpleNamespace(config=CONFIGS["wavlm-large"]), {})) is None
