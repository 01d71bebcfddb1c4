"""The readers of the program's spans (``program_spans.py``) on synthetic
records: each reads its window's spans per batch, round or update; each
returns None where the program has no recorder, as on a program that
predates it, and on a run that is not on a card."""

from __future__ import annotations

import importlib
import sys
import types
from types import SimpleNamespace

import pytest
import torch

from benchmark.harness import Run, load_module
from benchmark.tests.conftest import REPO
from stutter_tpu_torch.utils import profiling

STARTED, SETUP_S = 100.0, 10.0  # the window starts at 110 s

# name -> what its reader reads from the spans below
EXPECTED = {
    "collect_wait_ms_per_batch.extract": 2.0,
    "collect_wait_ms_per_batch.whisper": 2.0,
    "checkpoint_ms_per_batch.extract": 10.0,
    "checkpoint_ms_per_batch.whisper": 10.0,
    "checkpoint_rows_per_row.extract": 0.75,
    "queue_wait_p95_ms.serve": 19.05,  # numpy's 95th percentile of 1, 2, ..., 20 ms
    "decode_ms_per_round.serve": 10.0,
    "collect_wait_ms_per_round.serve": 3.0,
    "forward_ms_per_update.finetune": 50.0,
    "backward_ms_per_update.finetune": 100.0,
}


def _spans():
    """(name, start, end, attrs) in the window, and before it."""
    out = [("extract.submit", 105.0, 105.1, {}), ("extract.collect_wait", 105.1, 106.1, {}),
           ("serve.round", 105.0, 106.0, {}), ("finetune.step", 105.0, 106.0, {})]
    for k in range(4):  # four batches
        t = 110.0 + k
        out += [("extract.submit", t, t + 0.1, {"batch": k}),
                ("extract.collect_wait", t + 0.1, t + 0.102, {}),
                ("extract.rows", t + 0.2, t + 0.3, {"rows": 80})]
    out += [("extract.checkpoint", 111.5, 111.51, {"rows": 80}),
            ("extract.checkpoint", 113.5, 113.53, {"rows": 160})]
    for k in range(20):  # twenty requests, waiting 1..20 ms
        out.append(("serve.wait", 120.0 + k, 120.0 + k + (k + 1) / 1e3, {"req_id": str(k)}))
    for k in range(4):  # four rounds, two batches each
        t = 130.0 + k
        out += [("serve.round", t, t + 0.5, {"round": k + 1}),
                ("serve.decode", t + 0.1, t + 0.105, {}),
                ("serve.decode", t + 0.2, t + 0.205, {}),
                ("serve.collect_wait", t + 0.3, t + 0.303, {})]
    for k in range(2):  # two updates
        t = 140.0 + k
        out += [("finetune.step", t, t + 0.5, {"update": k + 1}),
                ("finetune.forward", t, t + 0.05, {}),
                ("finetune.backward", t + 0.05, t + 0.15, {})]
    return out


@pytest.fixture(scope="module", autouse=True)
def program_spans():
    """``benchmark.program_spans``, imported here and not at collection,
    since importing it turns the process's recorder on; off and empty
    again after this module's tests."""
    module = importlib.reload(importlib.import_module("benchmark.program_spans"))
    yield module
    profiling.disable()
    profiling.reset()


@pytest.fixture
def recorded():
    """The recorder holding ``_spans()``, and one span of the window that a
    profiler recorded (left out of every reading)."""
    profiling.reset()
    for name, start, end, attrs in _spans():
        profiling.RECORDER.record(name, start, end, **attrs)
    for name in ("extract.collect_wait", "extract.checkpoint", "serve.decode",
                 "serve.collect_wait", "serve.wait", "finetune.forward", "finetune.backward"):
        profiling.RECORDER.record(name, 150.0, 160.0, rows=1000).profiled = True
    yield
    profiling.reset()


def _run(device="cuda"):
    ctx = SimpleNamespace(started=STARTED, setup_s=SETUP_S, device=torch.device(device))
    return Run(ctx, {})


def _reader(name):
    return load_module(REPO / "benchmark" / "metrics" / f"{name}.py")


def test_importing_the_readers_turns_the_recorder_on(program_spans):
    assert program_spans.RECORDER is profiling
    assert profiling._recording


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_reads_the_windows_spans(recorded, name):
    assert _reader(name).read(_run()) == pytest.approx(EXPECTED[name], rel=1e-9)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_is_silent_off_the_card_and_on_an_empty_window(recorded, name):
    assert _reader(name).read(_run("cpu")) is None
    profiling.reset()
    assert _reader(name).read(_run()) is None


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_is_silent_without_the_programs_recorder(recorded, monkeypatch, program_spans,
                                                        name):
    """A program whose ``utils.profiling`` has no recorder, as before it
    had one: importing the readers turns nothing on and each reads None."""
    bare = types.ModuleType(profiling.__name__)
    bare.trace, bare.annotate, bare.StageTimer = (profiling.trace, profiling.annotate,
                                                  profiling.StageTimer)
    monkeypatch.setitem(sys.modules, profiling.__name__, bare)
    monkeypatch.setattr(sys.modules["stutter_tpu_torch.utils"], "profiling", bare)
    try:
        importlib.reload(program_spans)
        assert program_spans.RECORDER is None
        assert _reader(name).read(_run()) is None
    finally:
        monkeypatch.undo()
        importlib.reload(program_spans)
    assert program_spans.RECORDER is profiling
