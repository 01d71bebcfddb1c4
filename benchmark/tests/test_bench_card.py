"""On the card, at each cell's own size: a short run is correct, and its
controls are not. Skips where torch sees no card.

    python -m pytest benchmark/tests/test_bench_card.py
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from benchmark.tests.conftest import REPO

CELLS = [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


def run(cell: str, *extra: str) -> dict:
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell,
                          "--seed", str(2**31 + 101), "--seconds", "2", "--trace", "0", *extra],
                         capture_output=True, text=True, cwd=REPO, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct(card, cell):
    result = run(cell)
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_program_int8_control_is_not_correct(card, cell):
    """The program's int8 path (turbo, or ``int8_forward`` in fine-tuning)
    in place of the configuration's precision."""
    control = run(cell, "--control")
    assert not control["correct"], control["checks"]


@pytest.mark.card
def test_finetune_window_fault_is_not_correct(card):
    """A state left unchanged from the window's first update on, set-up's
    three updates left alone."""
    result = run("wavlm-large.finetune-3s", "--fault", "unchanged_state_from_4")
    assert not result["correct"], result["checks"]
