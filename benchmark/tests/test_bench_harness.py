"""The harness on the CPU at tiny sizes: it finds new cells, mixes,
configurations and metrics by name; its comparison passes the program and
fails the control and each planted fault; a run loads no JAX; and
``run.py`` gives no result without a card or without the program."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest

from benchmark.harness import FORBIDDEN, Run, forbidden_modules, load_module, run_cell
from benchmark.tests.conftest import REPO, tiny_cell, write_root


def run(root, cell, trace=False, control=False, seconds=0.5):
    return run_cell(root, cell, 2**31 + 5, seconds, trace, time.perf_counter(), device="cpu",
                    control=control, bench_dir=root / "benchmark")[0]


# WavLM extraction's rate per second of device time needs a card's trace:
# on the CPU its reader finds nothing and stays silent
@pytest.mark.parametrize("cell,metric", [("tiny-wavlm.mix", None),
                                         ("tiny-whisper.mix", "extract_clips_per_s"),
                                         ("tiny-wavlm.train", "finetune_audio_s_per_s"),
                                         ("tiny-wavlm.serve", "serve_p95_ms")])
def test_program_is_correct_and_reports_its_metrics(tiny_root, cell, metric):
    result = run(tiny_root, cell)
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {metric, "setup_s"} - {None}
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert all(c["value"] <= c["limit"] for c in result["checks"].values())


@pytest.mark.parametrize("cell,spans", [
    ("tiny-wavlm.mix", {"audio_s_per_s.extract", "decode_ms_per_batch.extract",
                        "enqueue_ms_per_batch.extract", "store_ms_per_batch.extract"}),
    ("tiny-wavlm.train", {"enqueue_ms_per_update.finetune", "optim_ms_per_update.finetune"}),
    ("tiny-wavlm.serve", {"clips_per_round.serve", "enqueue_ms_per_batch.serve"})])
def test_traced_run_reports_the_span_metrics(tiny_root, cell, spans):
    result = run(tiny_root, cell, trace=True)
    assert result["correct"], result["checks"]
    # no device on the CPU: the trace's readers find nothing and stay silent
    assert set(result["metrics"]) == spans
    assert result["device"]["busy_s"] == 0


def test_device_rate_reads_the_window_trace_and_is_silent_without_one():
    reader = load_module(REPO / "benchmark" / "metrics" / "extract_audio_s_per_device_s.py")
    passes = [{"audio_s": 300.0}, {"audio_s": 100.0}]
    assert reader.read(Run(None, {"passes": passes,
                                  "window_trace": SimpleNamespace(busy_s=0.5)})) == 800.0
    assert reader.read(Run(None, {"passes": passes, "window_trace": None})) is None
    assert reader.read(Run(None, {"passes": passes,
                                  "window_trace": SimpleNamespace(busy_s=0.0)})) is None


def test_new_config_mix_and_metric_are_files_and_entries(tmp_path):
    """A later change adds a configuration, a mix and a metric as files,
    and a cell as an entry: the harness runs them unchanged."""
    metric = {"name": "clips_per_pass.extract", "unit": "clips", "better": "higher",
              "source": "host_clock", "layer": "model step",
              "moves": "extract_audio_s_per_device_s",
              "workloads": ["tiny-wavlm-b.other-mix"]}
    root = write_root(tmp_path, [tiny_cell("tiny-wavlm-b.other-mix", "tiny-wavlm-b",
                                           "other-mix")], per_layer=[metric])
    bench = root / "benchmark"
    config = json.loads((bench / "configs" / "tiny-wavlm.json").read_text())
    config["intermediate_size"] = 48
    (bench / "configs" / "tiny-wavlm-b.json").write_text(json.dumps(config))
    (bench / "traffic" / "other-mix.json").write_text(json.dumps(
        {"entry": "extract", "split": "train", "clips": 5, "seconds": [0.2, 0.4]}))
    (bench / "metrics" / "clips_per_pass.extract.py").write_text(
        "def read(run):\n    return float(len(run.record['passes'][0]['paths']))\n")
    listing = json.loads((root / "BENCHMARK.json").read_text())
    listing["configs"].append({"name": "tiny-wavlm-b", "source": config["source"],
                               "file": "benchmark/configs/tiny-wavlm-b.json",
                               "reduced": [], "why": "a second tiny WavLM"})
    (root / "BENCHMARK.json").write_text(json.dumps(listing))

    result = run(root, "tiny-wavlm-b.other-mix", trace=True)
    assert result["correct"], result["checks"]
    assert result["metrics"]["clips_per_pass.extract"] == {"value": 5.0, "unit": "clips"}


@pytest.mark.parametrize("cell", ["tiny-wavlm.mix", "tiny-whisper.mix", "tiny-wavlm.train"])
def test_control_is_not_correct(tiny_root, cell):
    """The program's int8 path (turbo, or ``int8_forward`` in training) in
    place of the configuration's precision."""
    result = run(tiny_root, cell, control=True)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("cell,fault", [
    (cell, fault) for cell in ("tiny-wavlm.mix", "tiny-whisper.mix")
    for fault in ("half_batch_mean", "altered_answer", "dropped_row")]
    + [("tiny-wavlm.train", fault) for fault in ("half_batch", "unchanged_state",
                                                  "unchanged_state_from_4")]
    + [("tiny-wavlm.serve", "altered_answer")])
def test_planted_fault_is_not_correct(tiny_root, cell, fault):
    result = run_cell(tiny_root, cell, 2**31 + 5, 0.5, False, time.perf_counter(),
                      device="cpu", fault=fault, bench_dir=tiny_root / "benchmark")[0]
    assert not result["correct"], result["checks"]


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    assert FORBIDDEN == ("jax", "jaxlib", "flax", "stutter_tpu")
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "stutter_tpu_torch_extra", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "stutter_tpu.models", sys)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert forbidden_modules() == ["jax.numpy", "stutter_tpu.models"]


def test_a_run_loads_no_jax(tiny_root):
    code = ("import sys, time; sys.path.insert(0, %r); from pathlib import Path;"
            "from benchmark.harness import run_cell, forbidden_modules;"
            "run_cell(Path(%r), 'tiny-wavlm.mix', 3, 0.2, True, time.perf_counter(),"
            " device='cpu', bench_dir=Path(%r) / 'benchmark');"
            "print(forbidden_modules())") % (str(REPO), str(tiny_root), str(tiny_root))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=tiny_root, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_py_gives_no_result_without_a_card():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "wavlm-large.extract-3s", "--seed", str(2**31 + 3), "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, cwd=REPO,
                         timeout=120)
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_run_py_gives_no_result_without_the_program(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark's folder."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "wavlm-large.extract-3s", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, cwd=tmp_path,
                         timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""
