"""stutter_tpu_torch.utils against stutter_tpu.utils on the CPU: the per-run
logfile (format, idempotence, fallback, one file a run, one under two
ranks), StageTimer's report under one fake clock, the profiler trace, and
the FLOP models integer for integer."""

import glob
import importlib
import itertools
import json
import logging
import os
import re
import sys
import time

import pytest
import torch

from stutter_tpu.models import WavLMConfig as JaxWavLMConfig
from stutter_tpu.models import WhisperConfig as JaxWhisperConfig
from stutter_tpu.utils import benchmarking as jbench
from stutter_tpu.utils import logging as jlog
from stutter_tpu.utils import profiling as jprof
from stutter_tpu_torch.models.wavlm import WavLMConfig
from stutter_tpu_torch.models.whisper import WhisperConfig
from stutter_tpu_torch.utils import benchmarking as bench
from stutter_tpu_torch.utils import logging as tlog
from stutter_tpu_torch.utils import profiling as prof

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLI_TAGS = {"extract_wavlm": "wavlm_embedding", "extract_whisper": "whisper_embedding",
            "finetune": "finetune", "predict": "predict", "serve": "serve",
            "train": "model_training", "train_grid": "model_training_grid"}


def _reset_logging() -> None:
    for module, name in ((jlog, "stutter_tpu"), (tlog, "stutter_tpu_torch")):
        module._configured = False
        logger = logging.getLogger(name)
        for h in list(logger.handlers):
            logger.removeHandler(h)
            h.close()
        logger.setLevel(logging.NOTSET)
    tlog.inherit_logfile(None)


@pytest.fixture(autouse=True)
def fresh_logging(tmp_path, monkeypatch):
    """Each test in its own working directory, both packages' logging unset."""
    monkeypatch.chdir(tmp_path)
    _reset_logging()
    yield
    _reset_logging()


def _line(name: str, level: str, message: str) -> str:
    """A pattern of one logged line: "2026-10-18 01:02:03,456 - name - LEVEL - message"."""
    return r"\d{4}-\d\d-\d\d \d\d:\d\d:\d\d,\d{3} - " + f"{name} - {level} - {message}"


def _logfiles(root, tag: str = "*") -> list:
    return sorted(glob.glob(os.path.join(str(root), "logs", f"{tag}_*.log")))


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    """A seeded tiny WavLM as an HF checkpoint directory (chip_smoke's writer,
    no ``transformers``) and a corpus of five short clips."""
    from pathlib import Path

    import chip_smoke as smoke
    from stutter_tpu.audio.synthetic import make_synthetic_corpus
    from stutter_tpu_torch.weights.convert import init_wavlm

    root = Path(tmp_path_factory.mktemp("utils_ckpt"))
    cfg = WavLMConfig.tiny()
    seeded = init_wavlm(cfg, torch.Generator().manual_seed(0))
    g, v = smoke.fold_pos_conv(seeded)
    smoke.write_checkpoint(torch, root / "wavlm", cfg, smoke.wavlm_hf_state(seeded, g, v, False),
                           "safetensors", do_normalize=cfg.do_normalize)
    make_synthetic_corpus(str(root / "corpus"), n_per_split={"train": 5},
                          duration_range=(0.3, 0.9), seed=4)
    return str(root / "wavlm"), str(root / "corpus")


def _extract_argv(ckpt: str, corpus: str, out: str) -> list:
    return ["--data_dir", corpus, "--output_dir", out, "--model_path", ckpt, "--device", "cpu",
            "--preset", "fidelity", "--split", "train", "--batch_size", "4", "--audio_budget",
            "4", "--max_length", "1.0"]


# ---------------------------------------------------------------------------
# utils/logging.py
# ---------------------------------------------------------------------------


def test_log_lines_match_jax(tmp_path):
    """The same LogRecord through JAX's handlers and the port's gives the same
    text; both write one logfile named by the tag."""
    jax_logger = jlog.setup_logging("wavlm_embedding", log_dir=str(tmp_path / "jax"))
    port_logger = tlog.setup_logging("wavlm_embedding", log_dir=str(tmp_path / "port"))
    assert port_logger is logging.getLogger("stutter_tpu_torch")
    assert tlog.get_logger("cli.x") is logging.getLogger("stutter_tpu_torch.cli.x")
    assert port_logger.level == jax_logger.level == logging.INFO
    record = logging.LogRecord("stutter_tpu.cli", logging.WARNING, __file__, 1,
                               "%d clips in %s", (3, "train"), None)
    jax_lines = [h.format(record) for h in jax_logger.handlers]
    port_lines = [h.format(record) for h in port_logger.handlers]
    assert len(jax_lines) == len(port_lines) == 2
    assert set(jax_lines) == set(port_lines) and len(set(port_lines)) == 1
    assert re.fullmatch(_line(r"stutter_tpu\.cli", "WARNING", "3 clips in train"),
                        port_lines[0])
    assert [type(h) for h in port_logger.handlers] == [type(h) for h in jax_logger.handlers]
    port_file, = glob.glob(str(tmp_path / "port" / "wavlm_embedding_*.log"))
    assert tlog.logfile() == os.path.abspath(port_file)
    assert re.fullmatch(r"wavlm_embedding_\d{8}_\d{6}\.log", os.path.basename(port_file))
    assert len(glob.glob(str(tmp_path / "jax" / "wavlm_embedding_*.log"))) == 1


def test_setup_logging_twice_adds_no_handler(tmp_path):
    logger = tlog.setup_logging("finetune")
    handlers = list(logger.handlers)
    assert tlog.setup_logging("finetune") is logger
    assert tlog.setup_logging("serve") is logger
    assert logger.handlers == handlers and len(handlers) == 2
    assert len(_logfiles(tmp_path)) == 1 and _logfiles(tmp_path, "finetune")


def test_unwritable_log_dir_warns_and_logs_to_stderr(tmp_path, capsys):
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("")
    logger = tlog.setup_logging("serve", log_dir=str(blocker / "logs"))
    assert [type(h) for h in logger.handlers] == [logging.StreamHandler]
    assert tlog.logfile() is None
    assert "could not create log dir" in capsys.readouterr().err
    logger.info("still logging")
    assert "still logging" in capsys.readouterr().err


@pytest.mark.parametrize("module", sorted(CLI_TAGS))
def test_every_cli_sets_up_logging_with_the_jax_tag(monkeypatch, module):
    """Each of the seven CLIs calls utils.logging.setup_logging first, with the
    JAX CLI's tag (read from its source), and none calls basicConfig."""
    cli = importlib.import_module(f"stutter_tpu_torch.cli.{module}")
    with open(os.path.join(REPO, "stutter_tpu", "cli", f"{module}.py")) as f:
        jax_tag, = re.findall(r'setup_logging\("(\w+)"\)', f.read())
    assert jax_tag == CLI_TAGS[module]
    with open(cli.__file__) as f:
        assert "basicConfig" not in f.read()
    tags = []

    class Stop(Exception):
        pass

    def record(tag):
        tags.append(tag)
        raise Stop

    monkeypatch.setattr(cli, "setup_logging", record)
    argv = {"extract_wavlm": ["--data_dir", "d", "--output_dir", "o"],
            "extract_whisper": ["--data_dir", "d", "--output_dir", "o"],
            "finetune": ["--data_dir", "d", "--results_dir", "o"],
            "predict": ["--audio_dir", "d", "--classifier_model", "m_model.npz"],
            "serve": [],
            "train": ["--embeddings_dir", "d", "--results_dir", "o"],
            "train_grid": ["--embeddings_dir", "d", "--results_dir", "o"]}[module]
    with pytest.raises(Stop):
        cli.main(argv + ["--device", "cpu"])
    assert tags == [jax_tag]


def test_extract_wavlm_cli_leaves_one_logfile(tmp_path, tiny_ckpt):
    from stutter_tpu_torch.cli import extract_wavlm

    ckpt, corpus = tiny_ckpt
    assert extract_wavlm.main(_extract_argv(ckpt, corpus, str(tmp_path / "out"))) == 0
    path, = _logfiles(tmp_path)
    assert os.path.basename(path).startswith("wavlm_embedding_")
    with open(path) as f:
        lines = f.read().splitlines()
    model_lines = [line for line in lines if " - INFO - model: " in line]
    assert len(model_lines) == 1
    assert re.fullmatch(_line(r"stutter_tpu_torch\.cli\.extract_wavlm", "INFO", "model: .*"),
                        model_lines[0])
    # the package's module loggers write there too
    assert any(" - stutter_tpu_torch.extract." in line for line in lines)


def test_train_grid_cli_leaves_one_logfile(tmp_path):
    from stutter_tpu_torch.cli import train_grid
    from tests.test_torch_downstream_train import _write_store

    store = str(tmp_path / "store")
    _write_store(store, {"train": (12, 8, 6), "test": (4, 3, 3), "devel": (4, 3, 3)})
    assert train_grid.main(["--embeddings_dir", store, "--results_dir", str(tmp_path / "grid"),
                            "--model_type", "wavlm", "--include_jax_heads",
                            "--no_augmentation", "--use_class_weights", "false",
                            "--device", "cpu"]) == 0
    path, = _logfiles(tmp_path)
    assert os.path.basename(path).startswith("model_training_grid_")
    with open(path) as f:
        assert " - stutter_tpu_torch.cli.train_grid - INFO - BEST: " in f.read()


def test_two_rank_cli_leaves_one_logfile(tmp_path, tiny_ckpt):
    """``--devices 2`` on the CPU: the launching process owns the logfile,
    rank 0 appends its lines there, rank 1 logs to stderr only."""
    from tests.test_torch_distributed import run_bounded

    ckpt, corpus = tiny_ckpt
    argv = [sys.executable, "-m", "stutter_tpu_torch.cli.extract_wavlm",
            *_extract_argv(ckpt, corpus, str(tmp_path / "out")), "--devices", "2"]
    out, = run_bounded([argv], cwd=str(tmp_path))
    assert out.count(" - INFO - model: ") == 2  # both ranks, on stderr
    path, = _logfiles(tmp_path)
    assert os.path.basename(path).startswith("wavlm_embedding_")
    with open(path) as f:
        text = f.read()
    assert text.count(" - INFO - spawning 2 ranks") == 1  # the launcher's line
    assert text.count(" - INFO - model: ") == 1           # rank 0's
    assert os.path.isfile(tmp_path / "out" / "train" / "embedding_metadata.csv")


# ---------------------------------------------------------------------------
# utils/profiling.py
# ---------------------------------------------------------------------------


def _fake_clock():
    ticks = itertools.accumulate(itertools.cycle((0.0123456, 0.5, 1.23456789, 0.0004)),
                                 initial=100.0)
    return lambda: next(ticks)


def _timed_stages(timer) -> None:
    for name in ("decode", "forward", "forward", "store", "forward", "decode"):
        with timer.stage(name):
            pass


@pytest.mark.parametrize("audio_seconds", [None, 0.0, 37.25])
def test_stage_timer_report_matches_jax(monkeypatch, audio_seconds):
    reports = []
    for module in (jprof, prof):
        monkeypatch.setattr(time, "perf_counter", _fake_clock())
        timer = module.StageTimer()
        _timed_stages(timer)
        reports.append(timer.report(audio_seconds=audio_seconds))
    assert reports[1] == reports[0]
    assert json.dumps(reports[1]) == json.dumps(reports[0])  # the same key order
    assert list(reports[1])[:3] == ["forward", "decode", "store"]


def test_trace_writes_a_chrome_trace_with_the_annotation(tmp_path, caplog):
    out = tmp_path / "trace"
    with caplog.at_level(logging.INFO, logger="stutter_tpu_torch.profiling"):
        with prof.trace(str(out)):
            with prof.annotate("encode_batch"):
                torch.ones(64, 64) @ torch.ones(64, 64)
    path, = glob.glob(str(out / "*.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "encode_batch" for e in events)
    assert f"profiler trace written to {path}" in caplog.text


# ---------------------------------------------------------------------------
# utils/benchmarking.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batch", [1, 128])
@pytest.mark.parametrize("preset,n_samples", [("large", 51_280), ("large", 480_000),
                                              ("base", 51_280), ("base", 480_000)])
def test_wavlm_flops_match_jax(preset, n_samples, batch):
    ours = bench.wavlm_flops(getattr(WavLMConfig, preset)(), batch, n_samples)
    theirs = jbench.wavlm_flops(getattr(JaxWavLMConfig, preset)(), batch, n_samples)
    assert ours == theirs
    assert all(type(x) is int for x in ours)


@pytest.mark.parametrize("batch", [1, 16])
@pytest.mark.parametrize("preset", ["large", "large_v3"])
def test_whisper_encoder_flops_match_jax(preset, batch):
    ours = bench.whisper_encoder_flops(getattr(WhisperConfig, preset)(), batch)
    theirs = jbench.whisper_encoder_flops(getattr(JaxWhisperConfig, preset)(), batch)
    assert ours == theirs and type(ours) is int


def test_bound_prices_at_the_h100_peaks():
    """The data sheet's dense peaks (989 TFLOP/s bf16, 1,979 TOP/s int8,
    67 TFLOP/s f32, 3.35 TB/s), the larger of the two times."""
    for flops, nbytes, peak, by in ((989e9, 1.0, bench.BF16_PEAK, "operations"),
                                    (1979e9, 0.0, bench.INT8_PEAK, "operations"),
                                    (67e9, 0.0, bench.F32_PEAK, "operations"),
                                    (1.0, 3.35e9, bench.BF16_PEAK, "bytes")):
        ms, bound_by = bench.bound(flops, nbytes, peak)
        assert ms == pytest.approx(1.0, rel=1e-12) and bound_by == by
