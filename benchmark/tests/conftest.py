"""Fixtures of the benchmark's tests.

``tiny_root`` builds a checkout-like directory: a copy of the benchmark's
folder (its tests left out), tiny configurations and a tiny mix beside the
real ones, and a ``BENCHMARK.json`` naming the cells given. The tests that
need the card take the ``card`` fixture, which skips where torch sees none;
the decision is made when the test runs, never at import.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]

TINY = {
    "tiny-wavlm": {
        "family": "wavlm", "source": "https://huggingface.co/microsoft/wavlm-large",
        "preset": "fidelity", "control_preset": "turbo", "hidden_size": 32,
        "num_hidden_layers": 2, "num_attention_heads": 4, "intermediate_size": 64,
        "conv_dim": [16, 16, 16], "conv_stride": [5, 2, 2], "conv_kernel": [10, 3, 3],
        "conv_bias": True, "feat_extract_norm": "layer", "do_stable_layer_norm": True,
        "num_conv_pos_embeddings": 16, "num_conv_pos_embedding_groups": 4,
        "num_buckets": 320, "max_bucket_distance": 800, "layer_norm_eps": 1e-5,
        "do_normalize": True, "apply_spec_augment": True, "mask_time_prob": 0.05,
        "mask_time_length": 10, "mask_feature_prob": 0.0, "mask_feature_length": 10,
        "reduced": [],
        "check": {"clips": 6, "limits": {"missing_rows": 0, "unanswered": 0,
                                         "pooled_cos_dist": 1e-6,
                                         "loss1_gap": 1e-5, "grad1_gap": 1e-5,
                                         "grad1_cos_dist": 1e-6, "change3_gap": 1e-2,
                                         "optim_change_gap": 1e-2, "unmoved_after": 0}},
    },
    "tiny-whisper": {
        "family": "whisper", "source": "https://huggingface.co/openai/whisper-large",
        "preset": "fidelity", "control_preset": "turbo", "d_model": 32,
        "encoder_layers": 2, "encoder_attention_heads": 4, "decoder_layers": 2,
        "decoder_attention_heads": 4, "ffn_dim": 64, "num_mel_bins": 80,
        "max_source_positions": 1500, "max_target_positions": 448, "vocab_size": 128,
        "layer_norm_eps": 1e-5, "reduced": [],
        "check": {"clips": 6, "limits": {"missing_rows": 0, "encoder_cos_dist": 1e-6,
                                         "decoder_cos_dist": 1e-6}},
    },
}
TINY_MIX = {"entry": "extract", "split": "train", "clips": 6, "seconds": [0.3, 0.5],
            "sample_rate": 16000}
TINY_SERVE = {"entry": "serve", "split": "train", "clips": 6, "seconds": [0.3, 1.5],
              "sample_rate": 16000, "rate_per_s": 8.0, "traced_seconds": 0.5,
              "server": {"max_wait_ms": 100.0, "max_clips": 4, "long_clip_policy": "chunk"}}
TINY_TRAIN = {"entry": "finetune", "split": "train", "clips": 12, "seconds": [0.3, 0.5],
              "sample_rate": 16000, "traced_updates": 2,
              "recipe": {"batch_size": 4, "max_length": 10.0, "backbone_lr": 1e-3,
                         "head_lr": 1e-2, "weight_decay": 1e-4, "head_hidden": [8],
                         "head_dropout": 0.1, "remat_policy": "layer",
                         "activation_dtype": "float32"}}


# the tiny cell that takes each real cell's metrics
STANDS_IN = {"wavlm-large.extract-3s": "tiny-wavlm.mix",
             "whisper-large.extract-3s": "tiny-whisper.mix",
             "wavlm-large.finetune-3s": "tiny-wavlm.train",
             "wavlm-large.serve-poisson": "tiny-wavlm.serve"}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; torch sees none")


def write_root(root: Path, cells: list[dict], per_layer: list[dict] | None = None) -> Path:
    """A checkout-like ``root`` holding the benchmark's folder, the tiny
    configurations and mix, and a ``BENCHMARK.json`` with ``cells``."""
    bench = root / "benchmark"
    shutil.copytree(REPO / "benchmark", bench, ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    for name, config in TINY.items():
        (bench / "configs" / f"{name}.json").write_text(json.dumps(config))
    (bench / "traffic" / "tiny-mix.json").write_text(json.dumps(TINY_MIX))
    (bench / "traffic" / "tiny-train.json").write_text(json.dumps(TINY_TRAIN))
    (bench / "traffic" / "tiny-serve.json").write_text(json.dumps(TINY_SERVE))
    real = json.loads((REPO / "BENCHMARK.json").read_text())
    names = [c["name"] for c in cells]
    real["configs"] = [{"name": n, "source": c["source"], "file": f"benchmark/configs/{n}.json",
                        "reduced": [], "why": "a tiny configuration for the CPU tests"}
                       for n, c in TINY.items()]
    real["workloads"] = cells
    for kind in ("end_to_end", "per_layer"):
        for m in real[kind]:
            if "workloads" in m:  # each real cell's metrics go to the tiny cell in its place
                m["workloads"] = [STANDS_IN[w] for w in m["workloads"]
                                  if STANDS_IN.get(w) in names]
    real["per_layer"] += per_layer or []
    (root / "BENCHMARK.json").write_text(json.dumps(real))
    return root


def tiny_cell(name: str, config: str, traffic: str = "tiny-mix") -> dict:
    return {"name": name, "config": config, "traffic": traffic, "chips": 1,
            "why": "a tiny cell for the CPU tests"}


@pytest.fixture
def tiny_root(tmp_path):
    return write_root(tmp_path, [tiny_cell("tiny-wavlm.mix", "tiny-wavlm"),
                                 tiny_cell("tiny-whisper.mix", "tiny-whisper"),
                                 tiny_cell("tiny-wavlm.train", "tiny-wavlm", "tiny-train"),
                                 tiny_cell("tiny-wavlm.serve", "tiny-wavlm", "tiny-serve")])
