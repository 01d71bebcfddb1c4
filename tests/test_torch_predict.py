"""stutter_tpu_torch's batch prediction CLI: corpus -> embeddings -> trained model -> CSV.

Mirrors ``tests/test_predict_cli.py``'s cases on ``stutter_tpu_torch.cli.predict``
(classify a store; extract then classify, one backbone or both; the per-part
``--max_length``; a reused store's stale splits), with the port's model
files (``.npz`` heads, ``.pkl`` estimators) and metadata as lists of dicts.
Every prediction must equal the port's ``load_model(...).predict`` on the
same rows. Backbones are tiny and run on the CPU.
"""

import csv
import glob
import logging
import os

import numpy as np
import pytest
import torch

from stutter_tpu.audio.synthetic import make_synthetic_corpus
from stutter_tpu_torch.cli import common
from stutter_tpu_torch.cli.predict import main
from stutter_tpu_torch.extract.store import load_embeddings, save_embeddings
from stutter_tpu_torch.models.wavlm import WavLMConfig
from stutter_tpu_torch.models.whisper import WhisperConfig
from stutter_tpu_torch.train.heads import HeadClassifier, HeadConfig
from stutter_tpu_torch.train.persistence import load_model, save_model

torch.set_num_threads(2)  # six xdist workers share the host

CLASS_NAMES = ["Block", "Fluent", "Prolongation"]


def _make_artifact(out_dir: str, layer: str, dim: int, kind: str = "npz", seed: int = 0) -> str:
    rs = np.random.RandomState(seed)
    X = rs.randn(30, dim).astype(np.float32)
    y = rs.randint(0, len(CLASS_NAMES), size=30)
    if kind == "npz":
        model = HeadClassifier(HeadConfig(in_dim=dim, n_classes=3, hidden_dims=(8,), epochs=3,
                                          batch_size=8), device="cpu").fit(X, y)
    else:
        from sklearn.linear_model import LogisticRegression
        from sklearn.pipeline import Pipeline
        from sklearn.preprocessing import StandardScaler

        model = Pipeline([("scaler", StandardScaler()),
                          ("clf", LogisticRegression(max_iter=200))]).fit(X, y)
    return save_model(model, out_dir, "wavlm", layer, "mlp" if kind == "npz" else "svm",
                      class_names=CLASS_NAMES)


def _read_csv(path):
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        return header, [dict(zip(header, row)) for row in reader]


def _tiny_backbones(monkeypatch):
    monkeypatch.setattr(WavLMConfig, "base", staticmethod(lambda: WavLMConfig.tiny(32, 2, 4)))
    monkeypatch.setattr(WhisperConfig, "base",
                        staticmethod(lambda: WhisperConfig.tiny(d_model=32, layers=2, heads=4)))


def _assert_predictions(out, model_path, X):
    reference = load_model(model_path, device="cpu").predict(X)
    assert [r["predicted_label"] for r in out] == [CLASS_NAMES[int(i)] for i in reference]
    probs = load_model(model_path, device="cpu").predict_proba(X)
    for r, p in zip(out, probs):
        np.testing.assert_allclose([float(r[f"prob_{c}"]) for c in CLASS_NAMES], p, atol=1e-6)


@pytest.mark.parametrize("kind", ["npz", "pkl"])
def test_predict_from_existing_store(tmp_path, kind):
    """--embeddings_dir: no backbone forward; the labels ride along."""
    dim, n = 16, 12
    X = np.random.RandomState(3).randn(n, dim).astype(np.float32)
    rows = [{"filename": f"clip_{i}", "path": f"/x/clip_{i}.wav",
             "label": CLASS_NAMES[i % 3], "layer_1": X[i]} for i in range(n)]
    save_embeddings(rows, str(tmp_path / "emb" / "wavlm"), split="train")
    model_path = _make_artifact(str(tmp_path / "clf"), "layer_1", dim, kind)
    out_csv = str(tmp_path / "pred.csv")
    assert main(["--embeddings_dir", str(tmp_path / "emb"), "--classifier_model", model_path,
                 "--model_type", "wavlm", "--output", out_csv, "--device", "cpu"]) == 0
    header, out = _read_csv(out_csv)
    assert header == ["filename", "path", "split", "label", "predicted_label"] \
        + [f"prob_{c}" for c in sorted(CLASS_NAMES)]
    assert len(out) == n and [r["label"] for r in out] == [r["label"] for r in rows]
    assert all(r["split"] == "train" for r in out)
    _assert_predictions(out, model_path, X)


def test_predict_from_audio_dir(tmp_path, monkeypatch):
    """--audio_dir: tiny backbone extraction -> classifier -> CSV."""
    _tiny_backbones(monkeypatch)
    root = str(tmp_path / "corpus")
    make_synthetic_corpus(root, n_per_split={"train": 5}, seed=11)
    clips = sorted(glob.glob(os.path.join(root, "wav", "*.wav")))
    # tiny(32, 2, 4): layer indices (2, 1, 0, 1) -> layer_2 exists
    model_path = _make_artifact(str(tmp_path / "clf"), "layer_2", 32)
    out_csv, store = str(tmp_path / "pred.csv"), str(tmp_path / "store")
    assert main(["--audio_dir", os.path.join(root, "wav"), "--classifier_model", model_path,
                 "--model_type", "wavlm", "--model_name", "microsoft/wavlm-base",
                 "--random_init", "--output", out_csv, "--keep_embeddings_dir", store,
                 "--audio_budget", "16", "--device", "cpu"]) == 0
    header, out = _read_csv(out_csv)
    assert len(out) == len(clips) and "label" not in header
    assert all(r["split"] == "predict" for r in out)
    assert os.path.exists(os.path.join(store, "wavlm", "predict", "embedding_metadata.csv"))
    _, layers = load_embeddings(store, "wavlm", splits=("predict",))
    _assert_predictions(out, model_path, layers["layer_2"])


def test_predict_from_data_dir_scores_labels(tmp_path, monkeypatch, caplog):
    """--data_dir: the corpus's labels are carried and scored."""
    _tiny_backbones(monkeypatch)
    root = str(tmp_path / "corpus")
    make_synthetic_corpus(root, n_per_split={"train": 3, "test": 2}, seed=12,
                          duration_range=(0.3, 0.9))
    model_path = _make_artifact(str(tmp_path / "clf"), "layer_2", 32)
    out_csv = str(tmp_path / "pred.csv")
    with caplog.at_level(logging.INFO):
        assert main(["--data_dir", root, "--classifier_model", model_path,
                     "--model_type", "wavlm", "--model_name", "microsoft/wavlm-base",
                     "--random_init", "--output", out_csv, "--audio_budget", "16",
                     "--device", "cpu", "--long_files", "chunk"]) == 0
    header, out = _read_csv(out_csv)
    assert "label" in header and len(out) == 5 and all(r["label"] for r in out)
    assert any("balanced accuracy on 5 labeled clips" in r.message for r in caplog.records)


def test_predict_layer_mismatch_is_clear(tmp_path):
    save_embeddings([{"filename": "a", "path": "/x/a.wav", "layer_1": np.zeros(8, np.float32)}],
                    str(tmp_path / "emb" / "wavlm"), split="train")
    model_path = _make_artifact(str(tmp_path / "clf"), "layer_9", 8)
    assert main(["--embeddings_dir", str(tmp_path / "emb"), "--classifier_model", model_path,
                 "--model_type", "wavlm", "--output", str(tmp_path / "pred.csv"),
                 "--device", "cpu"]) == 1


def test_predict_combined_from_audio(tmp_path, monkeypatch):
    """'combined' extracts both backbones into the fusion layout and
    classifies its columns (combined_top)."""
    _tiny_backbones(monkeypatch)
    root = str(tmp_path / "corpus")
    make_synthetic_corpus(root, n_per_split={"train": 3}, seed=7, duration_range=(0.3, 0.9))
    # combined_top = wavlm top (32) ++ whisper encoder top (32)
    model_path = _make_artifact(str(tmp_path / "clf"), "combined_top", 64)
    out_csv, store = str(tmp_path / "pred.csv"), str(tmp_path / "store")
    assert main(["--audio_dir", os.path.join(root, "wav"), "--classifier_model", model_path,
                 "--model_type", "combined", "--model_name", "microsoft/wavlm-base",
                 "--whisper_model_name", "openai/whisper-base", "--random_init",
                 "--output", out_csv, "--audio_budget", "16", "--device", "cpu",
                 "--keep_embeddings_dir", store]) == 0
    _, out = _read_csv(out_csv)
    assert len(out) == 3
    from stutter_tpu_torch.extract.store import load_embeddings_combined

    _, layers = load_embeddings_combined(store, splits=("predict",))
    _assert_predictions(out, model_path, layers["combined_top"])


def test_predict_combined_max_length_is_per_part(tmp_path, monkeypatch):
    """--max_length trims only the WavLM part of 'combined': Whisper keeps
    its native 30 s window, as its training store was extracted."""
    _tiny_backbones(monkeypatch)
    seen = []  # (extractor kind, max_length_s) per part
    real = common.make_bucket_batcher

    def spy(extractor, **kw):
        seen.append((type(extractor).__name__, kw.get("max_length_s")))
        return real(extractor, **kw)

    monkeypatch.setattr(common, "make_bucket_batcher", spy)
    root = str(tmp_path / "corpus")
    make_synthetic_corpus(root, n_per_split={"train": 2}, seed=5, duration_range=(0.3, 0.9))
    model_path = _make_artifact(str(tmp_path / "clf"), "combined_top", 64)
    assert main(["--audio_dir", os.path.join(root, "wav"), "--classifier_model", model_path,
                 "--model_type", "combined", "--model_name", "microsoft/wavlm-base",
                 "--whisper_model_name", "openai/whisper-base", "--random_init",
                 "--output", str(tmp_path / "pred.csv"), "--audio_budget", "16",
                 "--max_length", "2", "--device", "cpu"]) == 0
    assert dict(seen) == {"WavLMExtractor": 2.0, "WhisperExtractor": None}


def test_predict_reused_store_ignores_stale_splits(tmp_path, monkeypatch):
    """A reused --keep_embeddings_dir holding another corpus's split adds no
    rows: only the splits this run produced are read."""
    _tiny_backbones(monkeypatch)
    store = str(tmp_path / "store")
    save_embeddings([{"filename": f"stale_{i}", "path": f"/old/stale_{i}.wav",
                      "layer_2": np.zeros(32, np.float32)} for i in range(4)],
                    os.path.join(store, "wavlm"), split="train")
    root = str(tmp_path / "corpus")
    make_synthetic_corpus(root, n_per_split={"train": 4}, seed=13, duration_range=(0.3, 0.9))
    clips = sorted(glob.glob(os.path.join(root, "wav", "*.wav")))
    model_path = _make_artifact(str(tmp_path / "clf"), "layer_2", 32)
    out_csv = str(tmp_path / "pred.csv")
    assert main(["--audio_dir", os.path.join(root, "wav"), "--classifier_model", model_path,
                 "--model_type", "wavlm", "--model_name", "microsoft/wavlm-base",
                 "--random_init", "--output", out_csv, "--keep_embeddings_dir", store,
                 "--audio_budget", "16", "--device", "cpu"]) == 0
    _, out = _read_csv(out_csv)
    assert len(out) == len(clips)
    assert not any(r["filename"].startswith("stale_") for r in out)
    assert all(r["split"] == "predict" for r in out)
