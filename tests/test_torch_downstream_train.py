"""stutter_tpu_torch's downstream trainers against the JAX package on the CPU.

Both trainers on one store written by the JAX package (the same
per-layer results and output tree), the augmentation re-extraction through
tiny WavLM extractors in both packages, and the two training CLIs on
``--device cpu``.
"""

import json
import logging
import os
from unittest import mock

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from stutter_tpu.audio.wavio import write_wav
from stutter_tpu.extract import WavLMExtractor as JaxExtractor
from stutter_tpu.extract import store as jstore
from stutter_tpu.models import WavLMConfig as JaxConfig, init_wavlm_params
from stutter_tpu.train import augment_extract as jae
from stutter_tpu.train import heads as jheads
from stutter_tpu.train import trainer as jtrainer
from stutter_tpu_torch.cli import train as train_cli
from stutter_tpu_torch.cli import train_grid as grid_cli
from stutter_tpu_torch.extract.pipeline import WavLMExtractor
from stutter_tpu_torch.models.wavlm import WavLMConfig, WavLMModel
from stutter_tpu_torch.train import augment_extract as ae
from stutter_tpu_torch.train import classifiers as clf
from stutter_tpu_torch.train import smote
from stutter_tpu_torch.train import trainer
from stutter_tpu_torch.weights.convert import wavlm_params_from_numpy
from tests.conftest import cosine_distance
from tests.test_torch_downstream import _jax_init_from_port, jax_smote_draws

torch.set_num_threads(2)  # six xdist workers share the host

CLASSES = ("fluent", "block", "prolongation")


def _write_store(root: str, counts: dict, dim: int = 16, seed: int = 0,
                 layers=("layer_3", "layer_12")) -> None:
    """A wavlm store written by the JAX package: three classes apart in
    embedding space, two layers, clips on disk for the augmentation."""
    rng = np.random.RandomState(seed)
    centres = rng.randn(len(CLASSES), dim) * 1.5
    os.makedirs(os.path.join(root, "wav"), exist_ok=True)
    for split, per_class in counts.items():
        labels = [c for c, n in zip(CLASSES, per_class) for _ in range(n)]
        rng.shuffle(labels)
        names = [f"{split}_{i:03d}.wav" for i in range(len(labels))]
        paths = [os.path.join(root, "wav", n) for n in names]
        for p in paths:
            t = np.arange(int(rng.uniform(0.3, 0.45) * 16000)) / 16000
            write_wav(p, 0.4 * np.sin(2 * np.pi * rng.uniform(100, 500) * t)
                      + 0.03 * rng.randn(len(t)), 16000)
        df = pd.DataFrame({"filename": names, "path": paths, "split": split, "label": labels})
        idx = np.array([CLASSES.index(c) for c in labels])
        for layer in layers:
            x = centres[idx] + rng.randn(len(idx), dim)
            df[layer] = list(x.astype(np.float32))
        jstore.save_embeddings(df, os.path.join(root, "wavlm"), split)


@pytest.fixture(scope="module")
def emb_store(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("store"))
    _write_store(root, {"train": (30, 12, 8), "test": (6, 4, 3), "devel": (6, 3, 3)})
    return root


def _port_smote_with_jax_draws(X, y, k_neighbors=3, random_state=42, device="cuda"):
    with mock.patch.object(smote, "smote_draws", jax_smote_draws(random_state)):
        return smote.apply_smote_oversampling(X, y, k_neighbors, random_state, device)


def _same_draws():
    """Both packages' SMOTE draws and head initialisation made equal."""
    return (mock.patch.object(clf, "apply_smote_oversampling", _port_smote_with_jax_draws),
            mock.patch.object(jheads, "init_head_params", _jax_init_from_port))


def _tree(root: str) -> set:
    """Relative paths of every file, the model files' extensions as one."""
    out = set()
    for d, _, files in os.walk(root):
        for f in files:
            rel = os.path.relpath(os.path.join(d, f), root)
            for ext in ("_model.joblib", "_model.npz", "_model.pkl"):
                rel = rel.replace(ext, "_model.*")
            out.add(rel)
    return out


def _same_text_outputs(ours: str, theirs: str) -> None:
    files = _tree(theirs)
    assert _tree(ours) == files
    for rel in files:
        if rel.endswith((".csv", ".txt")):
            with open(os.path.join(ours, rel)) as a, open(os.path.join(theirs, rel)) as b:
                assert a.read() == b.read(), rel


def test_run_balanced_training_matches_jax(emb_store, tmp_path):
    kw = dict(embeddings_dir=emb_store, model_type="wavlm", classifiers=("linear", "mlp", "rf"),
              smote_k_neighbors=3, head_overrides={"epochs": 15, "dropout": 0.0})
    p1, p2 = _same_draws()
    with p1, p2:
        theirs = jtrainer.run_balanced_training(
            jtrainer.TrainConfig(results_dir=str(tmp_path / "jax"), **kw))
        ours = trainer.run_balanced_training(
            trainer.TrainConfig(results_dir=str(tmp_path / "port"), device="cpu", **kw))
    assert list(ours) == list(theirs) == ["layer_3", "layer_12"]
    for layer in theirs:
        assert ours[layer]["balanced_accuracy"] == theirs[layer]["balanced_accuracy"], layer
        assert ours[layer]["classifier"] == theirs[layer]["classifier"]
        assert ours[layer]["per_class"] == theirs[layer]["per_class"]
    assert 0.5 < max(r["balanced_accuracy"] for r in ours.values()) <= 1.0
    _same_text_outputs(str(tmp_path / "port"), str(tmp_path / "jax"))
    with open(tmp_path / "port" / "best_per_layer.json") as a, \
            open(tmp_path / "jax" / "best_per_layer.json") as b:
        assert json.load(a) == json.load(b)
    with open(tmp_path / "port" / "layer_3" / "wavlm_layer_3_mlp_info.json") as f:
        info = json.load(f)
    assert info["class_names"] == ["block", "fluent", "prolongation"]
    assert info["framework"] == "stutter_tpu_torch"


def test_run_grid_training_matches_jax(emb_store, tmp_path):
    # the MLP head's default dropout draws from each package's own generator,
    # so the grid here takes the Linear head only (no hidden layer, no dropout)
    names = clf.GRID_MODELS + ("Linear_Weighted",)
    kw = dict(embeddings_dir=emb_store, model_type="wavlm", smote_k_neighbors=3,
              split="train_test", test_size=0.25)
    p1, p2 = _same_draws()
    with p1, p2:
        theirs = jtrainer.run_grid_training(
            jtrainer.TrainConfig(results_dir=str(tmp_path / "jax"), **kw), model_names=names)
        ours = trainer.run_grid_training(
            trainer.TrainConfig(results_dir=str(tmp_path / "port"), device="cpu", **kw),
            model_names=names)
    for layer in theirs:
        assert ours[layer]["configuration"] == theirs[layer]["configuration"]
        assert ours[layer]["balanced_accuracy"] == theirs[layer]["balanced_accuracy"]
    _same_text_outputs(str(tmp_path / "port"), str(tmp_path / "jax"))


def test_apply_data_augmentation_matches_jax(emb_store):
    """The same rows and, clip for clip, the same embeddings from the JAX
    extractor and the port's, tiny WavLM weights carried across, f32."""
    jcfg = JaxConfig.tiny(hidden_size=32, layers=2, heads=4)
    cfg = WavLMConfig.tiny(hidden_size=32, layers=2, heads=4)
    params = init_wavlm_params(jax.random.key(0), jcfg)
    model = WavLMModel(cfg)
    model.load_state_dict(wavlm_params_from_numpy(jax.tree.map(np.asarray, params), cfg))
    jax_ex = JaxExtractor(jcfg, params, preset="fidelity")
    ex = WavLMExtractor(model, "cpu", preset="fidelity")
    assert ex.column_names == jax_ex.column_names and ex.frame_align == jax_ex.frame_align

    meta_j, layers = jstore.load_embeddings(emb_store, "wavlm")
    n_train = int((meta_j["split"] == "train").sum())
    meta_j = meta_j.iloc[:n_train]
    train = {k: np.zeros((n_train, cfg.hidden_size), np.float32) for k in ex.column_names}
    train["layer_99"] = layers["layer_3"][:n_train]  # not re-extracted: kept as it is
    meta = trainer.load_embeddings(emb_store, "wavlm")[0][:n_train]
    kw = dict(augmentation_factor=1, minority_threshold=13, seed=3)
    out_meta_j, out_j = jae.apply_data_augmentation(meta_j, train, jax_ex, **kw)
    calls = []
    real = ex.submit
    with mock.patch.object(ex, "submit", lambda b: calls.append(len(b.paths)) or real(b)):
        out_meta, out = ae.apply_data_augmentation(meta, train, ex, **kw)
    assert calls == [20]  # the 12 + 8 clips of the two minority classes, one batch
    assert len(out_meta) == len(out_meta_j) == n_train + 20
    for ours, (_, theirs) in zip(out_meta[n_train:], out_meta_j.iloc[n_train:].iterrows()):
        assert (ours["filename"], ours["label"], ours["augmented"], ours["augmentation_type"]) \
            == (theirs["filename"], theirs["label"], theirs["augmented"],
                theirs["augmentation_type"])
    assert all(r["filename"].endswith("_aug_0") for r in out_meta[n_train:])
    assert list(out) == list(out_j)
    np.testing.assert_array_equal(out["layer_99"], train["layer_99"])
    for k in ex.column_names:
        assert out[k].shape == out_j[k].shape == (n_train + 20, cfg.hidden_size)
        for a, b in zip(out[k][n_train:], out_j[k][n_train:]):
            assert cosine_distance(a, b) <= 1e-5


def test_embed_waves_through_whisper_matches_jax():
    """The Whisper re-extraction: tiny Whisper weights in both packages, clips
    of three lengths through each package's _embed_waves, f32."""
    from stutter_tpu.extract import WhisperExtractor as JaxWhisperExtractor
    from stutter_tpu_torch.extract.pipeline import WhisperExtractor
    from stutter_tpu_torch.models.whisper import WhisperConfig
    from tests.test_torch_whisper import _jax_cfg, _port, _tree

    cfg = WhisperConfig.tiny()
    tree = _tree(cfg)
    rng = np.random.RandomState(4)
    waves = [(0.2 * rng.randn(n)).astype(np.float32) for n in (9_000, 24_000, 16_000)]
    jax_ex = JaxWhisperExtractor(_jax_cfg(cfg), jax.tree.map(np.asarray, tree),
                                 preset="fidelity")
    theirs = jae._embed_waves(jax_ex, waves, chunk=2)
    ex = WhisperExtractor(_port(cfg, tree), "cpu", preset="fidelity")
    ours = ae._embed_waves(ex, waves, chunk=2)
    assert list(ours) == list(theirs) == ex.column_names
    for k in ours:
        assert ours[k].shape == theirs[k].shape == (3, cfg.d_model)
        for a, b in zip(ours[k], theirs[k]):
            assert cosine_distance(a, b) <= 1e-5, k


def test_augmentation_skips_value_errors_and_stops_on_device_errors(emb_store):
    meta = trainer.load_embeddings(emb_store, "wavlm")[0][:50]
    train = {"layer_0": np.zeros((50, 4), np.float32)}

    class NoExtractor:
        device = torch.device("cpu")

    with mock.patch.object(ae, "augment_audio", side_effect=ValueError("too short")):
        assert ae.apply_data_augmentation(meta, train, NoExtractor(), 1, 10) == (meta, train)
    with mock.patch.object(ae, "augment_audio", side_effect=RuntimeError("CUDA error")):
        with pytest.raises(RuntimeError, match="CUDA error"):
            ae.apply_data_augmentation(meta, train, NoExtractor(), 1, 10)
    assert ae._minority_classes([None, "b", "a", "b", "a", "c", 1], 3) == ["b", "a", "c", 1]


def test_train_cli_on_cpu(tmp_path, caplog):
    # two of WavLM-Base's four extracted layers, at its width, so that the
    # re-extracted rows stack onto them
    store_dir = str(tmp_path / "store")
    _write_store(store_dir, {"train": (30, 12, 8), "test": (6, 4, 3), "devel": (6, 3, 3)},
                 dim=768, layers=("layer_6", "layer_12"))
    base = ["--embeddings_dir", store_dir, "--device", "cpu"]
    caplog.set_level(logging.INFO)
    out = str(tmp_path / "balanced")
    rc = train_cli.main(base + ["--results_dir", out, "--classifier", "linear",
                                "--head_epochs", "5", "--augmentation_factor", "1",
                                "--minority_threshold", "10", "--random_init",
                                "--model_name", "microsoft/wavlm-base", "--preset",
                                "fidelity"])
    assert rc == 0
    for f in ("all_results_comparison.csv", "layer_comparison_summary.csv",
              "final_summary.txt", "best_per_layer.json",
              "layer_12/wavlm_layer_12_linear_model.npz"):
        assert os.path.isfile(os.path.join(out, f)), f
    assert "combined layer_12: 50 original + 8 augmented" in caplog.text
    grid_out = str(tmp_path / "grid")
    assert grid_cli.main(base + ["--results_dir", grid_out, "--model_type", "wavlm",
                                 "--include_jax_heads", "--no_augmentation",
                                 "--use_class_weights", "false"]) == 0
    with open(os.path.join(grid_out, "all_results_comparison.csv")) as f:
        configurations = {line.split(",")[1] for line in f.read().splitlines()[1:]}
    assert configurations == {"Original_SVM_Basic", "Original_RF_Basic",
                              "Original_Linear_Weighted", "Original_MLP_Weighted",
                              "SMOTE_SVM_Basic", "SMOTE_RF_Basic"}
    # the JAX CLIs' exit codes, and what the port does not support
    assert train_cli.main(base + ["--results_dir", out, "--model_type", "bestrq"]) == 2
    assert train_cli.main(base + ["--results_dir", out, "--split", "all"]) == 2
    assert grid_cli.main(base + ["--results_dir", out, "--split", "all"]) == 2
    assert train_cli.main(["--embeddings_dir", str(tmp_path / "none"), "--results_dir", out,
                           "--device", "cpu", "--no_augmentation"]) == 1
    with pytest.raises(OSError, match="local checkpoint directory"):  # no download
        train_cli.main(base + ["--results_dir", out])
    for cli in (train_cli, grid_cli):  # a bad mesh, before any model or rank
        with pytest.raises(ValueError, match="mesh"):
            cli.main(base + ["--results_dir", out, "--devices", "2", "--tp", "3"])
    args = grid_cli.parse_args(["--embeddings_dir", "x", "--results_dir", "y",
                                "--use_smote", "False"])
    assert args.use_smote is False and args.device == "cuda"
    assert train_cli.parse_args(["--embeddings_dir", "x", "--results_dir", "y"]).device == "cuda"


def test_cli_without_matplotlib_warns_once(emb_store, tmp_path, caplog):
    with mock.patch.dict("sys.modules", {"matplotlib": None}):
        rc = train_cli.main(["--embeddings_dir", emb_store, "--results_dir", str(tmp_path),
                             "--device", "cpu", "--classifier", "linear", "--head_epochs", "2",
                             "--no_augmentation", "--no_smote"])
    assert rc == 0
    # warnings only: the CLI's INFO lines name files under tmp_path, whose name holds "matplotlib"
    assert [r.message for r in caplog.records
            if r.levelno >= logging.WARNING and "matplotlib" in r.message] == \
        ["matplotlib is not installed: writing no plots"]
    assert not [f for f in _tree(str(tmp_path)) if f.endswith(".png")]
