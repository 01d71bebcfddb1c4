"""stutter_tpu_torch's downstream components against the JAX package on the CPU.

The augmentation DSP (resample, pitch shift, augment_audio), SMOTE, the
scaler and the classifier heads, the sklearn backends, the data splits and
the store loaders, model persistence, and the rule that every port module
imports without sklearn and matplotlib.
"""

import os
import random
import subprocess
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from stutter_tpu.audio import wavio as jwavio
from stutter_tpu.extract import store as jstore
from stutter_tpu.ops.pitch import pitch_shift as jax_pitch_shift
from stutter_tpu.ops.resample import resample as jax_resample
from stutter_tpu.train import augment as jaug
from stutter_tpu.train import classifiers as jclf
from stutter_tpu.train import data as jdata
from stutter_tpu.train import heads as jheads
from stutter_tpu.train import quality as jquality
from stutter_tpu.train import smote as jsmote
from stutter_tpu_torch.audio import wavio
from stutter_tpu_torch.extract import store
from stutter_tpu_torch.ops.pitch import pitch_shift
from stutter_tpu_torch.ops.resample import resample
from stutter_tpu_torch.train import augment as aug
from stutter_tpu_torch.train import classifiers as clf
from stutter_tpu_torch.train import data
from stutter_tpu_torch.train import heads
from stutter_tpu_torch.train import persistence
from stutter_tpu_torch.train import quality
from stutter_tpu_torch.train import smote

torch.set_num_threads(2)  # six xdist workers share the host

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_PAIRS = [(44100, 16000), (22050, 16000), (16000, 14400), (14400, 16000),
                (16000, 17600), (8000, 16000)]


def _goldens():
    return np.load(os.path.join(REPO, "tests", "goldens", "dsp_goldens.npz"))


def _rows(df: pd.DataFrame) -> list[dict]:
    """A DataFrame's rows as dicts, NaN as None (the port's metadata form)."""
    return [{k: (None if isinstance(v, float) and np.isnan(v) else v) for k, v in r.items()}
            for r in df.to_dict("records")]


def _typed_equal(a: list[dict], b: list[dict]) -> None:
    """Rows equal value for value and type for type (1 is not 1.0 here)."""
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert list(ra) == list(rb)
        for k in ra:
            assert ra[k] == rb[k] and type(ra[k]) is type(rb[k]) or (
                isinstance(ra[k], (bool, np.bool_)) and bool(ra[k]) == bool(rb[k])), (k, ra, rb)


# ---------------------------------------------------------------- DSP


@pytest.mark.parametrize("orig,new", GOLDEN_PAIRS)
def test_resample_matches_jax_and_goldens(orig, new):
    g = _goldens()
    x = g["input"]
    ours = resample(torch.from_numpy(x), orig, new).numpy()
    theirs = np.asarray(jax_resample(x, orig, new))
    assert ours.shape == theirs.shape == g[f"resample_{orig}_{new}"].shape
    np.testing.assert_allclose(ours, theirs, atol=1e-6, rtol=0)
    np.testing.assert_allclose(ours, g[f"resample_{orig}_{new}"], atol=3e-6, rtol=0)
    batch = resample(torch.from_numpy(np.stack([x, -x])), orig, new).numpy()
    np.testing.assert_allclose(batch[1], -ours, atol=1e-6, rtol=0)


@pytest.mark.parametrize("n_steps", [-2, 2])
def test_pitch_shift_matches_jax_and_goldens(n_steps):
    g = _goldens()
    x = g["input"]
    ours = pitch_shift(torch.from_numpy(x), 16000, n_steps).numpy()
    theirs = np.asarray(jax_pitch_shift(x, 16000, n_steps))
    assert ours.shape == theirs.shape == x.shape
    np.testing.assert_allclose(ours, theirs, atol=1e-4, rtol=0)
    np.testing.assert_allclose(ours, g[f"pitch_{n_steps}"], atol=2e-4, rtol=0)
    assert pitch_shift(torch.from_numpy(x), 16000, 0).numpy() is not None


@pytest.mark.parametrize("profile", ["balanced", "conservative"])
def test_augment_audio_matches_jax(profile, rng):
    """The same Random gives the same kind, factor and noise in both
    packages: noise bit-equal, the DSP kinds within 1e-4; both Randoms end
    in the same state."""
    x = (0.5 * np.sin(np.arange(9000) * 0.05) + 0.05 * rng.randn(9000)).astype(np.float32)
    cfg, jcfg = getattr(aug.AugmentConfig, profile)(), getattr(jaug.AugmentConfig, profile)()
    kinds = set()
    for seed in range(8):
        kind = random.Random(seed).choice(list(cfg.kinds))
        kinds.add(kind)
        r_ours, r_jax = random.Random(seed), random.Random(seed)
        ours = aug.augment_audio(x, 16000, config=cfg, rng=r_ours, device="cpu")
        theirs = jaug.augment_audio(x, 16000, config=jcfg, rng=r_jax)
        assert ours.dtype == np.float32 and ours.shape == theirs.shape, kind
        if kind in ("noise", "volume", "none"):
            np.testing.assert_array_equal(ours, theirs)
        else:
            np.testing.assert_allclose(ours, theirs, atol=1e-4, rtol=0)
        assert r_ours.random() == r_jax.random()
    assert {"speed", "noise"} <= kinds


def test_augment_unknown_kind_returns_input_and_device_errors_propagate(rng):
    x = rng.randn(100).astype(np.float32) * 2  # outside [-1, 1]: returned unclipped
    np.testing.assert_array_equal(aug.augment_audio(x, augmentation_type="reverb",
                                                    device="cpu"), x)
    with mock.patch.object(aug, "resample", side_effect=RuntimeError("CUDA error: boom")):
        with pytest.raises(RuntimeError, match="CUDA error"):
            aug.augment_audio(x, augmentation_type="speed", rng=random.Random(1), device="cpu")


def test_load_audio_resamples_like_jax(tmp_path, rng):
    x = (0.5 * np.sin(np.arange(22050) * 0.02) + 0.05 * rng.randn(22050)).astype(np.float32)
    path = str(tmp_path / "a22k.wav")
    wavio.write_wav(path, x, 22050)
    ours = wavio.load_audio(path)
    theirs = jwavio.load_audio(path)
    assert ours.dtype == np.float32 and ours.shape == theirs.shape == (16000,)
    np.testing.assert_allclose(ours, theirs, atol=1e-5, rtol=0)


# ---------------------------------------------------------------- SMOTE


def _jax_draws(key, n, k, n_new):
    """``_smote_class``'s draws from its class key."""
    k_base, k_pick, k_gap = jax.random.split(key, 3)
    return (torch.tensor(np.array(jax.random.randint(k_base, (n_new,), 0, n))).long(),
            torch.tensor(np.array(jax.random.randint(k_pick, (n_new,), 0, k))).long(),
            torch.tensor(np.array(jax.random.uniform(k_gap, (n_new, 1), jnp.float32))))


def jax_smote_draws(random_state: int):
    """A stand-in for ``smote.smote_draws`` giving, class after class, the
    draws ``apply_smote_oversampling`` of the JAX package takes for
    ``random_state``."""
    state = {"key": jax.random.key(random_state)}

    def draws(generator, n, k, n_new):
        state["key"], sub = jax.random.split(state["key"])
        return _jax_draws(sub, n, k, n_new)

    return draws


@pytest.mark.parametrize("n,k,n_new", [(7, 3, 11), (40, 5, 64)])
def test_smote_interpolate_matches_jax(n, k, n_new, rng):
    x = rng.randn(n, 24).astype(np.float32)
    key = jax.random.key(3)
    theirs = np.asarray(jsmote._smote_class(jnp.asarray(x), key, k, n_new))
    xt = torch.from_numpy(x)
    ours = smote.smote_interpolate(xt, k, *_jax_draws(key, n, k, n_new)).numpy()
    assert np.abs(ours - theirs).max() <= 1e-6
    xj = jnp.asarray(x)
    sq = jnp.sum(xj * xj, axis=1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (xj @ xj.T) + jnp.eye(n) * 1e30
    np.testing.assert_array_equal(smote.smote_neighbors(xt, k).numpy(),
                                  np.asarray(jax.lax.top_k(-d2, k)[1]))


def test_smote_oversampling_matches_jax_given_its_draws(rng):
    X = rng.randn(60, 12).astype(np.float32)
    y = np.array(["b"] * 30 + ["a"] * 18 + ["c"] * 12)
    Xj, yj = jsmote.apply_smote_oversampling(X, y, k_neighbors=3, random_state=5)
    with mock.patch.object(smote, "smote_draws", jax_smote_draws(5)):
        Xt, yt = smote.apply_smote_oversampling(X, y, k_neighbors=3, random_state=5,
                                                device="cpu")
    np.testing.assert_array_equal(yt, yj)
    assert np.abs(Xt - Xj).max() <= 1e-6
    np.testing.assert_array_equal(Xt[:60], X)
    assert {c: int((yt == c).sum()) for c in "abc"} == {"a": 30, "b": 30, "c": 30}
    # the port's own draws: seeded, balanced, on segments between samples
    X1, y1 = smote.apply_smote_oversampling(X, y, k_neighbors=3, random_state=5, device="cpu")
    X2, _ = smote.apply_smote_oversampling(X, y, k_neighbors=3, random_state=5, device="cpu")
    np.testing.assert_array_equal(X1, X2)
    np.testing.assert_array_equal(y1, yj)


@pytest.mark.parametrize("counts,k_eff", [((10, 2), 1), ((10, 1), 0), ((10, 3), 2)])
def test_smote_k_guard(counts, k_eff, rng):
    """k = min(k_neighbors, smallest class - 1); below 1 the inputs come back."""
    y = np.repeat([0, 1], counts)
    X = rng.randn(len(y), 4).astype(np.float32)
    seen = []
    real = smote.smote_interpolate

    def spy(x, k, *draws):
        seen.append(k)
        return real(x, k, *draws)

    with mock.patch.object(smote, "smote_interpolate", spy):
        Xr, yr = smote.apply_smote_oversampling(X, y, k_neighbors=3, device="cpu")
    if k_eff < 1:
        assert Xr is not None and len(yr) == len(y) and not seen
    else:
        assert seen == [k_eff] and np.bincount(yr).tolist() == [10, 10]


# ---------------------------------------------------------------- heads


def test_standard_scaler_matches_jax(rng):
    X = rng.randn(50, 9).astype(np.float32) * 3 + 1
    X[:, 4] = 2.0  # a constant column: std 0 scales by 1
    ours, theirs = heads.StandardScaler().fit(X), jheads.StandardScaler().fit(X)
    np.testing.assert_allclose(ours.transform(X), theirs.transform(X), atol=1e-7, rtol=0)
    np.testing.assert_array_equal(ours.scale_, theirs.scale_)


def _jax_init_from_port(key, cfg):
    """JAX's ``init_head_params`` replaced by the port's draws for cfg.seed."""
    params = heads.init_head_params(cfg, torch.Generator().manual_seed(cfg.seed))
    return [{k: jnp.asarray(v.numpy()) for k, v in p.items()} for p in params]


@pytest.mark.parametrize("hidden", [(), (16,)], ids=["linear", "mlp"])
@pytest.mark.parametrize("class_weight", ["balanced", None])
def test_head_classifier_matches_jax(hidden, class_weight, rng):
    X = rng.randn(150, 24).astype(np.float32)
    y = rng.randint(0, 3, 150)
    X[y == 1] += 0.7
    kw = dict(in_dim=24, n_classes=3, hidden_dims=hidden, dropout=0.0, epochs=3,
              batch_size=64, seed=7)
    with mock.patch.object(jheads, "init_head_params", _jax_init_from_port):
        theirs = jheads.JaxClassifier(jheads.HeadConfig(**kw), class_weight).fit(X, y)
    ours = heads.HeadClassifier(heads.HeadConfig(**kw), class_weight, device="cpu").fit(X, y)
    for i, p in enumerate(theirs.params):
        for name in ("w", "b"):
            a = np.asarray(p[name])
            b = getattr(ours.head.layers[i], name).detach().numpy()
            assert np.linalg.norm(a - b) / np.linalg.norm(a) <= 1e-5, (i, name)
    np.testing.assert_array_equal(ours.predict(X), theirs.predict(X))
    np.testing.assert_allclose(ours.predict_proba(X), theirs.predict_proba(X), atol=1e-5)


def test_head_classifier_learns_with_dropout(rng):
    X = rng.randn(120, 8).astype(np.float32)
    y = (X[:, 0] + X[:, 1] > 0).astype(np.int64)
    model = clf.make_classifier("mlp", 8, 2, head_overrides={"epochs": 40}, device="cpu")
    assert isinstance(model, heads.HeadClassifier) and model.cfg.hidden_dims == (256,)
    assert model.cfg.dropout == 0.1
    assert (model.fit(X, y).predict(X) == y).mean() > 0.9


def test_fine_tune_head_init_is_init_head_params():
    cfg = heads.HeadConfig(12, 4, (8,))
    head = heads.MLPHead(cfg).init_(torch.Generator().manual_seed(3))
    params = heads.init_head_params(cfg, torch.Generator().manual_seed(3))
    for layer, p in zip(head.layers, params):
        assert torch.equal(layer.w, p["w"]) and torch.equal(layer.b, p["b"])


# ---------------------------------------------------------------- classifiers


@pytest.mark.parametrize("kind", ["svm", "rf", "xgb"])
def test_sklearn_backends_match_jax(kind, rng):
    X = rng.randn(80, 6).astype(np.float32)
    y = np.where(X[:, 0] > 0.3, 2, np.where(X[:, 1] > 0, 5, 0))  # non-contiguous labels
    ours = clf.make_classifier(kind, 6, 3, random_state=1).fit(X, y)
    theirs = jclf.make_classifier(kind, 6, 3, random_state=1).fit(X, y)
    np.testing.assert_array_equal(ours.predict(X), theirs.predict(X))


def test_make_classifier_names_its_backends():
    assert isinstance(clf.make_classifier("logreg", 4, 2, device="cpu"), heads.HeadClassifier)
    assert clf.make_classifier("linear", 4, 2, device="cpu").cfg.hidden_dims == ()
    with pytest.raises(ValueError, match="unknown classifier"):
        clf.make_classifier("knn", 4, 2)
    assert set(clf.GRID_MODELS) == set(jclf.GRID_MODELS)
    assert clf.GRID_MODELS_JAX == jclf.GRID_MODELS_JAX


def test_train_improved_models_grid_matches_jax(rng):
    X = rng.randn(60, 8).astype(np.float32)
    y = np.array([0] * 36 + [1] * 14 + [2] * 10)
    X[y == 1] += 1.0
    X[y == 2] -= 1.0
    Xt = X[::3] + 0.1
    yt = y[::3]
    names = ("SVM_Basic", "RF_Weighted", "Linear_Weighted")
    # the Linear head has no hidden layer, so the default dropout never applies
    with mock.patch.object(smote, "smote_draws", jax_smote_draws(42)), \
            mock.patch.object(jheads, "init_head_params", _jax_init_from_port):
        ours = clf.train_improved_models(X, y, Xt, yt, ["a", "b", "c"], model_names=names,
                                            device="cpu")
        theirs = jclf.train_improved_models(X, y, Xt, yt, ["a", "b", "c"], model_names=names)
    assert list(ours) == list(theirs) == ["Original_SVM_Basic", "Original_RF_Weighted",
                                             "Original_Linear_Weighted", "SMOTE_SVM_Basic"]
    for key in theirs:
        assert ours[key]["balanced_accuracy"] == theirs[key]["balanced_accuracy"], key


# ---------------------------------------------------------------- data, store


def _labelled(labels, split="train"):
    return [{"filename": f"f{i}.wav", "label": lab, "split": split}
            for i, lab in enumerate(labels)]


@pytest.mark.parametrize("labels,label_map", [
    ([3, 1, 3, 2, 1], None),  # an int column has no empty cell (pandas makes it float)
    (["b", "a", None, "b", "c"], None),
    (["b", "a", "z", "b", None], {"a": 0, "b": 1}),  # 'z' only in eval
    ([1.0, 2.0, None, 1.0], None),
])
def test_prepare_data_matches_jax(labels, label_map, rng):
    emb = rng.randn(len(labels), 4).astype(np.float32)
    meta = _labelled(labels)
    df = pd.DataFrame([{**r, "label": np.nan if r["label"] is None else r["label"]}
                       for r in meta])
    ours = data.prepare_data(meta, emb, label_map)
    theirs = jdata.prepare_data(df, emb, label_map)
    np.testing.assert_array_equal(ours[0], theirs[0])
    np.testing.assert_array_equal(ours[1], theirs[1])
    assert ours[2] == theirs[2] and ours[3] == theirs[3]
    assert [str(ours[3][i]) for i in range(len(ours[3]))] == \
        [str(theirs[3][i]) for i in range(len(theirs[3]))]


@pytest.mark.parametrize("seed", [0, 42])
def test_splits_match_jax(seed, rng):
    labels = ["b", "a", None, "b", "c", "a", "a", "b", "c", "d", "a", None, "b"]
    meta = (_labelled(labels[:8]) + _labelled(labels[8:11], "test")
            + _labelled(labels[11:], "devel"))
    df = pd.DataFrame(meta)
    emb = rng.randn(len(meta), 3).astype(np.float32)
    np.testing.assert_array_equal(data.stratified_test_mask(meta, 0.3, seed),
                                  jdata.stratified_test_mask(df, 0.3, seed))
    ours = data.stratified_split(meta, emb, 0.3, seed)
    theirs = jdata.stratified_split(df, emb, 0.3, seed)
    assert [r["filename"] for r in ours[2]] == list(theirs[2]["filename"])
    np.testing.assert_array_equal(ours[3], theirs[3])
    ours = data.positional_split(meta, emb)
    theirs = jdata.positional_split(df, emb)
    assert len(ours[0]) == len(theirs[0]) == 8
    np.testing.assert_array_equal(ours[3], theirs[3])
    with pytest.raises(ValueError, match="train rows not leading"):
        data.positional_split(meta[8:] + meta[:8], emb)


def test_quality_reports_match_jax(rng):
    X = rng.randn(30, 5).astype(np.float32)
    X[0, 1], X[2, 2] = np.nan, np.inf
    y = np.array([2] * 15 + [0] * 10 + [1] * 5)
    np.testing.assert_equal(quality.check_data_quality(X, y), jquality.check_data_quality(X, y))
    X[0, 1], X[2, 2] = 0.0, 1.0
    assert quality.check_data_quality(X, y) == jquality.check_data_quality(X, y)
    names = {0: "a", 1: "b", 2: "c"}
    assert quality.analyze_class_distribution(y, names) == \
        jquality.analyze_class_distribution(y, names).to_dict("records")


def _jax_store(root, label_sets: dict, rng, dim=6, filenames=None):
    """A store written by the JAX package's save_embeddings, one split a key."""
    for split, labels in label_sets.items():
        names = filenames or [f"{split}_{i:03d}.wav" for i in range(len(labels))]
        df = pd.DataFrame({"filename": names[: len(labels)],
                           "path": [f"/corpus/{n}" for n in names[: len(labels)]],
                           "label": labels, "extra": [1.5] * len(labels)})
        df["layer_3"] = list(rng.randn(len(labels), dim).astype(np.float32))
        df["layer_11"] = list(rng.randn(len(labels), dim).astype(np.float32))
        jstore.save_embeddings(df, root, split)


@pytest.mark.parametrize("label_sets", [
    {"train": ["b", "a", "b"], "test": ["a", ""], "devel": ["c"]},
    {"train": [1, 0, 1], "test": [0, 1], "devel": [2]},
    {"train": [1, 0, 1], "test": [0, np.nan], "devel": [2]},  # one empty: all floats
    {"train": [True, False], "test": ["NA", "x"], "devel": [0.5]},
], ids=["strings", "ints", "ints-with-empty", "mixed"])
def test_load_embeddings_matches_jax(tmp_path, label_sets, rng):
    _jax_store(str(tmp_path / "wavlm"), label_sets, rng)
    meta_j, layers_j = jstore.load_embeddings(str(tmp_path), "wavlm")
    meta, layers = store.load_embeddings(str(tmp_path), "wavlm")
    _typed_equal(meta, _rows(meta_j))
    assert list(layers) == list(layers_j)
    for k in layers:
        np.testing.assert_array_equal(layers[k], layers_j[k])
    labels_j = list(meta_j["label"])
    assert data.build_label_maps(r["label"] for r in meta)[0] == jdata.build_label_maps(labels_j)[0]
    assert store.load_embeddings(str(tmp_path / "missing"), "wavlm") == (None, {})


def test_load_embeddings_combined_matches_jax(tmp_path, rng):
    names = [f"clip_{i}.wav" for i in range(5)]
    _jax_store(str(tmp_path / "wavlm"), {"train": ["a", "b", "a", "b"], "test": ["a"],
                                         "devel": ["b"]}, rng, filenames=names)
    # the second part: rows in another order, one missing, one duplicated
    for split, idx in (("train", [2, 0, 3, 2]), ("test", [0]), ("devel", [4])):
        df = pd.DataFrame({"filename": [names[i] for i in idx],
                           "label": ["x"] * len(idx)})
        df["encoder_layer_32"] = list(rng.randn(len(idx), 3).astype(np.float32))
        df["decoder_layer_32"] = list(rng.randn(len(idx), 3).astype(np.float32))
        jstore.save_embeddings(df, str(tmp_path / "whisper"), split)
    meta_j, layers_j = jstore.load_embeddings_combined(str(tmp_path))
    meta, layers = store.load_embeddings_combined(str(tmp_path))
    _typed_equal(meta, _rows(meta_j))
    assert list(layers) == list(layers_j)
    for k in layers:
        np.testing.assert_array_equal(layers[k], layers_j[k])
    assert store.combined_top_key(["decoder_layer_40", "encoder_layer_3", "x"]) == \
        jstore.combined_top_key(["decoder_layer_40", "encoder_layer_3", "x"])


# ---------------------------------------------------------------- persistence


def test_save_and_load_model(tmp_path, rng):
    X = rng.randn(40, 8).astype(np.float32)
    y = rng.randint(0, 2, 40)
    head = heads.HeadClassifier(heads.HeadConfig(8, 2, (5,), epochs=5), device="cpu").fit(X, y)
    path = persistence.save_model(head, str(tmp_path), "wavlm", "layer_3", "mlp",
                                  {"accuracy": 1.0, "confusion_matrix": np.eye(2)},
                                  class_names=["a", "b"])
    assert path.endswith("wavlm_layer_3_mlp_model.npz")
    with np.load(path) as z:
        assert sorted(z.files) == ["head/0/b", "head/0/w", "head/1/b", "head/1/w",
                                   "scaler/mean", "scaler/scale"]
    loaded = persistence.load_model(path, device="cpu")
    np.testing.assert_array_equal(loaded.predict_proba(X), head.predict_proba(X))
    pipe = clf.make_classifier("rf", 8, 2).fit(X, y)
    path = persistence.save_model(pipe, str(tmp_path), "wavlm", "layer_3", "rf")
    assert path.endswith("_model.pkl")
    np.testing.assert_array_equal(persistence.load_model(path).predict(X), pipe.predict(X))


def test_modules_import_without_sklearn_and_matplotlib(tmp_path):
    """The card's machine has neither: every port module imports, the heads
    train, the sklearn backends and the plots name what they need."""
    code = (
        "import sys, importlib, pkgutil\n"
        "for name in ('sklearn', 'matplotlib', 'pandas', 'jax', 'joblib', 'stutter_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import numpy as np, stutter_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(stutter_tpu_torch.__path__,\n"
        "                                              'stutter_tpu_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "from stutter_tpu_torch.train import classifiers, trainer\n"
        "X = np.random.RandomState(0).randn(20, 4).astype(np.float32)\n"
        "y = np.arange(20) % 2\n"
        "classifiers.make_classifier('linear', 4, 2, head_overrides={'epochs': 2},\n"
        "                            device='cpu').fit(X, y)\n"
        "try:\n"
        "    classifiers.make_classifier('svm', 4, 2)\n"
        "except ImportError as e:\n"
        "    assert 'sklearn' in str(e) and \"'mlp'\" in str(e), e\n"
        "else:\n"
        "    raise SystemExit('svm did not raise')\n"
        "try:\n"
        "    trainer.run_balanced_training(trainer.TrainConfig('x', 'y', device='cpu'))\n"
        "except ImportError as e:\n"
        "    assert 'matplotlib' in str(e), e\n"
        "else:\n"
        "    raise SystemExit('make_plots without matplotlib did not raise')\n"
        "print('OK', len(mods))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=240)
    assert out.returncode == 0 and "OK" in out.stdout, out.stderr[-3000:]
