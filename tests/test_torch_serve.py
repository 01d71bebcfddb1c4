"""stutter_tpu_torch's serving stack against the JAX package's.

Mirrors ``tests/test_serve.py``, ``tests/test_serve_classify.py``,
``tests/test_serve_combined.py`` and ``tests/test_serve_http.py`` on the
port's ``EmbeddingServer``, ``ServingClassifier``, ``CombinedExtractor``,
``HttpEmbeddingFrontend`` and ``cli.serve``, and holds the port's responses
to the JAX server's on the same files and weights: within 1e-5 cosine (f32
on the CPU). Every HTTP test binds port 0 and sets its own timeout. Clips
and buckets are sized in frames for the tiny configs' 20x stem.
"""

import glob
import http.client
import io
import json
import os
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from stutter_tpu.audio.synthetic import make_synthetic_corpus
from stutter_tpu.extract import BucketBatcher as JaxBatcher
from stutter_tpu.extract import WavLMExtractor as JaxWavLM
from stutter_tpu.extract import WhisperExtractor as JaxWhisper
from stutter_tpu.models import WavLMConfig as JaxConfig
from stutter_tpu.models import WhisperConfig as JaxWhisperConfig
from stutter_tpu.models import init_wavlm_params, init_whisper_params
from stutter_tpu.serve import CombinedExtractor as JaxCombined
from stutter_tpu.serve import EmbeddingServer as JaxServer
from stutter_tpu.serve import Request as JaxRequest
from stutter_tpu_torch.audio.wavio import load_audio, write_wav
from stutter_tpu_torch.cli import serve as serve_cli
from stutter_tpu_torch.extract.batcher import BucketBatcher
from stutter_tpu_torch.extract.pipeline import (
    ExtractionPipeline,
    WavLMExtractor,
    WhisperExtractor,
    chunked_embeddings,
)
from stutter_tpu_torch.extract.scanner import create_metadata_from_files
from stutter_tpu_torch.extract.store import load_embeddings_combined
from stutter_tpu_torch.models.wavlm import WavLMConfig, WavLMModel
from stutter_tpu_torch.models.whisper import WhisperConfig, WhisperModel
from stutter_tpu_torch.serve.classify import ServingClassifier, sidecar_path
from stutter_tpu_torch.serve.combined import CombinedExtractor
from stutter_tpu_torch.serve.http import HttpEmbeddingFrontend
from stutter_tpu_torch.serve.server import EmbeddingServer, Request, jsonl_requests
from stutter_tpu_torch.train.classifiers import make_classifier
from stutter_tpu_torch.train.heads import HeadClassifier, HeadConfig
from stutter_tpu_torch.train.persistence import load_model, save_model
from stutter_tpu_torch.weights.convert import wavlm_params_from_numpy, whisper_params_from_numpy
from tests.conftest import cosine_distance

torch.set_num_threads(2)  # six xdist workers share the host

COSINE = 1e-5  # port vs JAX, f32 on the CPU
BUCKETS = (0.5, 1.0)  # tiny stem: a 1 s bucket is L = 800 frames
CLASS_NAMES = ["Block", "Fluent", "Prolongation"]
HTTP_TIMEOUT_S = 60


def _batcher(**kw):
    return BucketBatcher(**dict(dict(buckets_s=BUCKETS, audio_budget_s=4.0, max_batch=4), **kw))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve_corpus")
    make_synthetic_corpus(str(root), n_per_split={"train": 6}, duration_range=(0.3, 0.9))
    return sorted(glob.glob(os.path.join(str(root), "wav", "*.wav")))


@pytest.fixture(scope="module")
def wavlm_pair():
    params = init_wavlm_params(jax.random.key(0), JaxConfig.tiny())
    model = WavLMModel(WavLMConfig.tiny())
    model.load_state_dict(wavlm_params_from_numpy(jax.tree.map(np.asarray, params),
                                                  WavLMConfig.tiny()))
    return (JaxWavLM(JaxConfig.tiny(), params, preset="fidelity"),
            WavLMExtractor(model, "cpu", preset="fidelity"))


@pytest.fixture(scope="module")
def extractor(wavlm_pair):
    return wavlm_pair[1]


@pytest.fixture(scope="module")
def whisper_pair():
    jcfg = JaxWhisperConfig.tiny(d_model=32, layers=2, heads=4)
    cfg = WhisperConfig.tiny(d_model=32, layers=2, heads=4)
    params = init_whisper_params(jax.random.key(1), jcfg)
    model = WhisperModel(cfg)
    model.load_state_dict(whisper_params_from_numpy(jax.tree.map(np.asarray, params), cfg))
    return (JaxWhisper(jcfg, params, preset="fidelity"),
            WhisperExtractor(model, "cpu", preset="fidelity"))


def _serve(extractor, paths, ids=None, **kw):
    kw.setdefault("batcher", _batcher())
    kw.setdefault("max_wait_s", 0.01)
    kw.setdefault("max_clips", 4)
    server = EmbeddingServer(extractor, **kw)
    responses = []
    server.serve(iter([Request(i, p) for i, p in zip(ids or paths, paths)]), responses.append)
    return server, responses


def _jax_serve(extractor, paths, buckets=BUCKETS, **kw):
    server = JaxServer(extractor, batcher=JaxBatcher(buckets_s=buckets, audio_budget_s=4.0,
                                                     max_batch=4),
                       max_wait_s=0.01, max_clips=4, **kw)
    responses = []
    server.serve(iter([JaxRequest(p, p) for p in paths]), responses.append)
    return {r.req_id: r for r in responses}


def _long_clip(corpus, tmp_path, seconds=2.3):
    wave = load_audio(corpus[0])
    long_wave = np.tile(wave, int(np.ceil(seconds * 16000 / len(wave))))[: int(seconds * 16000)]
    path = str(tmp_path / "long.wav")
    write_wav(path, long_wave, 16000)
    return path


def _head_artifact(out_dir, layer, dim, hidden=(), class_names=CLASS_NAMES, seed=0):
    """A HeadClassifier fitted on the CPU and written as the trainer writes it."""
    rs = np.random.RandomState(seed)
    X = rs.randn(30, dim).astype(np.float32)
    y = rs.randint(0, len(class_names), size=30)
    head = HeadClassifier(HeadConfig(in_dim=dim, n_classes=len(class_names), hidden_dims=hidden,
                                     epochs=3, batch_size=8), device="cpu").fit(X, y)
    return save_model(head, str(out_dir), "wavlm", layer, "mlp" if hidden else "linear",
                      class_names=class_names)


def _sklearn_artifact(out_dir, layer, dim):
    from sklearn.linear_model import LogisticRegression
    from sklearn.pipeline import Pipeline
    from sklearn.preprocessing import StandardScaler

    rs = np.random.RandomState(0)
    X = rs.randn(30, dim).astype(np.float32)
    y = rs.randint(0, len(CLASS_NAMES), size=30)
    model = Pipeline([("scaler", StandardScaler()),
                      ("clf", LogisticRegression(max_iter=200))]).fit(X, y)
    return save_model(model, str(out_dir), "wavlm", layer, "svm", {"accuracy": 1.0},
                      class_names=CLASS_NAMES)


@pytest.fixture(scope="module")
def model_path(tmp_path_factory, extractor):
    return _head_artifact(tmp_path_factory.mktemp("clf"), extractor.column_names[0],
                          extractor.embedding_dim)


# --- the server (tests/test_serve.py) -----------------------------------------


def test_server_serves_all_requests(corpus, extractor):
    server, responses = _serve(extractor, corpus, ids=[f"r{i}" for i in range(len(corpus))],
                               max_wait_s=0.05)
    assert sorted(r.req_id for r in responses) == sorted(f"r{i}" for i in range(len(corpus)))
    for r in responses:
        assert r.ok, r.error
        for vec in r.embeddings.values():
            assert vec.shape == (extractor.embedding_dim,) and np.isfinite(vec).all()
    # on the CPU the forward runs inside submit, so collect's wait is ~0 here
    # (chip_smoke.py's [serve] holds it > 0 on the card)
    s = server.stats()
    assert s["audio_s_served"] == round(sum(len(load_audio(p)) for p in corpus) / 16000, 2)
    assert s["device_collect_s"] >= 0 and s["device_s_per_audio_s"] >= 0


def test_server_responses_match_jax(corpus, wavlm_pair, tmp_path):
    """The same files and weights through both servers, long clip included."""
    jax_ex, ex = wavlm_pair
    paths = corpus + [_long_clip(corpus, tmp_path)]
    ref = _jax_serve(jax_ex, paths)
    _, responses = _serve(ex, paths)
    assert sorted(r.req_id for r in responses) == sorted(ref)
    for r in responses:
        assert r.ok and ref[r.req_id].ok
        assert sorted(r.embeddings) == sorted(ref[r.req_id].embeddings)
        for col, vec in r.embeddings.items():
            assert cosine_distance(vec, ref[r.req_id].embeddings[col]) <= COSINE, (r.path, col)


def test_server_reports_decode_failures(corpus, extractor, tmp_path):
    bad = tmp_path / "not_a_wav.wav"
    bad.write_bytes(b"garbage")
    _, responses = _serve(extractor, [corpus[0], str(bad)], ids=["good", "bad"])
    by_id = {r.req_id: r for r in responses}
    assert by_id["good"].ok
    assert not by_id["bad"].ok and by_id["bad"].embeddings is None
    assert by_id["bad"].error == "decode failed"


def test_server_results_match_pipeline(corpus, extractor):
    """Served embeddings == the extractor on the batch the pipeline makes."""
    _, responses = _serve(extractor, [corpus[0]], ids=["x"], max_clips=8)
    batch = next(_batcher().batches([corpus[0]], prefetch=False))
    direct = extractor(batch)
    for col, vec in responses[0].embeddings.items():
        np.testing.assert_allclose(vec, direct[col][0], rtol=1e-5, atol=1e-6)


def test_jsonl_requests_parsing():
    reqs = list(jsonl_requests(io.StringIO('{"id": "a", "path": "/x.wav"}\n\n/bare/path.wav\n'
                                           '{"path": "/y.wav"}\n')))
    assert [(r.req_id, r.path) for r in reqs] == [("a", "/x.wav"), ("2", "/bare/path.wav"),
                                                  ("3", "/y.wav")]


def _tiny_wavlm_cli(monkeypatch):
    monkeypatch.setattr(WavLMConfig, "base", staticmethod(lambda: WavLMConfig.tiny(32, 2, 4)))


def test_serve_cli_end_to_end(corpus, tmp_path, monkeypatch, capsys):
    _tiny_wavlm_cli(monkeypatch)
    req_file = tmp_path / "reqs.jsonl"
    req_file.write_text("\n".join(json.dumps({"id": f"q{i}", "path": p})
                                  for i, p in enumerate(corpus[:3])) + "\n")
    rc = serve_cli.main(["--model_type", "wavlm", "--model_name", "microsoft/wavlm-base",
                         "--random_init", "--input", str(req_file), "--device", "cpu",
                         "--output_dir", str(tmp_path / "emb"), "--max_wait_ms", "10",
                         "--buckets", "0.5,1.0", "--warmup"])
    assert rc == 0
    out = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    assert sorted(o["id"] for o in out) == ["q0", "q1", "q2"] and all(o["ok"] for o in out)
    for o in out:
        arr = np.load(o["file"])
        assert arr.shape == (len(o["columns"]), 32) and np.isfinite(arr).all()


def test_server_partial_round_failure_no_double_answers(corpus, extractor):
    """One failing bucket batch fails only its own requests, and no request
    is answered twice."""

    class Flaky:
        def __init__(self, inner):
            self.inner, self.calls = inner, 0

        def submit(self, batch):
            self.calls += 1
            if self.calls == 2:
                raise RuntimeError("boom")
            return self.inner.submit(batch)

        def collect(self, handle):
            return self.inner.collect(handle)

    _, responses = _serve(Flaky(extractor), corpus[:4], ids=[f"r{i}" for i in range(4)],
                          batcher=_batcher(audio_budget_s=2.0, max_batch=2), max_wait_s=0.05,
                          max_clips=8)
    assert sorted(r.req_id for r in responses) == [f"r{i}" for i in range(4)]
    assert any(not r.ok and "batch failed: boom" in (r.error or "") for r in responses)
    assert any(r.ok for r in responses)


def test_server_chunks_long_clips(corpus, extractor, tmp_path):
    """A clip over the top bucket is chunked like ``chunked_embeddings``;
    'trim' serves its first bucket instead."""
    long_path = _long_clip(corpus, tmp_path)
    batcher = _batcher(audio_budget_s=8.0)
    _, responses = _serve(extractor, [long_path, corpus[1]], ids=["long", "short"],
                          batcher=batcher, long_clip_policy="chunk")
    by_id = {r.req_id: r for r in responses}
    assert by_id["short"].ok and by_id["long"].ok
    expected, n_chunks, audio_s = chunked_embeddings(extractor, _batcher(audio_budget_s=8.0),
                                                     long_path)
    assert n_chunks == 3 and abs(audio_s - 2.3) < 1e-6
    for col in expected:
        np.testing.assert_allclose(by_id["long"].embeddings[col], expected[col], rtol=1e-5,
                                   atol=1e-6)
    _, trimmed = _serve(extractor, [long_path], ids=["long"], batcher=batcher,
                        long_clip_policy="trim")
    col = next(iter(expected))
    assert trimmed[0].ok and not np.allclose(trimmed[0].embeddings[col], expected[col])
    with pytest.raises(ValueError, match="long_clip_policy"):
        EmbeddingServer(extractor, long_clip_policy="drop")


def test_server_latency_stats(corpus, extractor):
    server, _ = _serve(extractor, corpus[:4], ids=[f"r{i}" for i in range(4)])
    s = server.stats()
    assert s["served"] == 4 and s["failed"] == 0 and s["rounds"] >= 1
    assert 0 < s["p50_s"] <= s["p95_s"] <= s["max_s"]
    server.reset_stats()
    assert server.stats() == {"served": 0, "failed": 0, "rounds": 0, "device_collect_s": 0.0,
                              "audio_s_served": 0.0}


def test_pipelined_round_drains_on_idle_queue(corpus, extractor):
    """The round in flight is answered as soon as the queue idles: a lone
    request never waits for later traffic."""
    server = EmbeddingServer(extractor, batcher=_batcher(), max_wait_s=0.01, max_clips=2)
    responses = []
    first_answered = threading.Event()

    def emit(r):
        responses.append(r)
        first_answered.set()

    def reqs():
        yield Request("a", corpus[0])
        if not first_answered.wait(timeout=120):
            return
        yield Request("b", corpus[1])

    th = threading.Thread(target=lambda: server.serve(reqs(), emit), daemon=True)
    th.start()
    th.join(timeout=240)
    assert not th.is_alive(), "serve loop did not terminate"
    assert [r.req_id for r in responses] == ["a", "b"] and all(r.ok for r in responses)


def test_serve_cli_refuses_bad_mesh_and_bad_address(tmp_path, monkeypatch):
    """A --tp that does not divide --devices, and a bad --http address, are
    refused before any model is built or rank spawned."""
    from stutter_tpu_torch.cli import train as train_cli

    def no_model(*a, **k):
        raise AssertionError("a model was built")

    monkeypatch.setattr(train_cli, "build_extractor_for", no_model)
    for mesh in (["--devices", "2", "--tp", "3"], ["--tp", "2"]):
        with pytest.raises(ValueError, match="mesh"):
            serve_cli.main(["--random_init", "--device", "cpu", "--input",
                            str(tmp_path / "x"), *mesh])
    assert serve_cli.main(["--model_type", "wavlm", "--random_init", "--http", "localhost",
                           "--devices", "2", "--tp", "3"]) == 2


# --- classification (tests/test_serve_classify.py) ---------------------------


def test_sidecar_contract_and_load(model_path, extractor, tmp_path):
    assert sidecar_path(model_path) == model_path.replace("_model.npz", "_info.json")
    with open(sidecar_path(model_path)) as f:
        info = json.load(f)
    assert info["class_names"] == CLASS_NAMES and info["layer"] == extractor.column_names[0]
    clf = ServingClassifier.load(model_path, device="cpu")
    assert clf.layer == extractor.column_names[0] and clf.class_names == CLASS_NAMES
    assert isinstance(clf.estimator, HeadClassifier)
    joblib_path = str(tmp_path / "wavlm_layer_2_svm_model.joblib")
    with pytest.raises(ValueError, match=r"_model\.npz .*_model\.pkl"):
        ServingClassifier.load(joblib_path, device="cpu")


@pytest.mark.parametrize("kind", ["npz", "pkl"])
def test_predict_rows_labels_and_probs(model_path, tmp_path, kind):
    path = model_path if kind == "npz" else _sklearn_artifact(tmp_path, "layer_2", 32)
    clf = ServingClassifier.load(path, device="cpu")
    X = np.random.RandomState(1).randn(5, 32).astype(np.float32)
    labels, probs = clf.predict_rows(X)
    assert labels == [CLASS_NAMES[int(i)] for i in load_model(path, device="cpu").predict(X)]
    assert probs is not None and len(probs) == 5
    for p in probs:
        assert set(p) <= set(CLASS_NAMES) and abs(sum(p.values()) - 1.0) < 1e-6


def test_server_classifies_responses(corpus, extractor, model_path):
    clf = ServingClassifier.load(model_path, device="cpu")
    _, responses = _serve(extractor, corpus, classifier=clf, max_wait_s=0.05)
    assert len(responses) == len(corpus)
    reference = load_model(model_path, device="cpu")
    for r in responses:
        assert r.ok, r.error
        assert r.prediction in CLASS_NAMES and abs(sum(r.probs.values()) - 1.0) < 1e-6
        row = r.embeddings[clf.layer][None, :]
        assert r.prediction == CLASS_NAMES[int(reference.predict(row)[0])]


def test_server_rejects_mismatched_layer(extractor, model_path):
    clf = ServingClassifier.load(model_path, device="cpu")
    clf.layer = "layer_does_not_exist"
    with pytest.raises(ValueError, match="trained on column"):
        EmbeddingServer(extractor, classifier=clf)


def test_classification_failure_still_ships_embeddings(corpus, extractor, model_path, tmp_path):
    clf = ServingClassifier.load(model_path, device="cpu")
    clf.estimator = None  # predict raises AttributeError
    long_path = _long_clip(corpus, tmp_path)
    _, responses = _serve(extractor, [corpus[0], long_path], ids=["a", "long"], classifier=clf)
    for r in responses:
        assert r.ok and r.prediction is None and "classification failed" in r.error
        assert np.isfinite(r.embeddings[clf.layer]).all()


def test_server_classifies_chunked_long_clips(corpus, extractor, model_path, tmp_path):
    clf = ServingClassifier.load(model_path, device="cpu")
    _, responses = _serve(extractor, [_long_clip(corpus, tmp_path)], ids=["long"],
                          classifier=clf, long_clip_policy="chunk")
    r = responses[0]
    assert r.ok and r.prediction in CLASS_NAMES
    assert r.prediction == clf.predict_rows(r.embeddings[clf.layer][None, :])[0][0]


def test_serve_cli_with_classifier(corpus, model_path, tmp_path, monkeypatch, capsys):
    _tiny_wavlm_cli(monkeypatch)
    req_file = tmp_path / "reqs.jsonl"
    req_file.write_text(json.dumps({"id": "q0", "path": corpus[0]}) + "\n")
    rc = serve_cli.main(["--model_type", "wavlm", "--model_name", "microsoft/wavlm-base",
                         "--random_init", "--input", str(req_file), "--device", "cpu",
                         "--max_wait_ms", "10", "--buckets", "1.0",
                         "--classifier_model", model_path])
    assert rc == 0
    (out,) = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    assert out["ok"] and out["prediction"] in CLASS_NAMES
    assert abs(sum(out["probs"].values()) - 1.0) < 1e-6
    emb = {k: np.asarray(v, np.float32) for k, v in out["embeddings"].items()}
    direct = load_model(model_path, device="cpu").predict(emb["layer_2"][None, :])
    assert out["prediction"] == CLASS_NAMES[int(direct[0])]


def test_label_encoded_backend_probs_align(tmp_path):
    """The 'xgb' backend's label-encoder round trip exposes classes_, so that
    probability columns map to the original labels when a class was never
    trained."""
    names = ["A", "B", "C", "D"]
    rs = np.random.RandomState(3)
    X = rs.randn(40, 8).astype(np.float32)
    y = rs.choice([0, 1, 3], size=40)  # class 2 never trained
    model = make_classifier("xgb", 8, 4, device="cpu").fit(X, y)
    np.testing.assert_array_equal(np.asarray(model.classes_), [0, 1, 3])
    clf = ServingClassifier.load(save_model(model, str(tmp_path), "wavlm", "layer_2", "xgb",
                                            class_names=names), device="cpu")
    labels, probs = clf.predict_rows(rs.randn(6, 8).astype(np.float32))
    for lab, p in zip(labels, probs):
        assert set(p) == {"A", "B", "D"} and lab == max(p, key=p.get)


def test_mlp_head_served_predictions(corpus, extractor, tmp_path):
    """The port's MLP head (what cli.train writes) serves through the same path."""
    path = _head_artifact(tmp_path, extractor.column_names[-1], extractor.embedding_dim,
                          hidden=(16,), class_names=["NoStutter", "Stutter"])
    clf = ServingClassifier.load(path, device="cpu")
    _, responses = _serve(extractor, [corpus[0]], ids=["a"], classifier=clf)
    r = responses[0]
    assert r.ok and r.prediction in ("NoStutter", "Stutter")
    assert set(r.probs) == {"NoStutter", "Stutter"}


# --- both backbones (tests/test_serve_combined.py) ---------------------------


@pytest.fixture(scope="module")
def combined_corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("combined_corpus")
    make_synthetic_corpus(str(root), n_per_split={"devel": 3}, seed=5, duration_range=(0.4, 0.9))
    return str(root)


def test_combined_columns_match_fusion_store_and_jax(combined_corpus, wavlm_pair, whisper_pair,
                                                     tmp_path):
    """Server columns == the port's fusion store's, values aligned; and the
    JAX package's combined server gives the same responses."""
    meta = create_metadata_from_files(combined_corpus, split="devel")
    emb_root = str(tmp_path / "emb")
    for name, part, buckets in (("wavlm", wavlm_pair[1], (1.0,)),
                                ("whisper", whisper_pair[1], (30.0,))):
        ExtractionPipeline(part, batcher=BucketBatcher(buckets_s=buckets, audio_budget_s=120.0)
                           ).run_split(meta, "devel", os.path.join(emb_root, name))
    store_meta, store_layers = load_embeddings_combined(emb_root, splits=("devel",))
    combined = CombinedExtractor(wavlm_pair[1], whisper_pair[1])
    paths = [r["path"] for r in meta]
    _, responses = _serve(combined, paths, batcher=_batcher(audio_budget_s=120.0))
    assert all(r.ok for r in responses)
    assert set(store_layers) == set(combined.column_names)
    by_path = {r.path: r for r in responses}
    for i, row in enumerate(store_meta):
        resp = by_path[row["path"]]
        for col, arr in store_layers.items():
            assert cosine_distance(arr[i], resp.embeddings[col]) < 1e-5, (col, row["path"])
    ref = _jax_serve(JaxCombined(wavlm_pair[0], whisper_pair[0]), paths)
    for r in responses:
        assert sorted(r.embeddings) == sorted(ref[r.path].embeddings)
        for col, vec in r.embeddings.items():
            assert cosine_distance(vec, ref[r.path].embeddings[col]) <= COSINE, col


def test_combined_top_is_hstack_of_parts(combined_corpus, wavlm_pair, whisper_pair):
    wavlm, whisper = wavlm_pair[1], whisper_pair[1]
    combined = CombinedExtractor(wavlm, whisper)
    paths = sorted(glob.glob(os.path.join(combined_corpus, "wav", "*.wav")))
    _, (r,) = _serve(combined, paths[:1])
    assert r.ok
    np.testing.assert_array_equal(
        r.embeddings["combined_top"],
        np.hstack([r.embeddings[f"wavlm_layer_{wavlm.cfg.num_hidden_layers}"],
                   r.embeddings[f"whisper_encoder_layer_{whisper.cfg.encoder_layers}"]]))
    assert combined.embedding_dim == r.embeddings["combined_top"].shape[0]


def test_combined_classifier_serves(combined_corpus, wavlm_pair, whisper_pair, tmp_path):
    combined = CombinedExtractor(wavlm_pair[1], whisper_pair[1])
    path = _head_artifact(tmp_path, "combined_top", 64, class_names=["Fluent", "Stutter"])
    clf = ServingClassifier.load(path, device="cpu")
    paths = sorted(glob.glob(os.path.join(combined_corpus, "wav", "*.wav")))
    _, responses = _serve(combined, paths, classifier=clf)
    for r in responses:
        assert r.ok and r.prediction in ("Fluent", "Stutter")
        assert abs(sum(r.probs.values()) - 1.0) < 1e-6


def test_serve_cli_combined(combined_corpus, tmp_path, monkeypatch, capsys):
    _tiny_wavlm_cli(monkeypatch)
    monkeypatch.setattr(WhisperConfig, "large",
                        staticmethod(lambda: WhisperConfig.tiny(d_model=32, layers=2, heads=4)))
    paths = sorted(glob.glob(os.path.join(combined_corpus, "wav", "*.wav")))
    req_file = tmp_path / "reqs.jsonl"
    req_file.write_text(json.dumps({"id": "c0", "path": paths[0]}) + "\n")
    rc = serve_cli.main(["--model_type", "combined", "--model_name", "microsoft/wavlm-base",
                         "--random_init", "--input", str(req_file), "--device", "cpu",
                         "--output_dir", str(tmp_path / "emb_out"), "--max_wait_ms", "10",
                         "--buckets", "1.0"])
    assert rc == 0
    (out,) = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    assert out["ok"] and "combined_top" in out["columns"]
    with np.load(out["file"]) as z:  # ragged widths: an npz keyed by column
        assert "combined_top" in z.files and np.isfinite(z["combined_top"]).all()


# --- HTTP (tests/test_serve_http.py) -----------------------------------------


@pytest.fixture(scope="module")
def frontend(extractor):
    server = EmbeddingServer(extractor, batcher=_batcher(), max_wait_s=0.05, max_clips=4)
    fe = HttpEmbeddingFrontend(server, port=0, request_timeout_s=HTTP_TIMEOUT_S)
    fe.start()
    yield fe
    fe.shutdown()


def _url(frontend, path):
    return f"http://{frontend.host}:{frontend.port}{path}"


def _post(frontend, body: bytes, ctype: str):
    req = urllib.request.Request(_url(frontend, "/embed"), data=body,
                                 headers={"Content-Type": ctype}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=HTTP_TIMEOUT_S) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_embed_json_path(frontend, corpus, extractor):
    status, obj = _post(frontend, json.dumps({"path": corpus[0]}).encode(), "application/json")
    assert status == 200 and obj["ok"]
    direct = extractor(next(_batcher().batches([corpus[0]], prefetch=False)))
    for col, vec in obj["embeddings"].items():
        np.testing.assert_allclose(np.asarray(vec, np.float32), direct[col][0], rtol=1e-5,
                                   atol=1e-6)


def test_http_embed_raw_wav_bytes(frontend, corpus):
    with open(corpus[1], "rb") as f:
        status, obj = _post(frontend, f.read(), "audio/wav")
    assert status == 200 and obj["ok"] and obj["embeddings"]


def test_http_embed_raw_flac_bytes_is_a_decode_failure(frontend, corpus, tmp_path):
    """A FLAC body: where the host has libav the port decodes it, as the JAX
    package does, and answers 200 with the WAV body's embedding (the FLAC
    holds the WAV's samples exactly); without libav it gets the
    decode-failure answer, 422."""
    from stutter_tpu_torch.audio.build import get_ff_lib
    from stutter_tpu_torch.audio.wavio import encode_audio, read_wav

    flac = str(tmp_path / "clip.flac")
    libav = get_ff_lib() is not None
    if libav:  # n / 32768 from the WAV, encoded from n / 32767 (audio.synthetic.flac_copy)
        x, sr = read_wav(corpus[2])
        encode_audio(flac, x * np.float32(32768 / 32767), sr)
    else:  # a FLAC stream's magic and a STREAMINFO header, enough for any sniffer
        with open(flac, "wb") as f:
            f.write(b"fLaC\x80\x00\x00\x22" + bytes(34))
    with open(flac, "rb") as f:
        body = f.read()
    assert body[:4] == b"fLaC"
    status, obj = _post(frontend, body, "audio/flac")
    if not libav:
        assert status == 422 and not obj["ok"] and obj["error"] == "decode failed"
        return
    assert status == 200 and obj["ok"]
    with open(corpus[2], "rb") as f:
        wav_status, wav_obj = _post(frontend, f.read(), "audio/wav")
    assert wav_status == 200 and set(obj["embeddings"]) == set(wav_obj["embeddings"])
    for col, vec in obj["embeddings"].items():
        np.testing.assert_allclose(vec, wav_obj["embeddings"][col], rtol=1e-6, atol=1e-7)


def test_http_concurrent_requests_all_answered(frontend, corpus):
    results = {}

    def worker(i, path):
        results[i] = _post(frontend, json.dumps({"path": path}).encode(), "application/json")

    threads = [threading.Thread(target=worker, args=(i, p)) for i, p in enumerate(corpus[:4])]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=HTTP_TIMEOUT_S)
    assert len(results) == 4
    assert all(status == 200 and obj["ok"] for status, obj in results.values())


def test_http_decode_failure_is_422(frontend, tmp_path):
    bad = tmp_path / "junk.wav"
    bad.write_bytes(b"not audio")
    status, obj = _post(frontend, json.dumps({"path": str(bad)}).encode(), "application/json")
    assert status == 422 and not obj["ok"] and obj["error"]


@pytest.mark.parametrize("body", [b'{"nope": 1}', b"[1]", b'{"path": 5}', b"{"])
def test_http_bad_request_is_400(frontend, body):
    status, obj = _post(frontend, body, "application/json")
    assert status == 400 and not obj["ok"]


def test_http_stats_and_healthz(frontend, corpus):
    _post(frontend, json.dumps({"path": corpus[2]}).encode(), "application/json")
    with urllib.request.urlopen(_url(frontend, "/healthz"), timeout=HTTP_TIMEOUT_S) as r:
        assert r.status == 200 and json.loads(r.read())["ok"]
    with urllib.request.urlopen(_url(frontend, "/stats"), timeout=HTTP_TIMEOUT_S) as r:
        stats = json.loads(r.read())
    assert stats["served"] >= 1 and "p50_s" in stats and "device_s_per_audio_s" in stats


def test_http_unknown_path_is_404(frontend):
    for method in ("GET", "POST"):
        req = urllib.request.Request(_url(frontend, "/nope"), data=b"x" if method == "POST"
                                     else None, method=method)
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=HTTP_TIMEOUT_S)
        assert e.value.code == 404


def test_http_oversized_body_closes_connection(frontend):
    """A 400 for an oversized body closes the keep-alive connection, so that
    the unread body is never parsed as the next request."""
    conn = http.client.HTTPConnection(frontend.host, frontend.port, timeout=HTTP_TIMEOUT_S)
    try:
        conn.putrequest("POST", "/embed")
        conn.putheader("Content-Type", "application/octet-stream")
        conn.putheader("Content-Length", str(200 * 1024 * 1024))  # over the 64 MB cap
        conn.endheaders()
        conn.send(b"RIFFgarbage")
        resp = conn.getresponse()
        assert resp.status == 400
        resp.read()
        with pytest.raises((http.client.HTTPException, ConnectionError, OSError)):
            conn.putrequest("GET", "/healthz")
            conn.endheaders()
            if conn.getresponse().status:
                raise AssertionError("connection was not closed after the 400")
    finally:
        conn.close()
