"""stutter_tpu_torch's chunk long-file policy against the JAX package.

Mirrors ``tests/test_chunked_extraction.py``: the same files and weights go
through both packages' ``chunked_embeddings`` and ``ExtractionPipeline(...,
long_file_policy="chunk")``. Rows must match within 1e-5 cosine (f32 on the
CPU), and the stores' metadata CSVs byte for byte (the same rows in the same
order). Clips are sized in frames for the tiny configs' 20x stem.
"""

import os

import jax
import numpy as np
import pytest
import torch

from stutter_tpu.audio import wavio as jwavio
from stutter_tpu.extract import (
    BucketBatcher as JaxBatcher,
    ExtractionPipeline as JaxPipeline,
    WavLMExtractor as JaxWavLM,
    WhisperExtractor as JaxWhisper,
    create_metadata_from_files as jax_scan,
)
from stutter_tpu.extract.pipeline import chunked_embeddings as jax_chunked
from stutter_tpu.models import WavLMConfig as JaxConfig, WhisperConfig as JaxWhisperConfig
from stutter_tpu.models import init_wavlm_params, init_whisper_params
from stutter_tpu_torch.audio.wavio import load_audio, write_wav
from stutter_tpu_torch.extract.batcher import Batch, BucketBatcher
from stutter_tpu_torch.extract.pipeline import (
    ExtractionPipeline,
    WavLMExtractor,
    WhisperExtractor,
    chunked_embeddings,
)
from stutter_tpu_torch.extract.scanner import create_metadata_from_files
from stutter_tpu_torch.models.wavlm import WavLMConfig, WavLMModel, wavlm_feature_lengths
from stutter_tpu_torch.models.whisper import WhisperConfig, WhisperModel
from stutter_tpu_torch.weights.convert import wavlm_params_from_numpy, whisper_params_from_numpy
from tests.conftest import cosine_distance

torch.set_num_threads(2)  # six xdist workers share the host

COSINE = 1e-5  # port vs JAX, f32 on the CPU
BUCKETS = dict(buckets_s=(0.5, 1.0), audio_budget_s=4.0)  # 1 s chunks: L = 800 frames


@pytest.fixture(scope="module")
def wavlm_pair():
    params = init_wavlm_params(jax.random.key(0), JaxConfig.tiny())
    model = WavLMModel(WavLMConfig.tiny())
    model.load_state_dict(wavlm_params_from_numpy(jax.tree.map(np.asarray, params),
                                                  WavLMConfig.tiny()))
    return (JaxWavLM(JaxConfig.tiny(), params, preset="fidelity"),
            WavLMExtractor(model, "cpu", preset="fidelity"))


def _write(dirpath, name, seconds, seed):
    x = (np.random.RandomState(seed).randn(int(seconds * 16000)) * 0.1).astype(np.float32)
    write_wav(str(dirpath / f"{name}.wav"), x, 16000)
    return str(dirpath / f"{name}.wav")


def _both_stores(tmp_path, pair, policy="chunk", **kw):
    jax_ex, ex = pair
    jax_out, out = str(tmp_path / "jax"), str(tmp_path / "port")
    jdf = JaxPipeline(jax_ex, batcher=JaxBatcher(**kw), long_file_policy=policy).run_split(
        jax_scan(str(tmp_path), split="train"), "train", jax_out)
    rows = ExtractionPipeline(ex, batcher=BucketBatcher(**kw), long_file_policy=policy) \
        .run_split(create_metadata_from_files(str(tmp_path), split="train"), "train", out)
    return jdf, rows, jax_out, out


def _assert_stores_match(jdf, rows, jax_out, out, columns):
    name = "embedding_metadata.csv"
    with open(os.path.join(jax_out, "train", name), "rb") as a, \
            open(os.path.join(out, "train", name), "rb") as b:
        assert b.read() == a.read()
    assert [r["path"] for r in rows] == list(jdf["path"])
    for col in columns:
        ours = np.load(os.path.join(out, "train", f"{col}_embeddings.npy"))
        ref = np.load(os.path.join(jax_out, "train", f"{col}_embeddings.npy"))
        assert ours.shape == ref.shape
        for a, b in zip(ours, ref):
            assert cosine_distance(a, b) <= COSINE


def test_chunked_long_file(tmp_path, wavlm_pair):
    (tmp_path / "wav").mkdir()
    _write(tmp_path / "wav", "train_short", 0.6, 0)
    long_path = _write(tmp_path / "wav", "train_long", 2.3, 1)  # 1 + 1 + 0.3 s chunks
    jdf, rows, jax_out, out = _both_stores(tmp_path, wavlm_pair, **BUCKETS)
    _, ex = wavlm_pair
    _assert_stores_match(jdf, rows, jax_out, out, ex.column_names)
    long_row = next(r for r in rows if r["filename"] == "train_long")
    assert long_row["chunks"] == 3 and "chunks" not in rows[1 - rows.index(long_row)]

    # the frame-weighted average of the per-chunk pools, decoded as the pipeline decodes
    batcher = BucketBatcher(**BUCKETS)
    wave = load_audio(long_path)
    chunk = batcher.bucket_samples(1.0)
    n = -(-len(wave) // chunk)
    waves, lengths = np.zeros((n, chunk), np.float32), np.zeros((n,), np.int64)
    for c in range(n):
        seg = wave[c * chunk: (c + 1) * chunk]
        waves[c, :len(seg)], lengths[c] = seg, len(seg)
    embs = ex(Batch(paths=["x"] * n, rows=list(range(n)), waves=waves, lengths=lengths,
                    ok=np.ones(n, bool), bucket_s=1.0))
    w = np.array([int(wavlm_feature_lengths(ex.cfg, int(k))) for k in lengths], np.float64)
    for col in ex.column_names:
        expected = (np.asarray(embs[col], np.float64) * (w / w.sum())[:, None]).sum(axis=0)
        np.testing.assert_allclose(long_row[col], expected, rtol=1e-5, atol=1e-6)

    # trim keeps the reference's rows: no chunks column
    jdf, rows, jax_out, out = _both_stores(tmp_path, wavlm_pair, policy="trim", **BUCKETS)
    assert not any("chunks" in r for r in rows) and "chunks" not in jdf.columns
    _assert_stores_match(jdf, rows, jax_out, out, ex.column_names)


def test_chunked_embeddings_match_jax(tmp_path, wavlm_pair):
    jax_ex, ex = wavlm_pair
    path = _write(tmp_path, "long", 2.3, 2)
    ours, n, audio_s = chunked_embeddings(ex, BucketBatcher(**BUCKETS), path)
    ref, jn, jaudio_s = jax_chunked(jax_ex, JaxBatcher(**BUCKETS), path)
    assert (n, audio_s) == (jn, jaudio_s) == (3, 2.3)
    for col in ex.column_names:
        assert ours[col].dtype == np.float32
        assert cosine_distance(ours[col], ref[col]) <= COSINE
    (tmp_path / "bad.wav").write_bytes(b"not audio")
    assert chunked_embeddings(ex, BucketBatcher(**BUCKETS), str(tmp_path / "bad.wav")) is None


def test_chunked_whisper_true_frame_weighting(tmp_path):
    """A 35 s file through the Whisper extractors: 30 + 5 s chunks weighted
    by true frames (n_samples // 320, at most 1500), the pool over padding kept."""
    cfg = WhisperConfig.tiny(d_model=32, layers=2, heads=4)
    params = init_whisper_params(jax.random.key(0), JaxWhisperConfig.tiny(d_model=32, layers=2,
                                                                          heads=4))
    model = WhisperModel(cfg)
    model.load_state_dict(whisper_params_from_numpy(jax.tree.map(np.asarray, params), cfg))
    pair = (JaxWhisper(JaxWhisperConfig.tiny(d_model=32, layers=2, heads=4), params,
                       preset="fidelity"),
            WhisperExtractor(model, "cpu", preset="fidelity"))
    (tmp_path / "wav").mkdir()
    path = _write(tmp_path / "wav", "train_long", 35.0, 3)
    kw = dict(buckets_s=(30.0,), audio_budget_s=120.0)
    jdf, rows, jax_out, out = _both_stores(tmp_path, pair, **kw)
    ex = pair[1]
    _assert_stores_match(jdf, rows, jax_out, out, ex.column_names)
    assert len(rows) == 1 and rows[0]["chunks"] == 2

    wave = load_audio(path)
    chunk = 16000 * 30
    waves, lengths = np.zeros((4, chunk), np.float32), np.zeros((4,), np.int64)
    for c in range(2):
        seg = wave[c * chunk: (c + 1) * chunk]
        waves[c, :len(seg)], lengths[c] = seg, len(seg)
    embs = ex(Batch(paths=["x"] * 2, rows=[0, 1], waves=waves, lengths=lengths,
                    ok=np.arange(4) < 2, bucket_s=30.0))
    w = np.array([min(1500, int(k) // 320) for k in lengths[:2]], np.float64)
    assert w[1] < w[0]  # the tail weighs less
    for col in ex.column_names:
        expected = (np.asarray(embs[col][:2], np.float64) * (w / w.sum())[:, None]).sum(axis=0)
        np.testing.assert_allclose(rows[0][col], expected, rtol=1e-5, atol=1e-6)


def test_chunked_files_share_batches(tmp_path, wavlm_pair):
    """Chunks of different files ride shared full-size batches (whole chunks
    in the top bucket, tails in their smallest covering bucket), and each
    file's row equals the single-file combiner's."""
    jax_ex, ex = wavlm_pair
    (tmp_path / "wav").mkdir()
    paths = [_write(tmp_path / "wav", f"train_long{i}", 2.4, 10 + i) for i in range(3)]
    calls = []
    real = ex.submit
    ex.submit = lambda batch: calls.append((batch.bucket_s, len(batch.waves))) or real(batch)
    try:
        jdf, rows, jax_out, out = _both_stores(tmp_path, wavlm_pair, **BUCKETS)
    finally:
        del ex.submit
    _assert_stores_match(jdf, rows, jax_out, out, ex.column_names)
    assert len(rows) == 3 and all(r["chunks"] == 3 for r in rows)
    # 6 whole 1 s chunks at batch_size_for(1.0) = 4 -> 2 batches; 3 tails of
    # 0.4 s at batch_size_for(0.5) = 8 -> 1 batch
    assert sorted(calls) == [(0.5, 8), (1.0, 4), (1.0, 4)], calls
    for path, row in zip(paths, rows):
        ref, n_chunks, _ = chunked_embeddings(ex, BucketBatcher(**BUCKETS), path)
        assert n_chunks == 3
        for col in ex.column_names:
            np.testing.assert_allclose(row[col], ref[col], rtol=5e-3, atol=1e-5)


def test_chunk_vs_native_embedding_close(tmp_path, wavlm_pair):
    """The chunk policy against one native forward of the whole clip: close
    on a stationary signal (a combiner fault lands far above the bar), and
    the same as the JAX package's chunk policy."""
    jax_ex, ex = wavlm_pair
    (tmp_path / "wav").mkdir()
    t = np.arange(32000) / 16000
    x = (0.4 * np.sin(2 * np.pi * 220 * t)
         + 0.1 * np.random.RandomState(4).randn(len(t))).astype(np.float32)
    write_wav(str(tmp_path / "wav" / "train_clip.wav"), x, 16000)
    meta = create_metadata_from_files(str(tmp_path), split="train")
    native = ExtractionPipeline(ex, batcher=BucketBatcher(buckets_s=(2.0,), audio_budget_s=8.0)
                                ).run_split(meta, "train", str(tmp_path / "native"))
    kw = dict(buckets_s=(0.25, 0.5), audio_budget_s=8.0)  # 4 chunks of 0.5 s
    jdf, chunked, jax_out, out = _both_stores(tmp_path, wavlm_pair, **kw)
    _assert_stores_match(jdf, chunked, jax_out, out, ex.column_names)
    assert chunked[0]["chunks"] == 4
    for col in ex.column_names:
        assert cosine_distance(native[0][col], chunked[0][col]) < 0.02, col
    np.testing.assert_array_equal(jwavio.load_audio(str(tmp_path / "wav" / "train_clip.wav")),
                                  load_audio(str(tmp_path / "wav" / "train_clip.wav")))


def test_chunked_checkpoints_match_jax(tmp_path, wavlm_pair):
    """Checkpoints come after each batch of short clips and after each
    chunked file, as in the JAX package; a resumed run skips the rows of the
    latest one and writes the same store."""
    from stutter_tpu.extract import find_latest_checkpoint, load_checkpoint

    (tmp_path / "wav").mkdir()
    for i, seconds in enumerate((0.4, 0.7, 1.6, 2.3)):
        _write(tmp_path / "wav", f"train_{i}", seconds, 20 + i)
    kw = dict(BUCKETS, audio_budget_s=1.0)  # one short clip a batch
    jax_ex, ex = wavlm_pair
    jax_out, out = str(tmp_path / "jax"), str(tmp_path / "port")
    JaxPipeline(jax_ex, batcher=JaxBatcher(**kw), long_file_policy="chunk",
                checkpoint_interval=1).run_split(jax_scan(str(tmp_path), split="train"),
                                                 "train", jax_out)
    pipe = ExtractionPipeline(ex, batcher=BucketBatcher(**kw), long_file_policy="chunk",
                              checkpoint_interval=1)
    meta = create_metadata_from_files(str(tmp_path), split="train")
    pipe.run_split(meta, "train", out)
    n = find_latest_checkpoint(out, "train")
    assert n == find_latest_checkpoint(jax_out, "train") == 4
    for k in range(1, n + 1):
        ours, ref = load_checkpoint(out, "train", k), load_checkpoint(jax_out, "train", k)
        assert [r["path"] for r in ours] == [r["path"] for r in ref]
        assert [r.get("chunks") for r in ours] == [r.get("chunks") for r in ref]
    # resume from the second checkpoint: only the rows after it are extracted
    resumed = str(tmp_path / "resumed")
    os.makedirs(os.path.join(resumed, "checkpoints"))
    name = os.path.join("checkpoints", "checkpoint_train_2.pkl")
    with open(os.path.join(out, name), "rb") as a, open(os.path.join(resumed, name), "wb") as b:
        b.write(a.read())
    submitted = []
    real = ex.submit
    ex.submit = lambda batch: submitted.extend(batch.paths) or real(batch)
    try:
        pipe.run_split(meta, "train", resumed, resume=True)
    finally:
        del ex.submit
    done = {r["path"] for r in load_checkpoint(out, "train", 2)}
    assert submitted and not done & set(submitted)
    with open(os.path.join(jax_out, "train", "embedding_metadata.csv"), "rb") as a, \
            open(os.path.join(resumed, "train", "embedding_metadata.csv"), "rb") as b:
        assert b.read() == a.read()
