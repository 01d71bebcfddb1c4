"""Compressed audio (FLAC, MP3, OGG) through the port's libav library against
the JAX package's, on the CPU.

Skipped where the host has no libav, as ``tests/test_audio_formats.py`` is.
Fixtures are encoded in-process by the same library. FLAC is lossless, so
its decode is sample-exact; the lossy codecs are held bit-equal to JAX's
decode of the same file (both packages build the same sources). End to end,
a tiny WavLM's ``ExtractionPipeline`` over a FLAC copy of a synthetic corpus
writes the WAV corpus's rows bit for bit, and JAX's pipeline extracts the
same FLAC corpus within ``test_torch_extract.py``'s bar.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from stutter_tpu.audio import wavio as jwavio
from stutter_tpu.audio.build import get_ff_lib as jax_ff_lib
from stutter_tpu.extract import (
    ExtractionPipeline as JaxPipeline,
    WavLMExtractor as JaxExtractor,
    create_metadata_from_files as jax_scan,
)
from stutter_tpu.extract.batcher import BucketBatcher as JaxBatcher
from stutter_tpu.models import WavLMConfig as JaxConfig
from stutter_tpu.models import init_wavlm_params
from stutter_tpu_torch.audio import wavio
from stutter_tpu_torch.audio.synthetic import flac_copy, make_synthetic_corpus
from stutter_tpu_torch.extract.batcher import BucketBatcher
from stutter_tpu_torch.extract.pipeline import ExtractionPipeline, WavLMExtractor
from stutter_tpu_torch.extract.scanner import create_metadata_from_files
from stutter_tpu_torch.models.wavlm import WavLMConfig, WavLMModel
from stutter_tpu_torch.weights.convert import wavlm_params_from_numpy
from tests.conftest import cosine_distance

pytestmark = pytest.mark.skipif(
    jax_ff_lib() is None, reason="libav extension unavailable on this host"
)

torch.set_num_threads(2)  # six xdist workers share the host

SR = 22050
PORT_VS_JAX_COSINE = 1e-6  # test_torch_extract.py's store bar (fidelity, f32)


def _chirp(n: int, sr: int = SR, seed: int = 0) -> np.ndarray:
    t = np.arange(n) / sr
    rs = np.random.RandomState(seed)
    x = 0.4 * np.sin(2 * np.pi * (200 + 1500 * t) * t) + 0.05 * rs.randn(n)
    return np.clip(x, -0.99, 0.99).astype(np.float32)


def _lattice(x: np.ndarray) -> np.ndarray:
    """What a 16-bit FLAC of x decodes to: round(x * 32767) / 32768."""
    return np.rint(x * 32767.0).astype(np.int16).astype(np.float32) / 32768.0


def test_flac_round_trip_sample_exact(tmp_path):
    x = _chirp(SR)
    p = str(tmp_path / "clip.flac")
    wavio.encode_audio(p, x, SR)
    y, sr = wavio.read_wav(p)
    assert sr == SR and len(y) == len(x)
    np.testing.assert_array_equal(y, _lattice(x))
    np.testing.assert_array_equal(y, jwavio.read_wav(p)[0])


def test_flac_stereo_mean_mixdown(tmp_path):
    x = _chirp(SR)
    p = str(tmp_path / "st.flac")
    wavio.encode_audio(p, np.stack([x, 0.5 * x], axis=1), SR)
    y, _ = wavio.read_wav(p)
    np.testing.assert_allclose(y, (_lattice(x) + _lattice(0.5 * x)) / 2.0, atol=1e-7)
    np.testing.assert_array_equal(y, jwavio.read_wav(p)[0])


@pytest.mark.parametrize("ext", ["mp3", "ogg"])
def test_lossy_decode_bit_equal_to_jax(tmp_path, ext):
    x = _chirp(2 * SR)
    p = str(tmp_path / f"clip.{ext}")
    jwavio.encode_audio(p, x, SR)  # one file, decoded by both packages
    ours, sr = wavio.read_wav(p)
    ref, ref_sr = jwavio.read_wav(p)
    assert sr == ref_sr == SR and abs(len(ours) - len(x)) < 4096
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(wavio.load_audio(p), jwavio.load_audio(p))


@pytest.mark.parametrize("ext", ["flac", "mp3"])
def test_audio_info_probe_equals_jax(tmp_path, ext):
    x = _chirp(3 * SR)
    p = str(tmp_path / f"probe.{ext}")
    wavio.encode_audio(p, x, SR)
    assert wavio.audio_info(p) == jwavio.audio_info(p)
    if ext == "flac":
        assert wavio.audio_info(p) == (len(x), SR)  # STREAMINFO is exact


def test_mixed_format_batch_through_the_thread_pool(tmp_path):
    x = _chirp(SR)
    paths = [str(tmp_path / "a.wav"), str(tmp_path / "b.flac"), str(tmp_path / "c.mp3"),
             str(tmp_path / "d.ogg"), str(tmp_path / "missing.flac"),
             str(tmp_path / "junk.flac")]
    wavio.write_wav(paths[0], x, SR)
    for p in paths[2:4]:
        wavio.encode_audio(p, x, SR)
    # the WAV's samples n / 32768 as a FLAC: encoded from n / 32767 (flac_copy)
    wavio.encode_audio(paths[1], wavio.read_wav(paths[0])[0] * np.float32(32768 / 32767), SR)
    with open(paths[5], "wb") as f:
        f.write(b"fLaC" + bytes(range(256)) * 8)
    for n_threads in (1, 4):
        ours = wavio.decode_batch(paths, 16000, 16000, n_threads=n_threads)
        ref = jwavio.decode_batch(paths, 16000, 16000, n_threads=n_threads)
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a, b)
    waves, lengths, ok = ours
    assert list(ok) == [True, True, True, True, False, False]
    assert lengths[0] == lengths[1] > 0
    np.testing.assert_array_equal(waves[0], waves[1])  # the same samples, either format
    assert wavio.load_audio(paths[5]) is None


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """A synthetic corpus and its FLAC copy through the port's pipeline, and
    the FLAC copy through JAX's: tiny weights, fidelity, one batcher."""
    root = tmp_path_factory.mktemp("corpora")
    make_synthetic_corpus(str(root / "wav_corpus"),
                          n_per_split={"train": 6, "test": 3, "devel": 3},
                          duration_range=(0.3, 1.8))
    flac_copy(str(root / "wav_corpus"), str(root / "flac_corpus"))
    cfg = WavLMConfig.tiny()
    params = init_wavlm_params(jax.random.key(0), JaxConfig.tiny())
    model = WavLMModel(cfg)
    model.load_state_dict(wavlm_params_from_numpy(jax.tree.map(np.asarray, params), cfg))
    kw = dict(buckets_s=(1.0, 2.0), audio_budget_s=8.0)
    ex = WavLMExtractor(model, "cpu", preset="fidelity")
    for name in ("wav", "flac"):
        ExtractionPipeline(ex, batcher=BucketBatcher(frame_align=ex.frame_align, **kw)).run(
            create_metadata_from_files(str(root / f"{name}_corpus")), str(root / f"port_{name}"))
    jax_ex = JaxExtractor(JaxConfig.tiny(), params, preset="fidelity")
    JaxPipeline(jax_ex, batcher=JaxBatcher(frame_align=jax_ex.frame_align, **kw)).run(
        jax_scan(str(root / "flac_corpus")), str(root / "jax_flac"))
    return root, ex.column_names


@pytest.mark.parametrize("split", ["train", "test", "devel"])
def test_flac_corpus_rows_equal_the_wav_corpus_and_jax(stores, split):
    root, columns = stores
    flac_meta = (root / "port_flac" / split / "embedding_metadata.csv").read_text()
    assert ".flac" in flac_meta and flac_meta.count("\n") > 1
    # the FLAC store lists the same clips as the WAV store, in the same order
    assert flac_meta.replace("flac_corpus", "wav_corpus").replace(".flac", ".wav") == \
        (root / "port_wav" / split / "embedding_metadata.csv").read_text()
    assert flac_meta == (root / "jax_flac" / split / "embedding_metadata.csv").read_text()
    for col in columns:
        name = f"{col}_embeddings.npy"
        ours = np.load(root / "port_flac" / split / name)
        np.testing.assert_array_equal(ours, np.load(root / "port_wav" / split / name))
        ref = np.load(root / "jax_flac" / split / name)
        assert ours.shape == ref.shape and len(ours) > 0
        for a, b in zip(ours, ref):
            assert cosine_distance(a, b) <= PORT_VS_JAX_COSINE
