"""stutter_tpu_torch's host side and extraction pipeline against the JAX package.

Decode, bucket geometry, the .npy+CSV store, checkpoints and resume, the CLI,
and the rule that the port imports neither jax nor pandas.
"""

import os
import struct
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from stutter_tpu.audio import wavio as jwavio
from stutter_tpu.audio.synthetic import make_synthetic_corpus
from stutter_tpu.extract import (
    BucketBatcher as JaxBatcher,
    ExtractionPipeline as JaxPipeline,
    WavLMExtractor as JaxExtractor,
    create_metadata_from_files as jax_scan,
    find_latest_checkpoint,
    load_checkpoint,
)
from stutter_tpu.models import WavLMConfig as JaxConfig, init_wavlm_params
from stutter_tpu_torch.audio import wavio
from stutter_tpu_torch.cli import extract_wavlm as cli
from stutter_tpu_torch.cli import profile_wavlm as profile_cli
from stutter_tpu_torch.extract.batcher import BucketBatcher
from stutter_tpu_torch.extract.pipeline import ExtractionPipeline, WavLMExtractor
from stutter_tpu_torch.extract.scanner import create_metadata_from_files
from stutter_tpu_torch.models.wavlm import WavLMConfig, WavLMModel
from stutter_tpu_torch.weights.convert import wavlm_params_from_numpy
from tests.conftest import cosine_distance

torch.set_num_threads(2)  # six xdist workers share the host

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _riff(path, fmt_tag, channels, bits, rate, payload, extensible=False):
    block = channels * bits // 8
    if extensible:
        fmt = struct.pack("<HHIIHH", 0xFFFE, channels, rate, rate * block, block, bits)
        fmt += struct.pack("<HHI", 22, bits, 0) + struct.pack("<H", fmt_tag) + b"\x00" * 14
    else:
        fmt = struct.pack("<HHIIHH", fmt_tag, channels, rate, rate * block, block, bits)
    junk = b"LIST" + struct.pack("<I", 3) + b"abc\x00"  # odd-sized chunk + pad byte
    body = (b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt + junk
            + b"data" + struct.pack("<I", len(payload)) + payload)
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(body)) + body)


def _payload(fmt, x):
    if fmt == "pcm8":
        return 1, 8, (np.clip(x * 127 + 128, 0, 255)).astype(np.uint8).tobytes()
    if fmt == "pcm16":
        return 1, 16, (x * 32767).astype("<i2").tobytes()
    if fmt == "pcm24":
        v = (x * 8388607).astype(np.int32)
        return 1, 24, b"".join(int(s).to_bytes(3, "little", signed=True) for s in v)
    if fmt == "pcm32":
        return 1, 32, (x * 2147483000).astype("<i4").tobytes()
    if fmt == "float32":
        return 3, 32, x.astype("<f4").tobytes()
    return 3, 64, x.astype("<f8").tobytes()


@pytest.mark.parametrize("fmt", ["pcm8", "pcm16", "pcm24", "pcm32", "float32", "float64"])
@pytest.mark.parametrize("channels", [1, 2])
def test_read_wav_matches_jax(tmp_path, rng, fmt, channels):
    x = np.clip(rng.randn(301 * channels) * 0.3, -1, 1)
    tag, bits, payload = _payload(fmt, x)
    path = str(tmp_path / f"{fmt}.wav")
    _riff(path, tag, channels, bits, 22050, payload, extensible=channels == 2)
    ours, sr = wavio.read_wav(path)  # the native parser in both packages
    ref, ref_sr = jwavio.read_wav(path)
    assert sr == ref_sr == 22050 and ours.dtype == np.float32
    np.testing.assert_array_equal(ours, ref)
    # the numpy parsers alike; the native stereo mixdown rounds once, in double
    plain = wavio.read_wav_plain(path)[0]
    np.testing.assert_array_equal(plain, jwavio._read_wav_numpy(path)[0])
    np.testing.assert_allclose(ours, plain, atol=1e-6)
    assert wavio.wav_info(path) == jwavio.wav_info(path) == (301, 22050)


def test_write_wav_and_load_audio(tmp_path, rng):
    x = np.clip(rng.randn(1000) * 0.3, -1, 1).astype(np.float32)
    path = str(tmp_path / "a.wav")
    wavio.write_wav(path, x, 16000)
    with open(path, "rb") as f:
        ours = f.read()
    jwavio.write_wav(str(tmp_path / "b.wav"), x, 16000)
    with open(tmp_path / "b.wav", "rb") as f:
        assert ours == f.read()
    np.testing.assert_array_equal(wavio.load_audio(path, max_length=0.05),
                                  jwavio.load_audio(path, max_length=0.05))
    (tmp_path / "bad.wav").write_bytes(b"not audio")
    assert wavio.load_audio(str(tmp_path / "bad.wav")) is None
    np.testing.assert_allclose(wavio.load_audio(path, target_sr=8000),
                               jwavio.load_audio(path, target_sr=8000), atol=1e-5)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(frame_align=(400, 320, 16)),
    dict(audio_budget_s=240.0, max_batch=128, frame_align=(400, 320, 16)),
    dict(audio_budget_s=8.0, max_length_s=6.0),
])
def test_batcher_geometry_matches_jax(tmp_path, kw):
    ours, ref = BucketBatcher(**kw), JaxBatcher(**kw)
    assert ours.buckets_s == ref.buckets_s
    for b in ours.buckets_s:
        assert ours.bucket_samples(b) == ref.bucket_samples(b)
        assert ours.batch_size_for(b) == ref.batch_size_for(b)
    paths = []
    for i, n in enumerate([100, 16000, 16001, 47000, 48000, 500_000]):
        paths.append(str(tmp_path / f"c{i}.wav"))
        wavio.write_wav(paths[-1], np.zeros(n, np.float32), 16000)
    assert ours.assign_buckets(paths) == ref.assign_buckets(paths)


def test_bucket_geometry_of_the_main_path():
    b = BucketBatcher(frame_align=(400, 320, 16))
    assert b.bucket_samples(3.0) == 51_280
    cfg = WavLMConfig.large()
    assert cfg.stem_geometry == (400, 320)
    from stutter_tpu_torch.models.wavlm import wavlm_feature_lengths
    assert wavlm_feature_lengths(cfg, 51_280) == 160
    assert wavlm_feature_lengths(cfg, b.bucket_samples(30.0)) == 1504


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("corpus"))
    # sized in FRAMES for the tiny 20x stem (0.3-1.8 s -> L <= 1440)
    make_synthetic_corpus(root, n_per_split={"train": 8, "test": 4, "devel": 4},
                          duration_range=(0.3, 1.8))
    return root


def test_scanner_matches_jax(corpus):
    ours = create_metadata_from_files(corpus, "all")
    ref = jax_scan(corpus, "all")
    assert [r["path"] for r in ours] == list(ref["path"])
    for row, (_, r) in zip(ours, ref.iterrows()):
        for col in ("filename", "label", "split"):
            assert row[col] == r[col]
    assert len(create_metadata_from_files(corpus, "test")) == 4


@pytest.fixture(scope="module")
def both_runs(corpus, tmp_path_factory):
    """The JAX and the port pipelines on one corpus, tiny weights, fidelity."""
    cfg = WavLMConfig.tiny()
    params = init_wavlm_params(jax.random.key(0), JaxConfig.tiny())
    model = WavLMModel(cfg)
    model.load_state_dict(wavlm_params_from_numpy(jax.tree.map(np.asarray, params), cfg))
    out = tmp_path_factory.mktemp("stores")
    kw = dict(buckets_s=(1.0, 2.0), audio_budget_s=8.0)

    jax_ex = JaxExtractor(JaxConfig.tiny(), params, preset="fidelity")
    JaxPipeline(jax_ex, batcher=JaxBatcher(frame_align=jax_ex.frame_align, **kw),
                checkpoint_interval=3).run(jax_scan(corpus), str(out / "jax"))
    ex = WavLMExtractor(model, "cpu", preset="fidelity")
    ExtractionPipeline(ex, batcher=BucketBatcher(frame_align=ex.frame_align, **kw),
                       checkpoint_interval=3).run(create_metadata_from_files(corpus),
                                                  str(out / "port"))
    return cfg, ex, kw, str(out / "jax"), str(out / "port")


@pytest.mark.parametrize("split", ["train", "test", "devel"])
def test_store_matches_jax(both_runs, split):
    cfg, ex, _, jax_out, port_out = both_runs
    with open(os.path.join(jax_out, split, "embedding_metadata.csv"), "rb") as f:
        ref_csv = f.read()
    with open(os.path.join(port_out, split, "embedding_metadata.csv"), "rb") as f:
        assert f.read() == ref_csv
    assert sorted(os.listdir(os.path.join(port_out, split))) == \
        sorted(os.listdir(os.path.join(jax_out, split)))
    for col in ex.column_names:
        ours = np.load(os.path.join(port_out, split, f"{col}_embeddings.npy"))
        ref = np.load(os.path.join(jax_out, split, f"{col}_embeddings.npy"))
        assert ours.shape == ref.shape and ours.shape[1] == cfg.hidden_size
        assert ours.dtype == ref.dtype == np.float32
        for a, b in zip(ours, ref):
            assert cosine_distance(a, b) <= 1e-6


def test_jax_reads_port_checkpoints(both_runs):
    _, ex, _, jax_out, port_out = both_runs
    n = find_latest_checkpoint(port_out, "train")
    assert n is not None and n == find_latest_checkpoint(jax_out, "train")
    ours, ref = load_checkpoint(port_out, "train", n), load_checkpoint(jax_out, "train", n)
    assert 0 < len(ours) == len(ref)
    assert [list(r) for r in ours] == [list(r) for r in ref]
    assert {r["path"] for r in ours} == {r["path"] for r in ref}
    assert all(r[c].dtype == np.float32 for r in ours for c in ex.column_names)


def test_resume_skips_rows_already_done(both_runs, corpus, tmp_path):
    _, ex, kw, _, port_out = both_runs
    out = str(tmp_path / "resumed")
    os.makedirs(os.path.join(out, "checkpoints"))
    n = find_latest_checkpoint(port_out, "train")
    ckpt = os.path.join("checkpoints", f"checkpoint_train_{n}.pkl")
    with open(os.path.join(port_out, ckpt), "rb") as src, \
            open(os.path.join(out, ckpt), "wb") as dst:
        dst.write(src.read())
    submitted = []
    real_submit = ex.submit
    ex.submit = lambda batch: submitted.extend(batch.paths) or real_submit(batch)
    try:
        ExtractionPipeline(ex, batcher=BucketBatcher(frame_align=ex.frame_align, **kw),
                           checkpoint_interval=3).run(create_metadata_from_files(corpus),
                                                      out, splits=["train"], resume=True)
    finally:
        del ex.submit
    done = {r["path"] for r in load_checkpoint(out, "train", n)}
    assert len(submitted) == 8 - len(done) > 0 and not done & set(submitted)
    name = "embedding_metadata.csv"
    with open(os.path.join(out, "train", name), "rb") as a, \
            open(os.path.join(port_out, "train", name), "rb") as b:
        assert a.read() == b.read()
    for col in ex.column_names:  # re-batched rows may differ in the last bits
        np.testing.assert_allclose(
            np.load(os.path.join(out, "train", f"{col}_embeddings.npy")),
            np.load(os.path.join(port_out, "train", f"{col}_embeddings.npy")), atol=1e-5)


def test_cli_random_init_on_cpu(tmp_path):
    root = str(tmp_path / "corpus")
    make_synthetic_corpus(root, n_per_split={"train": 2, "test": 1, "devel": 1},
                          duration_range=(0.3, 0.6), seed=1)
    out = str(tmp_path / "out")
    rc = cli.main(["--data_dir", root, "--output_dir", out, "--random_init",
                   "--model_name", "microsoft/wavlm-base", "--device", "cpu",
                   "--preset", "fidelity", "--audio_budget", "2", "--batch_size", "2"])
    assert rc == 0
    for split, n in (("train", 2), ("test", 1), ("devel", 1)):
        for layer in (12, 11, 10, 6):
            arr = np.load(os.path.join(out, split, f"layer_{layer}_embeddings.npy"))
            assert arr.shape == (n, 768) and np.isfinite(arr).all()


@pytest.mark.parametrize("extra", [[], ["--random_init", "--long_files", "chunk"],
                                   ["--random_init", "--devices", "2", "--tp", "3"],
                                   ["--random_init", "--verify_model"]])
def test_cli_refuses_what_is_not_ported(tmp_path, monkeypatch, caplog, extra):
    """A layout of the multi-device flags that does not divide raises. What
    used to raise now runs: a hub name raises OSError naming a local
    checkpoint directory (no download), --long_files chunk writes the long
    rows, --verify_model logs and runs (--devices 2 runs in
    tests/test_torch_parallel.py)."""
    out = str(tmp_path / "o")
    if "--devices" in extra:
        with pytest.raises(ValueError, match="mesh"):
            cli.main(["--data_dir", str(tmp_path), "--output_dir", out, *extra])
        return
    if not extra:
        with pytest.raises(OSError, match="local checkpoint directory"):
            cli.main(["--data_dir", str(tmp_path), "--output_dir", out, "--device", "cpu"])
        return
    # --verify_model holds a "base" name to hidden size 768
    dim = 768 if "--verify_model" in extra else 32
    monkeypatch.setattr(WavLMConfig, "base", staticmethod(lambda: WavLMConfig.tiny(dim, 2, 4)))
    root = tmp_path / "corpus"
    make_synthetic_corpus(str(root), n_per_split={"train": 2}, duration_range=(0.3, 0.6), seed=2)
    x = (np.random.RandomState(5).randn(int(2.3 * 16000)) * 0.1).astype(np.float32)
    wavio.write_wav(str(root / "wav" / "train_long.wav"), x, 16000)  # 3 chunks of 1 s
    with caplog.at_level("INFO"):
        rc = cli.main(["--data_dir", str(root), "--output_dir", out, *extra,
                       "--model_name", "microsoft/wavlm-base", "--device", "cpu",
                       "--preset", "fidelity", "--max_length", "1.0", "--split", "train",
                       "--audio_budget", "4", "--batch_size", "4"])
    assert rc == 0
    with open(os.path.join(out, "train", "embedding_metadata.csv")) as f:
        lines = f.read().splitlines()
    assert len(lines) == 4 and np.load(os.path.join(out, "train", "layer_2_embeddings.npy")
                                       ).shape == (3, dim)
    if "chunk" in extra:  # the long row carries its chunk count; the others none
        assert lines[0].split(",")[-1] == "chunks"
        assert sorted(line.split(",")[-1] for line in lines[1:]) == ["", "", "3.0"]
    else:
        assert "chunks" not in lines[0]
        assert any("WavLM verified: 3 hidden states of [1, " in r.message
                   for r in caplog.records)


@pytest.mark.parametrize("entry", ["extract_wavlm", "profile_wavlm"])
def test_cuda_entry_points_raise_without_card(monkeypatch, tmp_path, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = {"extract_wavlm": ["--data_dir", str(tmp_path), "--output_dir",
                              str(tmp_path / "o"), "--random_init"],
            "profile_wavlm": []}[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        (cli if entry == "extract_wavlm" else profile_cli).main(argv)


def test_port_imports_neither_jax_nor_pandas():
    code = (
        "import sys\n"
        "import stutter_tpu_torch, stutter_tpu_torch.extract.pipeline\n"
        "import stutter_tpu_torch.cli.extract_wavlm, stutter_tpu_torch.cli.profile_wavlm\n"
        "import stutter_tpu_torch.cli.extract_whisper, stutter_tpu_torch.cli.profile_whisper\n"
        "import stutter_tpu_torch.frontend.whisper_frontend, stutter_tpu_torch.models.whisper\n"
        "import stutter_tpu_torch.ops.logmel, stutter_tpu_torch.ops.flash_mha\n"
        "import stutter_tpu_torch.ops.mel, stutter_tpu_torch.weights.convert\n"
        "import stutter_tpu_torch.cli.finetune, stutter_tpu_torch.ops.specaugment\n"
        "import stutter_tpu_torch.train.checkpointing, stutter_tpu_torch.train.class_weights\n"
        "import stutter_tpu_torch.train.data, stutter_tpu_torch.train.finetune\n"
        "import stutter_tpu_torch.train.heads, stutter_tpu_torch.train.metrics\n"
        "import stutter_tpu_torch.train.optim, stutter_tpu_torch.train.persistence\n"
        "import stutter_tpu_torch.ops.quant, stutter_tpu_torch.ops.wavlm_stem\n"
        "import stutter_tpu_torch.ops.attn_probes\n"
        "import stutter_tpu_torch.cli.attn_int8_probe, stutter_tpu_torch.cli._attn_probe\n"
        "import stutter_tpu_torch.cli.attn_softmax_variants_probe\n"
        "import stutter_tpu_torch.cli.common, stutter_tpu_torch.models.verify\n"
        "import stutter_tpu_torch.serve.server, stutter_tpu_torch.serve.classify\n"
        "import stutter_tpu_torch.serve.combined, stutter_tpu_torch.serve.http\n"
        "import stutter_tpu_torch.cli.serve, stutter_tpu_torch.cli.predict\n"
        "import stutter_tpu_torch.cli.train, stutter_tpu_torch.cli.train_grid\n"
        "import stutter_tpu_torch.parallel.mesh, stutter_tpu_torch.parallel.sharding\n"
        "import stutter_tpu_torch.parallel.collectives, stutter_tpu_torch.parallel.dryrun\n"
        "import stutter_tpu_torch.audio.build, stutter_tpu_torch.audio.synthetic\n"
        "forbidden = ('jax', 'pandas', 'optax', 'orbax', 'joblib', 'stutter_tpu', 'sklearn',\n"
        "             'transformers', 'safetensors')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in forbidden]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
